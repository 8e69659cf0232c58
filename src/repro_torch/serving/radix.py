"""Prefix-sharing radix cache over the int8 page pool.

The port's own copy of `repro.serving.radix` (host logic over the pool's
refcounts, numpy only; the port imports nothing of the reference package).

A radix tree over prompt token IDs, one edge per FULL page of tokens, whose
nodes resolve to refcounted pages in the `PagePool`.  The WAGEUBN memory
model makes this exact where fp caches cannot be: a page's KV payload is
int8 on a fixed pow2 grid and — under the CHUNKED prefill path, where the
page is the quantization unit — a bitwise-deterministic function of the
token prefix that produced it.  Two prompts sharing a page-aligned prefix
therefore produce byte-identical pages, so a cache hit is provably
identical to recompute (DESIGN.md §10).

Contract:
  * key       — page-granular token IDs.  A cache belongs to one engine,
                so one quantizer config and page geometry.
  * lookup    — longest cached prefix in FULL pages; always leaves at
                least the last prompt token uncached so the engine has
                logits to sample the first token from.  Returns the page
                ids plus the deepest hit node's dense-state snapshot: a
                paged family with recurrent state (the hybrid: its Mamba2
                conv windows and SSD states at the page boundary, a pure
                function of the token prefix like the page itself) seeds
                the lane's mid-prefill state from it; a pure-attention
                family stores None.
  * insert    — publishes a finished prefill's full prompt pages (and
                the dense snapshot after each, where the family has one).
                The tree takes one pool ref per published page (copy-on-write
                discipline: shared pages are read-only by construction —
                decode and suffix prefill both write at positions past the
                shared prefix).  If a concurrent identical prefill already
                published a page, the caller's duplicate is reported back
                for dedup (swap tables to the cached page, drop the
                private copy).
  * eviction  — LRU over zero-refcount subtrees: a node is evictable when
                only the tree holds its page (pool refcount == 1), and
                because any request referencing a descendant also refs
                every ancestor, evictable nodes always form whole
                subtrees.  Eviction unrefs leaves inward.
  * defrag    — `remap()` rewrites node page ids against the pool's
                defrag mapping; each shared page moves exactly once.
"""
from __future__ import annotations

import numpy as np

from .pool import PagePool


class _Node:
    __slots__ = ("key", "page", "dense", "children", "parent", "last_use")

    def __init__(self, key, page, dense, parent):
        self.key = key                  # bytes of this edge's page tokens
        self.page = page                # physical pool page id
        self.dense = dense              # state snapshot after this page
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.last_use = 0


class RadixCache:
    """Page-granular prefix cache over a `PagePool` (see module docstring):
    `pool` is the PagePool whose pages the tree references; `store_dense`
    keeps a dense-state snapshot per node (a paged family with recurrent
    state), else nodes hold None."""

    def __init__(self, pool: PagePool, store_dense: bool = False):
        self.pool = pool
        self.store_dense = store_dense
        self.page_size = pool.page_size
        self.root = _Node(b"", 0, None, None)   # sentinel, never evicted
        self._tick = 0
        # accounting
        self.hit_pages = 0
        self.lookup_pages = 0
        self.lookups = 0
        self.inserted_pages = 0
        self.deduped_pages = 0
        self.evicted_pages = 0

    # ---- keys ------------------------------------------------------------

    def _page_keys(self, prompt) -> list[bytes]:
        """One bytes key per FULL page of the prompt."""
        p = self.page_size
        arr = np.asarray(prompt, np.int32)
        return [arr[i * p:(i + 1) * p].tobytes()
                for i in range(len(arr) // p)]

    def _match_limit(self, prompt) -> int:
        """Max pages a lookup may reuse: every full page, except the last
        one when the prompt is page-aligned — the engine must recompute at
        least the final prompt token to have logits for the first sample."""
        nb_full = len(prompt) // self.page_size
        if nb_full and len(prompt) % self.page_size == 0:
            return nb_full - 1
        return nb_full

    # ---- queries ---------------------------------------------------------

    def match_pages(self, prompt) -> int:
        """Longest cached prefix in pages — side-effect free (admission
        capacity probe; `lookup` is the consuming call)."""
        node, n = self.root, 0
        for key in self._page_keys(prompt)[: self._match_limit(prompt)]:
            node = node.children.get(key)
            if node is None:
                break
            n += 1
        return n

    def lookup(self, prompt) -> tuple[list[int], object | None]:
        """Longest cached prefix: ([page ids], the deepest hit node's dense
        snapshot or None).  Touches the path for LRU; the CALLER takes the
        pool refs (one per returned page) when it commits to the hit."""
        self._tick += 1
        self.lookups += 1
        limit = self._match_limit(prompt)
        self.lookup_pages += len(prompt) // self.page_size
        node, pids = self.root, []
        for key in self._page_keys(prompt)[:limit]:
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._tick
            pids.append(child.page)
            node = child
        self.hit_pages += len(pids)
        return pids, (node.dense if node is not self.root else None)

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt pages served from the tree."""
        return self.hit_pages / self.lookup_pages if self.lookup_pages else 0.0

    # ---- publish ---------------------------------------------------------

    def insert(self, prompt, page_ids, dense_snaps=None) -> dict[int, int]:
        """Publish a finished prefill's full prompt pages.

        Args:
          prompt: the request's token ids; page_ids: its page table
            (page_ids[i] holds page i's KV); dense_snaps: the dense state
            after each full page (index-aligned with them) or None.

        Returns {block index: existing page id} for blocks where the tree
        ALREADY held an identical page (a concurrent duplicate prefill):
        the caller should swap its table to the cached page, take a ref on
        it, and unref its private copy — byte-identical by the chunked
        determinism contract, so the swap is invisible to the request.
        """
        self._tick += 1
        node, dedup = self.root, {}
        for i, key in enumerate(self._page_keys(prompt)):
            child = node.children.get(key)
            if child is None:
                snap = (dense_snaps[i] if self.store_dense and dense_snaps
                        else None)
                child = _Node(key, page_ids[i], snap, node)
                self.pool.ref(page_ids[i])          # the tree's own hold
                node.children[key] = child
                self.inserted_pages += 1
            elif child.page != page_ids[i]:
                dedup[i] = child.page               # duplicate: reuse cached
                self.deduped_pages += 1
            child.last_use = self._tick
            node = child
        return dedup

    # ---- eviction --------------------------------------------------------

    def _evictable_leaves(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n is not self.root and not n.children
                    and self.pool.refcount(n.page) == 1):
                out.append(n)
        return out

    def evictable(self) -> int:
        """Pages reclaimable by eviction right now: nodes only the tree
        holds.  (Request-referenced subtrees pin their ancestors, so the
        refcount==1 set IS the union of evictable subtrees.)"""
        stack, n = [self.root], 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root and self.pool.refcount(node.page) == 1:
                n += 1
        return n

    def evict(self, n_pages: int) -> int:
        """Free up to n_pages via LRU over evictable leaves (leaves-inward
        so parents become evictable as their subtrees drain).  Returns the
        number of pages actually returned to the pool."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.last_use, n.page))
            self.pool.unref(victim.page)
            del victim.parent.children[victim.key]
            self.evicted_pages += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every tree-only hold (testing / shutdown)."""
        return self.evict(self.pool.n_pages)

    # ---- maintenance -----------------------------------------------------

    def remap(self, mapping: dict[int, int]) -> None:
        """Rewrite node page ids after a pool defrag (old -> new)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root:
                node.page = mapping.get(node.page, node.page)

    @property
    def n_nodes(self) -> int:
        stack, n = [self.root], 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            n += 1
        return n - 1                                # minus the root sentinel

    def stats(self) -> dict:
        return {
            "nodes": self.n_nodes, "evictable": self.evictable(),
            "lookups": self.lookups, "hit_pages": self.hit_pages,
            "lookup_pages": self.lookup_pages, "hit_rate": self.hit_rate,
            "inserted_pages": self.inserted_pages,
            "deduped_pages": self.deduped_pages,
            "evicted_pages": self.evicted_pages,
        }
