"""Paged int8 KV-cache pool: fixed-size int8 pages + pow2 scales.

Port of `repro.serving.pool.PagePool`.  All resident KV state is int8
payload on a power-of-two grid, cut into fixed-size pages so lanes with
different context lengths share one physical arena.  One logical page owns
that block's storage across ALL layers: the device arrays are
(L, P, page, KV, dh) and a layer's slice is (P, page, KV, dh).

Page id 0 is the trash page: dead lanes' page tables point at it, their
decode writes collide there, and the attention mask never reads it for a
live lane.  The allocator hands out ids 1..P-1.

Pages are REFCOUNTED so the radix prefix cache (radix.py) can share one
physical page between the tree and any number of live requests: `alloc`
hands a page out with refcount 1, `ref`/`unref` adjust it, and the page
returns to the free list only when the count reaches zero.  The strict
`free` refuses shared pages.  `defrag` compacts the live pages to the
lowest ids (one index per arena moves the payloads) and returns the
mapping every holder rewrites against.

Unlike the reference, whose jitted steps return new page arrays, the port
updates `k` and `v` IN PLACE (the model writes a page or a token slot into
the arena directly), which saves a copy of the arena per step.
"""
from __future__ import annotations

import torch


class PagePool:
    """Physical page arena + free-list allocator + accounting."""

    def __init__(self, n_pages: int, page_size: int, kv_layers: int,
                 n_kv: int, dh: int, scale: float = 2.0 ** -7,
                 device="cuda"):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.kv_layers, self.n_kv, self.dh = kv_layers, n_kv, dh
        shape = (kv_layers, n_pages, page_size, n_kv, dh)
        self.k = torch.zeros(shape, dtype=torch.int8, device=device)
        self.v = torch.zeros(shape, dtype=torch.int8, device=device)
        self.k_scale = torch.full((kv_layers,), scale, dtype=torch.float32,
                                  device=device)
        self.v_scale = self.k_scale.clone()
        # free list (LIFO for reuse locality); id 0 reserved as trash
        self._free = list(range(n_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}      # live page -> refcount (>= 1)
        self.allocs = 0
        self.frees = 0
        self.failed_allocs = 0
        self.peak_in_use = 0
        self.defrag_moves = 0

    # ---- allocator -------------------------------------------------------

    @property
    def usable(self) -> int:
        return self.n_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - self.free_count

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> list[int] | None:
        """Pop n pages off the free list, or None (no partial allocation).
        Each page comes out with refcount 1 (the allocating holder)."""
        if n > self.free_count:
            self.failed_allocs += 1
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    # ---- refcounts (shared prefix pages) ---------------------------------

    def refcount(self, pid: int) -> int:
        """Total holders of a live page (0 for free pages / the trash)."""
        return self._refs.get(pid, 0)

    def ref(self, pid: int) -> None:
        """Add a holder to an allocated page (radix hit / tree publish)."""
        if pid not in self._refs:
            raise ValueError(f"ref of unallocated page {pid}")
        self._refs[pid] += 1

    def unref(self, pid: int) -> bool:
        """Drop one holder; the page frees when the count reaches zero.
        Returns True iff this call returned the page to the free list."""
        if pid not in self._refs:
            raise ValueError(f"unref of unallocated page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] > 0:
            return False
        del self._refs[pid]
        self._free.append(pid)
        self.frees += 1
        return True

    def free(self, ids) -> None:
        """Strict release: every page must be exclusively held (refcount
        1).  Shared pages must be `unref`ed by each holder instead."""
        for pid in ids:
            if pid == 0 or pid in self._free:
                raise ValueError(f"double free / trash free of page {pid}")
            if self._refs.get(pid, 1) > 1:
                raise ValueError(
                    f"free of shared page {pid} "
                    f"({self._refs[pid] - 1} outstanding refs); use unref")
            self._refs.pop(pid, None)
            self._free.append(pid)
        self.frees += len(ids)

    # ---- defrag ----------------------------------------------------------

    def defrag(self) -> dict[int, int]:
        """Compact live pages to the lowest physical ids.

        Payloads move with one index per arena; a shared page moves exactly
        once, and every holder (lane tables, request page lists, radix
        nodes) rewrites against the one mapping entry.  Returns the old ->
        new id mapping (identity entries omitted)."""
        live = sorted(self._refs)
        mapping = {old: new for new, old in enumerate(live, start=1)
                   if old != new}
        if mapping:
            src = torch.arange(self.n_pages)
            for old, new in mapping.items():
                src[new] = old
            src = src.to(self.k.device)
            self.k = torch.index_select(self.k, 1, src)
            self.v = torch.index_select(self.v, 1, src)
            self._refs = {mapping.get(p, p): c
                          for p, c in self._refs.items()}
            self._free = list(range(self.n_pages - 1, len(live), -1))
            self.defrag_moves += len(mapping)
        return mapping

    # ---- views and accounting --------------------------------------------

    def view(self, table: torch.Tensor) -> dict:
        """The pool view the model's paged steps take."""
        return {"k_pages": self.k, "v_pages": self.v,
                "k_scale": self.k_scale, "v_scale": self.v_scale,
                "table": table}

    def report(self, ctx_len: int | None = None) -> dict:
        """Occupancy and the int8 footprint beside the fp32 cache the same
        geometry would need; with `ctx_len`, how many sequences of that
        length the pool's bytes hold as int8 and as fp32."""
        page_elems = self.kv_layers * self.page_size * self.n_kv * self.dh
        int8_bytes = 2 * self.n_pages * page_elems          # k + v
        scale_bytes = 2 * self.kv_layers * 4
        fp32_bytes = 4 * int8_bytes
        rep = {"n_pages": self.n_pages, "page_size": self.page_size,
               "in_use": self.in_use, "free": self.free_count,
               "shared_pages": sum(c > 1 for c in self._refs.values()),
               "peak_in_use": self.peak_in_use, "allocs": self.allocs,
               "frees": self.frees, "failed_allocs": self.failed_allocs,
               "defrag_moves": self.defrag_moves,
               "pool_bytes_int8": int8_bytes + scale_bytes,
               "pool_bytes_fp32_equiv": fp32_bytes,
               "footprint_ratio": fp32_bytes / (int8_bytes + scale_bytes)}
        if ctx_len:
            per_seq = self.pages_for(ctx_len)
            fp32_pages = (int8_bytes + scale_bytes) // (4 * 2 * page_elems)
            rep["capacity_seqs_int8"] = self.usable // per_seq
            rep["capacity_seqs_fp32"] = max(0, fp32_pages - 1) // per_seq
        return rep
