"""The port's prefix-sharing radix cache, pool and scheduler: each case of
tests/test_radix.py (and the pool cases of tests/test_serving.py) run on
`repro_torch.serving` on the CPU, plus the engine with the cache on held
against the reference's engine.

Pool refcount invariants, radix lookup/insert/eviction/dedup semantics,
bounded-skip admission, bitwise cache-on/off exactness (granite-3-8b and
granite-moe-1b-a400m, the paged families the port has; also after
preemption-recompute), and a
refcount + defrag chaos run.  Against the reference (weights carried
across with `params_from_jax`, under `exact_pow2`): the tokens and the
prefix hit rate are EQUAL.
"""
import jax
import numpy as np
import pytest

import repro.serving as jserving
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.core import preset
from repro_torch.models import build_model
from repro_torch.serving import (Engine, PagePool, RadixCache, RequestState,
                                 Scheduler, make_engine,
                                 shared_prefix_traffic)

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401


def _pool(n_pages=17, page_size=4):
    return PagePool(n_pages, page_size, kv_layers=2, n_kv=2, dh=4,
                    device="cpu")


# --------------------------------------------------------------------------
# PagePool refcounts
# --------------------------------------------------------------------------


def test_pool_refcount_lifecycle():
    pool = _pool()
    (pid,) = pool.alloc(1)
    assert pool.refcount(pid) == 1
    pool.ref(pid)
    pool.ref(pid)
    assert pool.refcount(pid) == 3
    with pytest.raises(ValueError, match="shared page"):
        pool.free([pid])                   # strict free refuses shared pages
    assert not pool.unref(pid) and not pool.unref(pid)
    assert pool.refcount(pid) == 1
    assert pool.free_count == pool.usable - 1
    assert pool.unref(pid)                 # last holder frees it
    assert pool.refcount(pid) == 0 and pool.free_count == pool.usable
    with pytest.raises(ValueError):
        pool.unref(pid)                    # already free
    with pytest.raises(ValueError):
        pool.ref(pid)
    with pytest.raises(ValueError):
        pool.ref(0)                        # the trash page is never refable
    b = pool.alloc(2)
    pool.ref(b[0])
    assert pool.report()["shared_pages"] == 1


def test_pool_defrag_remaps_shared_pages_exactly_once():
    pool = _pool(n_pages=9)
    a = pool.alloc(2)
    b = pool.alloc(2)
    c = pool.alloc(2)
    pool.ref(c[0])                         # c[0] shared by two holders
    pool.ref(c[0])
    for pid in a + b + c:
        pool.k[:, pid] = pid
    pool.free(a)
    mapping = pool.defrag()
    # one mapping entry per physical page regardless of holders
    assert len(mapping) == len(set(mapping.values()))
    new_c0 = mapping.get(c[0], c[0])
    assert pool.refcount(new_c0) == 3      # refcounts follow the move
    np.testing.assert_array_equal(pool.k[:, new_c0].numpy(),
                                  np.full((2, 4, 2, 4), c[0], np.int8))
    pool.unref(new_c0)
    pool.unref(new_c0)
    assert pool.refcount(new_c0) == 1
    pool.free([new_c0])                    # exclusive again: strict free ok


# --------------------------------------------------------------------------
# RadixCache
# --------------------------------------------------------------------------


def _publish(cache, pool, prompt):
    """Alloc + insert a prompt's full pages; returns the page ids, with the
    publisher's own holds dropped (tree-only pages, as after release)."""
    nb = len(prompt) // pool.page_size
    pids = pool.alloc(nb)
    cache.insert(prompt, pids)
    for p in pids:
        pool.unref(p)                      # publisher exits; tree ref stays
    return pids


def test_radix_lookup_match_limit_and_hit_accounting():
    pool = _pool(page_size=4)
    cache = RadixCache(pool)
    prompt = np.arange(12, dtype=np.int32)            # 3 full pages
    pids = _publish(cache, pool, prompt)
    assert cache.n_nodes == 3 and pool.in_use == 3
    # aligned identical prompt: the last page stays uncached (the engine
    # must compute the final prompt token to sample from)
    assert cache.match_pages(prompt) == 2
    hit, dense = cache.lookup(prompt)
    assert hit == pids[:2] and dense is None
    # extension past the prefix may reuse every published page
    ext = np.concatenate([prompt, np.int32([99, 98])])
    assert cache.match_pages(ext) == 3
    assert cache.lookup(ext)[0] == pids
    # divergence in page 2 stops the walk
    div = prompt.copy()
    div[5] = 77
    assert cache.match_pages(div) == 1
    assert 0.0 < cache.hit_rate <= 1.0
    # sub-page prompts never match (page-granular keys)
    assert cache.match_pages(np.arange(3, dtype=np.int32)) == 0


def test_radix_insert_dedup_reports_existing_pages():
    pool = _pool(page_size=4)
    cache = RadixCache(pool)
    prompt = np.arange(8, dtype=np.int32)
    first = _publish(cache, pool, prompt)
    dup = pool.alloc(2)       # concurrent identical prefill
    dedup = cache.insert(prompt, dup)
    assert dedup == {0: first[0], 1: first[1]}
    assert cache.deduped_pages == 2
    assert cache.n_nodes == 2              # no duplicate nodes


def test_radix_eviction_lru_and_request_pinning():
    pool = _pool(n_pages=17, page_size=4)
    cache = RadixCache(pool)
    old = _publish(cache, pool, np.arange(0, 8, dtype=np.int32))
    hot = _publish(cache, pool, np.arange(50, 58, dtype=np.int32))
    assert cache.evictable() == 4
    # a request commits to `hot`: its refs pin that chain against eviction
    pids, _ = cache.lookup(np.concatenate(
        [np.arange(50, 58, dtype=np.int32), np.int32([1])]))
    for p in pids:
        pool.ref(p)
    assert pids == hot and cache.evictable() == 2
    assert cache.evict(10) == 2            # only the old chain drains
    assert cache.n_nodes == 2 and pool.in_use == 2
    assert all(pool.refcount(p) == 2 for p in hot)
    for p in pids:                         # request exits; tree-only again
        pool.unref(p)
    assert cache.clear() == 2
    assert pool.in_use == 0 and cache.n_nodes == 0


def test_radix_remap_tracks_pool_defrag():
    pool = _pool(n_pages=17, page_size=4)
    cache = RadixCache(pool)
    gap = pool.alloc(3)
    prompt = np.arange(8, dtype=np.int32)
    _publish(cache, pool, prompt)
    pool.free(gap)                         # holes below the tree's pages
    mapping = pool.defrag()
    assert mapping
    cache.remap(mapping)
    hit, _ = cache.lookup(np.concatenate([prompt, np.int32([5])]))
    assert hit and all(pool.refcount(p) == 1 for p in hit)


# --------------------------------------------------------------------------
# bounded-skip admission
# --------------------------------------------------------------------------


def test_scheduler_bounded_skip_and_starvation_limit():
    pool = _pool(n_pages=9, page_size=4)   # 8 usable pages
    sched = Scheduler(pool, max_skip=4, starvation_limit=3)
    big = sched.submit(np.arange(28), 2, 0.0)      # needs 8 pages
    small = [sched.submit(np.arange(4), 2, 0.0) for _ in range(6)]
    held = pool.alloc(4)        # big can't fit: 4 pages free
    # small requests jump the stuck head, one lane at a time
    for i in range(3):
        wave = sched.admit(1)
        assert [r.rid for r in wave] == [small[i].rid]
        assert big.skipped == i + 1
    # starvation limit reached: the head becomes a barrier
    assert sched.admit(1) == []
    assert big.skipped == 3 and sched.skips == 3
    pool.free(held)                        # capacity appears: head admits
    wave = sched.admit(2)
    assert [r.rid for r in wave] == [big.rid]
    # strict FIFO when max_skip=0
    sched0 = Scheduler(pool, max_skip=0)
    pool2 = pool.alloc(4)
    blocked = sched0.submit(np.arange(28), 2, 0.0)
    sched0.submit(np.arange(4), 2, 0.0)
    assert sched0.admit(2) == [] and blocked.skipped == 0
    pool.free(pool2)


def test_scheduler_preempt_resets_chunked_progress():
    sched = Scheduler()
    req = sched.submit(np.arange(8), 4, 0.0)
    req.state = RequestState.DECODE
    req.generated = [1, 2]
    req.pf_pos, req.n_shared = 8, 1
    sched.preempt(req)
    assert req.pf_pos == 0 and req.n_shared == 0
    assert list(req.prompt) == list(np.arange(8)) + [1, 2]


# --------------------------------------------------------------------------
# chunked prefill + radix cache: bitwise exactness
# --------------------------------------------------------------------------


CHUNKED = dict(max_lanes=1, page_size=4, max_ctx=32, prefill_mode="chunked",
               prefill_chunk=2)


def _chunked(arch, radix, **kw):
    return make_engine(arch, mode="native", device="cpu", radix_cache=radix,
                       **dict(CHUNKED, **kw))


def _serve_sequential(eng, prompts, max_new=5):
    out = []
    for p in prompts:
        rid = eng.submit(p, max_new)
        out.append(eng.drain()[rid])
    return out


SHARED = np.arange(20, 29, dtype=np.int32)           # 2 full pages + tail
PROMPTS = [SHARED,
           np.concatenate([SHARED, np.int32([3, 1, 4])]),
           np.concatenate([SHARED[:8], np.int32([9, 9])]),
           np.arange(40, 48, dtype=np.int32)]        # page-aligned


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m",
                                  "zamba2-7b"])
def test_chunked_radix_cache_bitwise_exact(arch):
    """Acceptance: greedy outputs with the radix cache on are bit-identical
    to cache off, per family — page-scoped quantization makes cached pages
    (and recurrent-state snapshots) exact in their token prefix."""
    on = _serve_sequential(_chunked(arch, radix=True), PROMPTS)
    off = _serve_sequential(_chunked(arch, radix=False), PROMPTS)
    assert on == off, arch
    # and the cache actually served pages (not a trivially-empty tree)


def test_chunked_radix_hits_serve_shared_prefix():
    eng = _chunked("granite-3-8b", radix=True)
    _serve_sequential(eng, PROMPTS)
    m = eng.metrics()
    assert m["radix"]["hit_pages"] > 0
    assert 0.0 < m["prefix_hit_rate"] <= 1.0
    assert m["queue_ms_mean"] >= 0.0 and m["prefill_ms_mean"] > 0.0
    assert eng.pool.in_use == m["radix"]["nodes"]    # only tree holds remain
    assert eng.radix.clear() == m["radix"]["nodes"]
    assert eng.pool.in_use == 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-7b"])
def test_chunked_radix_exact_after_preemption_recompute(arch):
    """Preempt mid-generation in both engines at the same step: the cache-on
    engine re-prefills through radix hits on its own published pages, the
    cache-off engine recomputes everything — tokens must stay identical."""
    outs = {}
    for radix in (True, False):
        eng = _chunked(arch, radix=radix)
        rid = eng.submit(PROMPTS[1], 8)
        for _ in range(3):
            eng.step()
        req = eng.scheduler.requests[rid]
        assert req.state is RequestState.DECODE
        eng._preempt(req)                  # forced recompute preemption
        assert req.preemptions == 1
        outs[radix] = eng.drain()[rid]
        assert len(outs[radix]) == 8
    assert outs[True] == outs[False], arch


def test_chunked_matches_itself_across_budgets():
    """Prefill chunking is pure restructuring: any chunk size / budget
    yields the same tokens (page-scoped numerics don't see the batching)."""
    outs = []
    for chunk, budget in ((1, 4), (2, 8), (3, 64)):
        eng = make_engine("granite-3-8b", mode="native", device="cpu",
                          max_lanes=1, page_size=4, max_ctx=32,
                          prefill_mode="chunked", prefill_chunk=chunk,
                          prefill_budget=budget)
        outs.append(_serve_sequential(eng, PROMPTS[:2]))
    assert outs[0] == outs[1] == outs[2]


def test_chunked_ssm_family_runs_without_pool():
    eng = make_engine("falcon-mamba-7b", mode="native", device="cpu",
                      max_lanes=1, page_size=4, max_ctx=32,
                      prefill_mode="chunked", prefill_chunk=2)
    out = _serve_sequential(eng, PROMPTS[:2])
    assert all(len(g) == 5 for g in out)


def test_radix_cache_flag_validation():
    with pytest.raises(ValueError, match="chunked"):
        make_engine("granite-3-8b", mode="native", device="cpu",
                    radix_cache=True)
    with pytest.raises(ValueError, match="paged"):
        make_engine("falcon-mamba-7b", mode="native", device="cpu",
                    prefill_mode="chunked", radix_cache=True)
    with pytest.raises(ValueError, match="prefill_mode"):
        make_engine("granite-3-8b", mode="native", device="cpu",
                    prefill_mode="bogus")


def test_shared_prefix_traffic_shapes():
    traffic = shared_prefix_traffic(rate=8.0, n_requests=16, sharing=1.0,
                                    prefix_len=8, n_prefixes=1,
                                    tail_lens=(2, 4), gen_lens=(2,), seed=1)
    assert len(traffic) == 16
    heads = {t["prompt"][:8].tobytes() for t in traffic}
    assert len(heads) == 1                 # sharing=1: one common prefix
    assert all(len(t["prompt"]) in (10, 12) for t in traffic)
    mixed = shared_prefix_traffic(rate=8.0, n_requests=16, sharing=0.0,
                                  prefix_len=8, seed=1)
    assert len({t["prompt"][:8].tobytes() for t in mixed}) > 8


# --------------------------------------------------------------------------
# refcount + defrag + eviction chaos
# --------------------------------------------------------------------------


def test_refcount_defrag_eviction_chaos():
    """200 random ops over pool + radix + simulated request holds; after
    every op the refcount ledger must equal tree holds + request holds and
    the free list must stay disjoint from live pages."""
    rng = np.random.default_rng(0)
    pool = _pool(n_pages=33, page_size=4)
    cache = RadixCache(pool)
    requests = {}                          # rid -> page ids it holds
    next_rid = 0

    def tree_holds():
        holds = {}
        stack = [cache.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not cache.root:
                holds[n.page] = holds.get(n.page, 0) + 1
        return holds

    def check():
        th = tree_holds()
        rh = {}
        for pids in requests.values():
            for p in pids:
                rh[p] = rh.get(p, 0) + 1
        live = set(th) | set(rh)
        assert pool.in_use == len(live)
        for p in live:
            assert pool.refcount(p) == th.get(p, 0) + rh.get(p, 0), p
            assert p not in pool._free and p != 0

    def random_prompt():
        nb = int(rng.integers(1, 4))
        return rng.integers(0, 8, size=nb * 4).astype(np.int32)

    for op in rng.integers(0, 5, size=200):
        if op == 0:                        # a request prefills + publishes
            prompt = random_prompt()
            hit, _ = cache.lookup(prompt)
            for p in hit:
                pool.ref(p)
            need = len(prompt) // 4 - len(hit)
            fresh = pool.alloc(need)
            if fresh is None:
                cache.evict(need)
                fresh = pool.alloc(need)
            if fresh is None:              # genuinely full: drop the refs
                for p in hit:
                    pool.unref(p)
            else:
                pids = hit + fresh
                dedup = cache.insert(prompt, pids)
                for blk, cached in dedup.items():
                    pool.ref(cached)
                    pool.unref(pids[blk])
                    pids[blk] = cached
                requests[next_rid] = pids
                next_rid += 1
        elif op == 1 and requests:         # release (finish or preempt)
            rid = int(rng.choice(list(requests)))
            for p in requests.pop(rid):
                pool.unref(p)
        elif op == 2:                      # LRU eviction pressure
            cache.evict(int(rng.integers(1, 4)))
        elif op == 3:                      # defrag + remap every holder
            mapping = pool.defrag()
            cache.remap(mapping)
            for rid, pids in requests.items():
                requests[rid] = [mapping.get(p, p) for p in pids]
        else:                              # probe only
            cache.match_pages(random_prompt())
        check()

    for pids in requests.values():
        for p in pids:
            pool.unref(p)
    cache.clear()
    assert pool.in_use == 0
    assert sorted(pool._free) == list(range(1, pool.n_pages))


# --------------------------------------------------------------------------
# the pool cases of tests/test_serving.py
# --------------------------------------------------------------------------


def test_pool_alloc_free_reuse_invariants():
    pool = _pool(n_pages=9)
    assert pool.usable == 8 and pool.free_count == 8
    a = pool.alloc(3)
    b = pool.alloc(5)
    assert len(a) == 3 and len(b) == 5
    assert 0 not in a + b                       # trash page never handed out
    assert len(set(a + b)) == 8                 # no double allocation
    assert pool.in_use == 8 and pool.free_count == 0
    assert pool.alloc(1) is None                # exhausted: no partial grant
    assert pool.failed_allocs == 1
    pool.free(a)
    assert pool.free_count == 3
    c = pool.alloc(3)
    assert set(c) == set(a)                     # freed pages are reused
    with pytest.raises(ValueError):
        pool.free([b[0], b[0]])                 # double free detected
    assert pool.peak_in_use == 8
    assert pool.allocs == 11 and pool.frees >= 3


def test_pool_pages_for_and_report_ratio():
    pool = _pool(n_pages=17, page_size=4)
    assert pool.pages_for(1) == 1 and pool.pages_for(4) == 1
    assert pool.pages_for(5) == 2
    rep = pool.report(ctx_len=16)
    # int8 payloads + tiny scale overhead vs fp32 of the same geometry
    assert rep["footprint_ratio"] > 3.9
    assert rep["capacity_seqs_int8"] >= 4 * max(1, rep["capacity_seqs_fp32"])
    jrep = jserving.PagePool(17, 4, kv_layers=2, n_kv=2, dh=4).report(
        ctx_len=16)
    assert rep == jrep


def test_pool_defrag_compacts_and_preserves_payloads():
    pool = _pool(n_pages=9, page_size=4)
    a = pool.alloc(2)
    b = pool.alloc(2)
    c = pool.alloc(2)
    for pid in a + b + c:
        pool.k[:, pid] = pid
    pool.free(b)
    mapping = pool.defrag()
    new_a = [mapping.get(p, p) for p in a]
    new_c = [mapping.get(p, p) for p in c]
    assert sorted(new_a + new_c) == [1, 2, 3, 4]   # compacted to the front
    for old, new in zip(a + c, new_a + new_c):
        np.testing.assert_array_equal(pool.k[:, new].numpy(),
                                      np.full((2, 4, 2, 4), old, np.int8))
    assert pool.free_count == 4
    d = pool.alloc(4)
    assert d is not None and len(set(d) & {1, 2, 3, 4}) == 0


# --------------------------------------------------------------------------
# the radix engine against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("radix", [True, False], ids=["cache_on",
                                                      "cache_off"])
def test_radix_engine_tokens_and_hit_rate_equal_reference(radix,
                                                          exact_pow2):
    """The same prompts (a shared page-aligned prefix, its extensions, a
    divergence and a page-aligned prompt) one at a time through both
    engines: equal tokens, equal prefix hit rate and radix stats, and with
    the cache on, the port's own cache-off tokens."""
    jeng = jserving.make_engine("granite-3-8b", mode="native", reduced=True,
                                seed=0, radix_cache=radix, **CHUNKED)
    tm = build_model(get("granite-3-8b").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    eng = Engine(tm, radix_cache=radix, **CHUNKED)
    got = _serve_sequential(eng, PROMPTS)
    assert got == _serve_sequential(jeng, PROMPTS)
    if radix:
        m, jm = eng.metrics(), jeng.metrics()
        assert m["prefix_hit_rate"] == jm["prefix_hit_rate"] > 0
        assert m["radix"] == jm["radix"]
        assert got == _serve_sequential(Engine(tm, **CHUNKED), PROMPTS)


def test_radix_engine_shared_prefix_load_equals_reference(exact_pow2):
    """shared_prefix_traffic on 2 lanes with the cache on and a pool that
    runs short (eviction before preemption), requests submitted up front:
    the reference's tokens and hit rate."""
    kw = dict(CHUNKED, max_lanes=2, n_pages=12)
    traffic = shared_prefix_traffic(rate=8.0, n_requests=8, sharing=0.75,
                                    prefix_len=8, n_prefixes=2,
                                    tail_lens=(2, 5), gen_lens=(3, 6),
                                    seed=5)
    jeng = jserving.make_engine("granite-3-8b", mode="native", reduced=True,
                                seed=0, radix_cache=True, **kw)
    tm = build_model(get("granite-3-8b").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    eng = Engine(tm, radix_cache=True, **kw)
    outs = []
    for e in (eng, jeng):
        rids = [e.submit(r["prompt"], r["max_new"]) for r in traffic]
        res = e.drain()
        outs.append(([res[r] for r in rids], e.metrics()))
    (got, m), (want, jm) = outs
    assert got == want
    assert m["prefix_hit_rate"] == jm["prefix_hit_rate"] > 0
    assert m["radix"]["evicted_pages"] == jm["radix"]["evicted_pages"] > 0
    assert m["preemptions"] == jm["preemptions"]
