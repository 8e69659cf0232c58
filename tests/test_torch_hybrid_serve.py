"""The port's hybrid zamba2-7b served by the engine (repro_torch.serving:
the Mamba2 state in dense per-lane slots, the shared attention's KV in the
page pool, the radix cache's dense snapshots) against the reference
package's engine (repro.serving), on the CPU.

The model is zamba2-7b.reduced() (2 Mamba2 layers, a shared block after
each, d_model 64, 4 query / 2 KV heads of 16, vocab 128) with the
reference engine's weights (its `make_engine(seed=0)`), carried by
`hybrid_params_from_jax`; every test against the reference uses the
`exact_pow2` fixture.  The model's forward is tests/test_torch_hybrid.py.

Tolerances, and why:
- Greedy tokens EQUAL to the reference engine's on monolithic and chunked
  prefill with preemption; the radix cache's tokens, prefix hit rate and
  stats EQUAL.
- Every lane's final slot: conv windows equal, h within 2^-14 of max |h|.
  Dead lanes are included: release never resets a slot, so a dead lane's
  state runs the recurrence through every decode step of the run (some
  40 here), and a head whose decay is near 1 (dt ~ 1e-3) keeps each
  step's rounding difference (XLA's CPU build fuses the state update's
  multiply and add; tests/test_torch_mamba2.py) for some 1000 steps: up to
  2^10 ulps of its largest term.  Measured 2^-16.1 (a dead lane in the
  chunked run), 2^-22 for the live ones.
- A radix hit against recompute, in the port: tokens and every lane's
  final dense slot equal bit for bit (a hit restores the snapshot taken
  after the hit page, a pure function of the token prefix, as the page
  is).
"""
import jax
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro_torch.configs import get
from repro_torch.convert import hybrid_params_from_jax
from repro_torch.core import preset
from repro_torch.kernels import ops
from repro_torch.models import Zamba2, build_model
from repro_torch.serving import Engine, make_engine

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

NAME = "zamba2-7b"
KW = dict(max_lanes=2, page_size=8, max_ctx=32, prefill_chunk=2)
PROMPT_LENS = (8, 13, 21, 16, 5)
NEW = 6


def _serve(engine, prompts, new=NEW):
    rids = [engine.submit(p, new) for p in prompts]
    out = engine.drain()
    return [out[r] for r in rids]


def _prompts(lens=PROMPT_LENS, seed=11):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, n).astype(np.int32) for n in lens]


def _slots_close(got: dict, want: dict):
    """conv windows equal, h within 2^-14 of max |h|."""
    np.testing.assert_array_equal(got["m_conv"].numpy(), want["m_conv"])
    h = want["m_h"]
    assert np.abs(got["m_h"].numpy() - h).max() <= 2.0 ** -14 * np.abs(
        h).max()


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _pair(**kw):
    """The reference engine and the port's Engine on the same weights."""
    jeng = jserving.make_engine(NAME, mode="native", reduced=True, seed=0,
                                **kw)
    tm = build_model(get(NAME).reduced(), preset("full8"), device="cpu")
    tm.load_params(hybrid_params_from_jax(jax.tree.map(np.asarray,
                                                       jeng.params)))
    return jeng, Engine(tm, **kw)


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_engine_tokens_equal_reference_with_preemption(mode, exact_pow2):
    """5 prompts on 2 lanes over a pool of 5 pages (4 usable, as many as
    one max_ctx request needs), so requests are preempted and recomputed,
    and lanes are reused with stale dense state: greedy tokens,
    preemptions and every lane's final slot as the reference engine's."""
    kw = dict(KW, prefill_mode=mode, n_pages=5)
    jeng, eng = _pair(**kw)
    prompts = _prompts()
    want = _serve(jeng, prompts)
    got = _serve(eng, prompts)
    assert got == want
    m, jm = eng.metrics(), jeng.metrics()
    assert m["preemptions"] == jm["preemptions"] > 0
    assert m["completed"] == len(PROMPT_LENS) and not eng._pf_dense
    _slots_close(eng.slots, jax.tree.map(np.asarray, jeng.slots))
    assert eng.pool.in_use == 0


SHARED = np.arange(20, 29, dtype=np.int32)            # 2 full pages + tail
RADIX_PROMPTS = [SHARED, np.concatenate([SHARED, np.int32([3, 1, 4])]),
                 np.concatenate([SHARED[:4], np.int32([9, 9])]),
                 np.arange(40, 48, dtype=np.int32)]     # page-aligned
RADIX_KW = dict(max_lanes=1, page_size=4, max_ctx=32, prefill_mode="chunked",
                prefill_chunk=2)


def _sequential(eng, prompts, new=5):
    out = []
    for p in prompts:
        rid = eng.submit(p, new)
        out.append(eng.drain()[rid])
    return out


def test_radix_hit_equals_recompute_and_reference(exact_pow2):
    """Prompts sharing a page-aligned prefix one at a time, the cache on:
    tokens, hit rate and radix stats equal to the reference engine's; in
    the port, tokens and the lane's final Mamba2 slot equal to the run
    without the cache bit for bit, the hit pages served from the tree and
    each hit seeded from the snapshot after its deepest page."""
    jeng, eng = _pair(radix_cache=True, **RADIX_KW)
    seeds = []
    lookup = eng.radix.lookup

    def spy(prompt):
        pids, dense = lookup(prompt)
        seeds.append((len(pids), dense))
        return pids, dense
    eng.radix.lookup = spy
    got = _sequential(eng, RADIX_PROMPTS)
    assert got == _sequential(jeng, RADIX_PROMPTS)
    m, jm = eng.metrics(), jeng.metrics()
    assert m["prefix_hit_rate"] == jm["prefix_hit_rate"] > 0
    assert m["radix"] == jm["radix"]
    assert eng.radix.store_dense and all(
        (n > 0) == (d is not None) for n, d in seeds) and seeds[1][0] == 2
    off = Engine(eng.model, **RADIX_KW)
    assert _sequential(off, RADIX_PROMPTS) == got
    assert all(torch.equal(eng.slots[k], off.slots[k]) for k in eng.slots)


def test_make_engine_serves_hybrid_on_cpu():
    """make_engine("zamba2-7b", device="cpu") in both prefill modes, greedy
    and sampled; the unfused decode route (fuse_kernels=False: K7 and
    decode attention) gives the fused route's tokens."""
    prompts = _prompts()[1:3]
    out = {}
    for mode in ("monolithic", "chunked"):
        for temp in (0.0, 0.7):
            eng = make_engine(NAME, device="cpu", prefill_mode=mode,
                              temperature=temp, top_k=8, **KW)
            assert isinstance(eng.model, Zamba2) and eng.paged and eng.dense
            out[mode, temp] = _serve(eng, prompts, 4)
            assert all(len(t) == 4 and all(0 <= x < 128 for x in t)
                       for t in out[mode, temp])
    assert out["chunked", 0.0] != out["chunked", 0.7]
    calls = []
    gather = ops.page_gather
    eng = make_engine(NAME, device="cpu", fuse_kernels=False, **KW)
    try:
        ops.page_gather = lambda *a, **k: calls.append(1) or gather(*a, **k)
        assert _serve(eng, prompts, 4) == out["monolithic", 0.0]
    finally:
        ops.page_gather = gather
    assert calls
