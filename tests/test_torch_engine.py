"""The port's tp=1 serving engine beyond chunked greedy serving, against the
reference's: monolithic prefill (the default in both packages), sampled
decoding, the unfused decode route, defrag, the load tools, and K5's plain
version on the ragged single kv chunk that monolithic prefill gives it.

Weights come from `repro`'s init at the reduced sizes and are carried
across with `params_from_jax`; full8 in native mode, under `exact_pow2`.
Tolerance: generated tokens are EQUAL (the per-step logits agree within
the model bound of test_torch_layers.py; greedy argmax, or argmax of the
logits plus the same Gumbel noise, decides on them).  The Gumbel noise's
uniforms are bitwise the reference's and each of its two fp32 logs is
within 1 ulp of XLA's on the same input.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.kernels import ref as jref
from repro_torch.configs import get
from repro_torch.convert import params_from_jax, ssm_params_from_jax
from repro_torch.core import preset, prng
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serving import (Engine, fused_decode_active, make_sampler,
                                 naive_serve, poisson_traffic, run_load,
                                 shared_prefix_traffic)

from test_torch_kernels import _jax_flash_ml
from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

KW = dict(max_lanes=2, page_size=8, max_ctx=32, prefill_chunk=2)
PROMPT_LENS = (8, 13, 21)


def _prompts(vocab, lens=PROMPT_LENS, seed=11):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32) for n in lens]


def _port_model(jengine, fuse_kernels=True):
    """The port's model of the reference engine's arch, with its weights."""
    a = jengine.model.a
    arch = a.name.removesuffix("-smoke")
    tm = build_model(get(arch).reduced(),
                     preset("full8").replace(fuse_kernels=fuse_kernels),
                     device="cpu")
    conv = ssm_params_from_jax if a.family == "ssm" else params_from_jax
    return tm.load_params(conv(jax.tree.map(np.asarray, jengine.params)))


def _pair(arch="granite-3-8b", fuse_kernels=True, **kw):
    """(reference engine, the port's engine on the same weights)."""
    jeng = jserving.make_engine(arch, mode="native", reduced=True, seed=0,
                                fuse_kernels=fuse_kernels, **kw)
    return jeng, Engine(_port_model(jeng, fuse_kernels), **kw)


def _serve(engine, prompts, new=4):
    rids = [engine.submit(p, new) for p in prompts]
    out = engine.drain()
    return [out[r] for r in rids]


# --------------------------------------------------------------------------
# monolithic prefill
# --------------------------------------------------------------------------


def test_both_packages_default_to_monolithic():
    for cls in (Engine, jserving.Engine):
        default = inspect.signature(cls.__init__).parameters["prefill_mode"]
        assert default.default == "monolithic", cls
    eng = Engine(build_model(get("granite-3-8b").reduced(), preset("full8"),
                             device="cpu").init(0), **KW)
    assert eng.prefill_mode == "monolithic" and not eng.chunked


@pytest.mark.parametrize("n_pages,new,max_ctx", [(None, 4, 32), (6, 10, 40)],
                         ids=["roomy", "preempting"])
def test_monolithic_tokens_equal_reference(n_pages, new, max_ctx,
                                           exact_pow2):
    """Monolithic prefill (the whole prompt through the train-mode layers,
    its int8 KV scattered into the pages) joins the same step's decode
    batch, and gives the reference's tokens; with 6 pages and 10 new
    tokens the pool runs short and both engines preempt (recompute) on the
    same schedule."""
    jeng, eng = _pair(**dict(KW, n_pages=n_pages, max_ctx=max_ctx))
    prompts = _prompts(jeng.model.a.vocab)
    assert _serve(eng, prompts, new) == _serve(jeng, prompts, new)
    m, jm = eng.metrics(), jeng.metrics()
    assert m["preemptions"] == jm["preemptions"]
    assert (m["preemptions"] > 0) == (n_pages is not None)
    assert m["decode_steps"] == jm["decode_steps"]
    assert m["prefill_tokens"] >= sum(PROMPT_LENS)
    assert m["pool"]["in_use"] == 0 and m["live_lanes"] == 0


def test_monolithic_ssm_tokens_equal_reference(exact_pow2):
    """falcon-mamba-7b (reduced): the whole prompt through K9 in train mode
    from zero state, the state into the lane's dense slot; 5 prompts on 2
    lanes.  Tokens equal the reference's; the final slots agree."""
    jeng, eng = _pair("falcon-mamba-7b", **KW)
    prompts = _prompts(128, (8, 13, 21, 16, 5))
    assert _serve(eng, prompts, 6) == _serve(jeng, prompts, 6)
    slots = jax.tree.map(np.asarray, jeng.slots)
    np.testing.assert_array_equal(eng.slots["conv"].numpy(), slots["conv"])
    assert np.abs(eng.slots["h"].numpy() - slots["h"]).max() <= \
        2.0 ** -18 * np.abs(slots["h"]).max()
    assert eng.pool is None and eng.metrics()["completed"] == 5


def test_prefill_and_serve_step_logits(exact_pow2):
    """The model methods underneath: `prefill` emits the reference's int8
    KV into a dense cache and its last-token logits; `serve_step` decodes
    against that cache."""
    jeng = jserving.make_engine("granite-3-8b", mode="native", reduced=True,
                                seed=0, **KW)
    tm = _port_model(jeng)
    tok = _prompts(128, (13,))[0][None]
    jc, jl = jeng.model.prefill(jeng.params, jnp.asarray(tok), 20)
    cache, lg = tm.prefill(torch.as_tensor(tok), 20)
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(cache["v"].numpy(), np.asarray(jc["v"]))
    assert int(cache["pos"][0]) == 13
    scale = float(np.abs(np.asarray(jl)).max())
    assert np.abs(lg.numpy() - np.asarray(jl)).max() <= 2.0 ** -10 * scale
    nxt = np.array([7], np.int32)
    jc2, jl2 = jeng.model.serve_step(jeng.params, jc, jnp.asarray(nxt))
    cache2, lg2 = tm.serve_step(cache, torch.as_tensor(nxt))
    np.testing.assert_array_equal(cache2["k"].numpy(), np.asarray(jc2["k"]))
    assert int(cache2["pos"][0]) == 14
    assert np.abs(lg2.numpy() - np.asarray(jl2)).max() <= 2.0 ** -10 * scale
    dense, (k, v) = tm.slot_from_cache(cache, 0)
    assert int(dense["pos"]) == 13 and tuple(k.shape) == (2, 20, 2, 16)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,data,shape", [(0, 1, (4, 49155)),
                                             (3, 7, (1, 128)),
                                             (5, 12345, (64, 4096))])
def test_gumbel_noise_matches_jax(seed, data, shape):
    """prng.gumbel against jax.random.gumbel for the same key and shape:
    the uniforms on [tiny, 1) equal bit for bit, and each of the two logs
    is within 1 ulp of XLA's fp32 log on the same input, so the noise is
    within 1 ulp of -log of (XLA's inner log + 1 ulp): |dg| <= 2^-22
    max(1, |g|) over the draw."""
    key = prng.fold_in(prng.prng_key(seed), data)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, minval=tiny,
                                      maxval=1.0))
    f = prng.uniform(key, shape)
    np.testing.assert_array_equal(
        torch.clamp_min(f * torch.tensor(1.0 - tiny) + tiny, tiny).numpy(), u)

    def ulps(x, y):
        return np.abs(x.view(np.int32).astype(np.int64)
                      - y.view(np.int32).astype(np.int64)).max()

    inner = np.asarray(jnp.log(jnp.asarray(u)))
    assert ulps(torch.log(torch.tensor(u)).numpy(), inner) <= 1
    outer = np.asarray(jnp.log(jnp.asarray(-inner)))
    assert ulps(torch.log(torch.tensor(-inner)).numpy(), outer) <= 1
    want = np.asarray(jax.random.gumbel(jkey, shape, jnp.float32))
    np.testing.assert_array_equal(want, -outer)
    got = prng.gumbel(key, shape).numpy()
    assert (np.abs(got - want) <= 2.0 ** -22 * np.maximum(1, np.abs(want))
            ).all()


def test_sampler_matches_reference():
    """make_sampler: greedy is greedy_token; at temperature 0.8 and top-k 4
    every token is among the top 4, and equals the reference sampler's
    draw for the same logits and key."""
    jkey = jax.random.PRNGKey(0)
    logits = np.array(jax.random.normal(jkey, (3, 32)))
    lt = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        make_sampler(16)(lt, prng.prng_key(0)).numpy(),
        np.argmax(logits[:, :16], axis=-1))
    for ctr in range(1, 6):
        key = prng.fold_in(prng.prng_key(0), ctr)
        got = make_sampler(16, temperature=0.8, top_k=4)(lt, key).numpy()
        want = np.asarray(jserving.make_sampler(16, 0.8, 4)(
            jnp.asarray(logits), jax.random.fold_in(jkey, ctr)))
        np.testing.assert_array_equal(got, want)
        top4 = np.argsort(logits[:, :16], axis=-1)[:, -4:]
        assert all(got[b] in top4[b] for b in range(3))


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_sampled_tokens_equal_reference(mode, exact_pow2):
    """temperature 0.7, top-k 8, seed 0: the key stream (one fold_in per
    prefill sample and per decode step) and the draws are the
    reference's, in both prefill modes."""
    kw = dict(KW, temperature=0.7, top_k=8, prefill_mode=mode)
    jeng, eng = _pair(**kw)
    prompts = _prompts(jeng.model.a.vocab)
    got = _serve(eng, prompts, 6)
    assert got == _serve(jeng, prompts, 6)
    assert eng._sample_ctr == jeng._sample_ctr
    greedy = _serve(Engine(eng.model, **dict(KW, prefill_mode=mode)),
                    prompts, 6)
    assert got != greedy


def test_greedy_ticks_the_counter_without_fold_in(monkeypatch):
    """Every prefill sample and decode step ticks the sampling counter in
    both policies, so the key stream stays the reference's; only a sampled
    engine folds the key in (greedy ignores it, and the fold-in is host
    work on every decode step)."""
    calls = []
    fold_in = prng.fold_in
    monkeypatch.setattr(prng, "fold_in",
                        lambda key, n: calls.append(n) or fold_in(key, n))
    model = build_model(get("granite-3-8b").reduced(), preset("full8"),
                        device="cpu").init(0)
    prompts = _prompts(model.a.vocab)
    for temperature in (0.0, 0.7):
        calls.clear()
        eng = Engine(model, temperature=temperature, **KW)
        _serve(eng, prompts)
        ticks = len(prompts) + eng.decode_steps
        assert eng._sample_ctr == ticks
        assert calls == ([] if temperature == 0.0
                         else list(range(1, ticks + 1)))


# --------------------------------------------------------------------------
# the unfused decode route
# --------------------------------------------------------------------------


def _decode_route_calls(eng, monkeypatch) -> dict:
    """Calls of K6 and K7 in one decode step of `eng` (spied on the ops,
    which count no launches on the CPU)."""
    calls = {"paged_attention": 0, "page_gather": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    eng._decode()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_unfused_decode_tokens_equal(mode, monkeypatch, exact_pow2):
    """fuse_kernels=False: every decode step gathers each pool through
    page_gather (K7, one call per pool and layer) and runs
    decode_attention; fuse_kernels=True runs paged_attention (K6) and
    gathers nothing.  fused_decode_active answers which.  The unfused
    tokens equal the fused route's and the reference's unfused route's."""
    kw = dict(max_lanes=2, page_size=4, max_ctx=32, prefill_mode=mode)
    prompts = [np.arange(1, 9), np.arange(3, 15)]
    jeng, eng = _pair(fuse_kernels=False, **kw)
    fused = Engine(_port_model(jeng, fuse_kernels=True), **kw)
    outs = []
    for e in (eng, fused, jeng):
        outs.append(_serve(e, prompts, 6))
    assert outs[0] == outs[1] == outs[2]
    layers = eng.model.a.n_layers
    for e, want in ((eng, False), (fused, True)):
        assert fused_decode_active(e) is want
        e.submit(prompts[0], 3)
        e.step()
        calls = _decode_route_calls(e, monkeypatch)
        assert calls == ({"paged_attention": layers, "page_gather": 0}
                         if want else
                         {"paged_attention": 0, "page_gather": 2 * layers})


def test_unfused_decode_attention_bitwise_equals_fused():
    """One layer's paged decode attention at 3 lanes (one dead, on the
    trash page) over 6 pages of 4 positions, 4 query / 2 KV heads of 16:
    the gather-then-attend route (two page_gather calls, decode_attention)
    gives the fused route's payload and scale bit for bit."""
    from repro_torch.core import qact
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(3)
    kp = torch.randint(-127, 128, (13, 4, 2, 16), generator=g,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (13, 4, 2, 16), generator=g,
                       dtype=torch.int8)
    table = torch.tensor([[3, 5, 7, 1, 0, 0], [0, 0, 0, 0, 0, 0],
                          [2, 4, 6, 8, 9, 12]], dtype=torch.int32)
    pos = torch.tensor([13, 0, 22], dtype=torch.int32)
    cfg = preset("full8")
    q = qact(cfg, "none", torch.randn((3, 1, 4, 16), generator=g))
    sc = torch.tensor(2.0 ** -7)
    outs = [L.paged_decode_attention(cfg.replace(fuse_kernels=f), q, kp, vp,
                                     table, sc, sc, q_pos=pos,
                                     t_valid=pos.max() + 1)
            for f in (True, False)]
    assert torch.equal(outs[0].data, outs[1].data)
    assert torch.equal(outs[0].scale, outs[1].scale)


# --------------------------------------------------------------------------
# defrag
# --------------------------------------------------------------------------


def test_pool_defrag_mapping_equals_reference():
    """The same alloc / ref / free sequence on both pools: defrag gives the
    reference's mapping, refcounts and free list, and moves the payloads
    with the pages."""
    pools = [jserving.PagePool(12, 4, kv_layers=2, n_kv=2, dh=4),
             ops_pool(12)]
    for pool in pools:
        a = pool.alloc(3)
        b = pool.alloc(2)
        c = pool.alloc(4)
        pool.ref(c[1])
        pool.free(a)
        pool.unref(b[0])
    jpool, pool = pools
    for pid in range(12):
        pool.k[:, pid] = pid
    mapping = pool.defrag()
    assert mapping == jpool.defrag() and mapping
    assert pool._refs == jpool._refs and pool._free == jpool._free
    for old, new in mapping.items():
        assert (pool.k[:, new] == old).all()


def ops_pool(n_pages):
    from repro_torch.serving import PagePool
    return PagePool(n_pages, 4, kv_layers=2, n_kv=2, dh=4, device="cpu")


def test_engine_defrag_mid_run(exact_pow2):
    """defrag() between engine steps, in both engines at the same step
    (the first request has finished and left its low pages free, the
    second holds higher ones): the same pages move, and the tokens, with a
    third request admitted after, equal the reference's and the port's own
    run without it."""
    kw = dict(max_lanes=2, page_size=4, max_ctx=40)
    prompts = _prompts(128, (8, 13, 21))
    news = (2, 12, 6)
    outs = []
    for with_defrag in (True, False):
        jeng, eng = _pair(**kw)
        res = []
        for e in (eng, jeng):
            rids = [e.submit(p, n) for p, n in zip(prompts[:2], news)]
            moves = None
            for _ in range(3):
                e.step()
            if with_defrag:
                moves = e.defrag()
            rids.append(e.submit(prompts[2], news[2]))
            out = e.drain()
            res.append(([out[r] for r in rids], moves))
        (got, moves), (want, jmoves) = res
        assert got == want and moves == jmoves
        if with_defrag:
            assert moves > 0
            assert eng.metrics()["pool"]["defrag_moves"] == moves
        outs.append(got)
    assert outs[0] == outs[1]


# --------------------------------------------------------------------------
# load tools
# --------------------------------------------------------------------------


def test_traffic_generators_equal_reference():
    for kw in (dict(rate=8.0, n_requests=12, seed=3),
               dict(rate=20.0, n_requests=5, prompt_lens=(4, 9),
                    gen_lens=(2,), vocab=64, seed=1)):
        got, want = poisson_traffic(**kw), jserving.poisson_traffic(**kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["arrival"] == w["arrival"]
            assert g["max_new"] == w["max_new"]
            np.testing.assert_array_equal(g["prompt"], w["prompt"])
    kw = dict(rate=8.0, n_requests=10, sharing=0.7, prefix_len=8,
              n_prefixes=2, tail_lens=(2, 5), seed=4)
    for g, w in zip(shared_prefix_traffic(**kw),
                    jserving.shared_prefix_traffic(**kw)):
        assert g["arrival"] == w["arrival"] and g["max_new"] == w["max_new"]
        np.testing.assert_array_equal(g["prompt"], w["prompt"])


def test_run_load_tokens_equal_reference(exact_pow2):
    """run_load on both engines, with arrivals so dense that every request
    is queued before the first step: the reference's tokens and counts."""
    traffic = poisson_traffic(rate=1e9, n_requests=5, prompt_lens=(5, 9, 12),
                              gen_lens=(2, 4), seed=2)
    jeng, eng = _pair(**KW)
    got, m = run_load(eng, traffic)
    want, jm = jserving.run_load(jeng, traffic)
    assert got == want
    assert m["completed"] == jm["completed"] == 5
    assert m["decode_steps"] == jm["decode_steps"]


def test_naive_serve_equals_engine_greedy(exact_pow2):
    """naive_serve (one request at a time, prefill + serve_step on a dense
    cache) gives the reference's naive tokens, and the engine's greedy
    tokens on one lane (the same batch of one at every step)."""
    jeng, eng = _pair(**dict(KW, max_lanes=1))
    traffic = poisson_traffic(rate=10.0, n_requests=3, prompt_lens=(5, 11),
                              gen_lens=(3, 5), seed=6)
    got, stats = naive_serve(eng.model, traffic)
    want, _ = jserving.naive_serve(jeng.model, jeng.params, traffic)
    assert got == want
    assert stats["generated_tokens"] == sum(r["max_new"] for r in traffic)
    rids = [eng.submit(r["prompt"], r["max_new"]) for r in traffic]
    out = eng.drain()
    assert [out[r] for r in rids] == got


# --------------------------------------------------------------------------
# K5's plain version on a ragged single kv chunk
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [37, 100])
def test_flash_plain_on_ragged_single_chunk(t, exact_pow2):
    """Monolithic prefill of a prompt shorter than the kv chunk calls K5
    with kv_chunk = T (no multiple of 64).  ref.flash_attention there
    stays within test_torch_kernels.py's K5 bound of the reference's
    oracle: m bitwise, |dl| <= T 2^-23 l, the output's Q_A codes at most 1
    apart on at most 1% of entries; ops.flash_attention on the CPU is it."""
    r = np.random.default_rng(t)
    h, kv, dh = 4, 2, 16
    q8 = r.integers(-127, 128, (1, t, h, dh)).astype(np.int8)
    k8 = r.integers(-127, 128, (1, t, kv, dh)).astype(np.int8)
    v8 = r.integers(-127, 128, (1, t, kv, dh)).astype(np.int8)
    pos, kval = np.arange(t, dtype=np.int32), np.ones(t, np.int32)
    scales = (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)
    sm = 1.0 / float(np.sqrt(dh))
    kw = dict(causal=True, sm_scale=sm, q_chunk=t, kv_chunk=t)
    targs = [torch.from_numpy(x) for x in (q8, k8, v8, pos, pos, kval)]
    parts = ref.flash_attention_parts(
        *targs, *(torch.tensor(x) for x in scales), **kw)
    jargs = (jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(kval),
             *(jnp.float32(x) for x in scales))
    want = np.asarray(jax.jit(functools.partial(jref.flash_attention_ref,
                                                **kw))(*jargs))
    m, l = _jax_flash_ml(*jargs[:2], *jargs[3:6], jargs[6:], causal=True,
                         sm=sm, qc=t, kc=t)
    np.testing.assert_array_equal(parts["m"].numpy(), m)
    assert (np.abs(parts["l"].numpy() - l) <= t * 2.0 ** -23 * l).all()
    got = parts["out"].numpy()
    step = 2.0 ** (np.ceil(np.log2(np.abs(want).max())) - 7)
    d = np.abs(np.round(got / step) - np.round(want / step))
    assert d.max() <= 1 and np.mean(d > 0) <= 0.01
    np.testing.assert_array_equal(ops.flash_attention(
        *targs, *(torch.tensor(x) for x in scales), **kw).numpy(), got)
