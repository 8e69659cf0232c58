"""The port's Mamba1 SSM (repro_torch: K9's plain version, the block, SSMLM
and the engine's dense slots) against the reference package's.

Sizes are falcon-mamba-7b.reduced(): 2 layers, d_model 64, d_inner 128,
ssm_state N = 4, dt rank 4, vocab 128.  The reference's weights come from
`repro.models.ssm_lm.SSMLM.init` and are carried over with
`ssm_params_from_jax`; every test that runs the quantized model uses the
`exact_pow2` fixture.

Tolerances, and why:
- The scan.  The port's recurrence is sequential (h = a*h rounded, + b
  rounded; y_t the float64 n-ordered sum of h*c rounded once); the
  reference's model path uses a chunked associative scan and its kernel an
  fp32 sum over n.  They compute the same function associated differently,
  so they agree within a normwise bound:
      |dy_t| <= KAPPA * 2^-24 * sum_n M_t[n] |c_t[n]|,
      |dh_t| <= KAPPA * 2^-24 * M_t,
  where M is the recurrence on absolute values, M_t = |a_t| M_{t-1} +
  |b_t|, M_0 = |h0|: it bounds every term that built h_t, and |h_t| itself
  can be far smaller than them when b's signs cancel.  KAPPA counts the
  roundings one element passes through: 2 per sequential step (multiply,
  add), 2 log2(c) + 2 for an associative scan over chunks of c (a tree of
  depth log2 c, each level a multiply and an add) and N for an fp32 sum
  over n (the reference's; the port's float64 sum rounds once).  Older
  roundings decay with the a's, so the count does not grow with S.
  Measured at most 4.2 against KAPPA 6 to 24 over these shapes.
- The block and the model.  Every input to the scan is an int8 dot times a
  pow2 scale, a 16-bit grid value, or an fp32 exp/softplus of one; the
  scan's reassociation reaches the out_proj input payload only where a
  value sits at a rounding boundary of its grid.  So: out_proj's input
  scale equal, at most 1% of its codes differ and those by one; the block
  output within 2^-24 * |Delta code| . |W| times the payload step (what
  the flipped codes can move) plus one rounding of x + out; logits within
  2^-10 of their largest magnitude.  Measured: no code differs and the
  outputs and logits are equal bit for bit at these sizes.
- The engine: greedy tokens EQUAL, and every lane's final slot (dead lanes
  included: release never resets a slot, so the state a lane's last
  occupant left there rides along in every decode step and enters the
  batch-global activation scales) equal for the conv window and within
  2^-18 of max |h| for the scan state (measured 2^-23.4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.core import qt_carrier as jqt_carrier
from repro.core import qweight as jqweight
from repro.kernels.ref import selective_scan_ref
from repro.kernels.selective_scan import selective_scan as jscan
from repro.models.ssm_lm import SSMLM as JSSMLM
from repro.serving import make_engine as jmake_engine
from repro_torch.configs import get
from repro_torch.convert import ssm_params_from_jax
from repro_torch.core import preset
from repro_torch.kernels import ops, ref
from repro_torch.models import SSMLM, build_model
from repro_torch.models import ssm as TS
from repro_torch.serving import Engine, make_engine

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

U = 2.0 ** -24


def kappa(n: int, chunk: int | None = None, y: bool = True) -> float:
    """The rounding count of the bound: the sequential step's 2, the
    associative scan's 2 log2(chunk) + 2 when it is one, and the fp32 sum
    over n's N for y."""
    k = 2.0 + (2.0 * np.log2(chunk) + 2.0 if chunk else 0.0)
    return k + (n if y else 0.0)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _scan_inputs(b, s, d, n, seed=0):
    """The model's scan inputs: a = exp(dt A) with dt log-uniform in
    [1e-3, 1e-1] and A = -(1..N), b ~ 0.1 N(0, 1), c ~ N(0, 1), h0 ~ N(0, 1)."""
    r = np.random.default_rng(seed)
    dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (b, s, d)))
    a = np.exp(dt[..., None] * -np.arange(1, n + 1)).astype(np.float32)
    bb = (r.standard_normal((b, s, d, n)) * 0.1).astype(np.float32)
    c = r.standard_normal((b, s, n)).astype(np.float32)
    h0 = r.standard_normal((b, d, n)).astype(np.float32)
    return a, bb, c, h0


def _abs_recurrence(a, b, c, h0=None):
    """(sum_n M_t[n] |c_t[n]| (B, S, D), M_S (B, D, N)) in float64."""
    m = (np.zeros(a.shape[:1] + a.shape[2:]) if h0 is None
         else np.abs(h0.astype(np.float64)))
    ys = np.zeros(a.shape[:3])
    for t in range(a.shape[1]):
        m = np.abs(a[:, t]) * m + np.abs(b[:, t])
        ys[:, t] = (m * np.abs(c[:, t, None, :])).sum(-1)
    return ys, m


def _assert_within(got, want, scale, bound, what):
    k = float((np.abs(got.astype(np.float64) - want) / (U * scale)).max())
    assert k <= bound, f"{what}: {k:.3f} * 2^-24 of the norm > {bound}"


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def models():
    """(reference QConfig, ArchConfig, SSMLM, params; the port's SSMLM with
    the same weights), at falcon-mamba-7b.reduced() sizes."""
    ja = jget("falcon-mamba-7b").reduced()
    jq = jpreset("full8", "native")
    jm = JSSMLM(ja, jq)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get("falcon-mamba-7b").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray, params)))
    return jq, ja, jm, params, tm


# --------------------------------------------------------------------------
# (a)-(c) the scan
# --------------------------------------------------------------------------

SCAN_SHAPES = [(1, 16, 8, 4), (2, 48, 24, 4), (2, 33, 10, 4),
               (1, 64, 128, 4), (1, 200, 16, 16)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_from_zero_matches_tpu_kernel(shape):
    """(a) h0 = None is the TPU kernel's function: the plain scan against
    the Pallas kernel in interpret mode (ragged blocks: bd 8, bs 16) and
    its oracle, within the normwise bound; the kernel equals its oracle."""
    a, b, c, _ = _scan_inputs(*shape)
    y, h_last = ref.selective_scan(_t(a), _t(b), _t(c))
    yk = np.asarray(jscan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                          bd=8, bs=16, interpret=True))
    yr = np.asarray(selective_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(c)))
    np.testing.assert_array_equal(yk, yr)
    ynorm, m = _abs_recurrence(a, b, c)
    _assert_within(y.numpy(), yr, ynorm, kappa(shape[3]),
                   "y vs selective_scan")
    assert y.shape == shape[:3] and h_last.shape == shape[:1] + shape[2:]


@pytest.mark.parametrize("chunk", [16, 256])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_with_state_matches_chunked_scan(shape, chunk):
    """(b) With a carried h0, y and h_last against the reference model
    path's chunked associative scan (`_sscan_chunked`)."""
    a, b, c, h0 = _scan_inputs(*shape, seed=1)
    y, h_last = ref.selective_scan(_t(a), _t(b), _t(c), _t(h0))
    yc, hc = JS._sscan_chunked(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(c), jnp.asarray(h0), chunk)
    ynorm, m = _abs_recurrence(a, b, c, h0)
    c_eff, n = min(chunk, shape[1]), shape[3]
    _assert_within(y.numpy(), np.asarray(yc), ynorm, kappa(n, c_eff),
                   "y vs _sscan_chunked")
    _assert_within(h_last.numpy(), np.asarray(hc), m,
                   kappa(n, c_eff, y=False), "h_last vs _sscan_chunked")


@pytest.mark.parametrize("split", [1, 7, 16, 47])
def test_scan_continued_from_h_last_is_bitwise(split):
    """(c) The port's own property: a scan over [0:S1] continued from its
    h_last over [S1:S] equals one scan over [0:S], bit for bit (so chunked
    prefill pages and decode steps compose exactly)."""
    a, b, c, h0 = _scan_inputs(2, 48, 24, 4, seed=2)
    a, b, c, h0 = _t(a), _t(b), _t(c), _t(h0)
    y, h = ref.selective_scan(a, b, c, h0)
    y1, h1 = ref.selective_scan(a[:, :split], b[:, :split], c[:, :split], h0)
    y2, h2 = ref.selective_scan(a[:, split:], b[:, split:], c[:, split:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h)


def test_scan_numerics_are_the_kernels():
    """The plain version's arithmetic, spelled out: two roundings per step
    and y the float64 n-ordered sum rounded once."""
    a, b, c, h0 = (_t(x) for x in _scan_inputs(1, 5, 3, 4, seed=3))
    y, h_last = ref.selective_scan(a, b, c, h0)
    h = h0.clone()
    for t in range(5):
        h = (a[:, t] * h) + b[:, t]
        acc = h[..., 0].double() * c[:, t, None, 0].double()
        for j in range(1, 4):
            acc = acc + h[..., j].double() * c[:, t, None, j].double()
        assert torch.equal(y[:, t], acc.float())
    assert torch.equal(h_last, h)


def test_cpu_tensors_route_to_the_plain_scan():
    ops.reset_launches()
    a, b, c, h0 = (_t(x) for x in _scan_inputs(1, 4, 8, 16))
    got = ops.selective_scan(a, b, c, h0)
    want = ref.selective_scan(a, b, c, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES["selective_scan"] == 0


# --------------------------------------------------------------------------
# (d) the causal convolution
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv1d_against_reference(models, with_init):
    """(d) On grid-valued inputs (what the path feeds it: in_proj's output
    is an int32 dot times a pow2 scale) the tap-ordered fp32 sum equals
    XLA's convolution bit for bit; on N(0, 1) inputs it is within one
    rounding per tap of the sum of |x w| (XLA sums in another order)."""
    jq, _, _, params, tm = models
    r = np.random.default_rng(4)
    w = np.asarray(params["layers"]["conv_w"][0])
    bias = (r.standard_normal(128) * 0.1).astype(np.float32)
    for x, init in (
            ((r.integers(-300, 300, (2, 16, 128)) * 2.0 ** -6),
             (r.integers(-300, 300, (2, 3, 128)) * 2.0 ** -6)),
            (r.standard_normal((2, 16, 128)), r.standard_normal((2, 3, 128)))):
        x, init = x.astype(np.float32), init.astype(np.float32)
        init = init if with_init else None
        want = np.asarray(JS.causal_conv1d(
            jq, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            None if init is None else jnp.asarray(init)))
        got = TS.causal_conv1d(tm.q, _t(x), _t(w), _t(bias),
                               None if init is None else _t(init)).numpy()
        if np.all(x == np.round(x * 64) / 64):
            np.testing.assert_array_equal(got, want)
        else:
            wq = np.round(w * 128) / 128
            xp = np.concatenate([np.zeros((2, 3, 128)) if init is None
                                 else init, x], 1)
            mag = sum(np.abs(xp[:, k:k + 16] * wq[k]) for k in range(4))
            assert (np.abs(got - want) <= 4 * U * (mag + np.abs(bias))).all()


def test_decode_window_against_reference(models):
    """(d) Decode mode: the reference's einsum over the (B, K, C) window
    against the port's causal_conv1d of one token after its K-1 carried
    inputs (the sum chunk mode takes too), on grid-valued inputs."""
    jq, _, _, params, tm = models
    r = np.random.default_rng(5)
    w = params["layers"]["conv_w"][1]
    bias = params["layers"]["conv_b"][1]
    window = (r.integers(-500, 500, (3, 4, 128)) * 2.0 ** -7).astype(
        np.float32)
    wq = jqt_carrier(jqweight(jq, w))
    want = np.asarray(jnp.einsum("kc,bkc->bc", wq, jnp.asarray(window))
                      + bias)
    got = TS.causal_conv1d(tm.q, _t(window[:, 3:]), _t(w), _t(bias),
                           init=_t(window[:, :3]))
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    tail = TS.conv_window_tail(_t(window[:, 3:]), _t(window[:, :3]), 3)
    assert torch.equal(tail, _t(window[:, 1:]))


# --------------------------------------------------------------------------
# (e) the block, (f) the model
# --------------------------------------------------------------------------


def _capture_out_proj(monkeypatch, module, store, key, d_inner, d_model):
    """Record the QTensor that enters out_proj (the (d_inner, d_model)
    qdense) in `module`'s mamba1_block."""
    inner = module.qdense

    def qdense(cfg, x, w, *a, **k):
        if tuple(w.shape) == (d_inner, d_model):
            store[key] = x
        return inner(cfg, x, w, *a, **k)
    monkeypatch.setattr(module, "qdense", qdense)


@pytest.mark.parametrize("mode,bsz,s", [("chunk", 1, 8), ("decode", 3, 1),
                                        ("train", 2, 21)])
def test_mamba1_block_against_reference(models, monkeypatch, exact_pow2,
                                        mode, bsz, s):
    """(e) One block in each mode from the same input and carried state:
    out_proj's input payload (scale equal, <= 1% of codes flipped, by one),
    the block output within what the flipped codes can move, the new
    conv window equal and h within the scan bound's reach."""
    jq, ja, _, params, tm = models
    cap = {}
    _capture_out_proj(monkeypatch, JS, cap, "ref", 128, 64)
    _capture_out_proj(monkeypatch, TS, cap, "port", 128, 64)
    r = np.random.default_rng(6)
    x = r.standard_normal((bsz, s, 64)).astype(np.float32)
    st = None
    if mode != "train":
        st = {"conv": (r.integers(-200, 200, (bsz, 3, 128)) * 2.0 ** -7
                       ).astype(np.float32),
              "h": (r.standard_normal((bsz, 128, 4)) * 0.5).astype(
                  np.float32)}
    lp = jax.tree.map(lambda v: v[0], params["layers"])
    out_j, ns_j = JS.mamba1_block(jq, ja, lp, jnp.asarray(x), mode,
                                  None if st is None else
                                  jax.tree.map(jnp.asarray, st))
    with torch.no_grad():
        out_t, ns_t = TS.mamba1_block(
            tm.q, tm.a, {k: _t(v) for k, v in lp.items()}, _t(x), mode,
            None if st is None else {k: _t(v) for k, v in st.items()})
    pj, pt = cap["ref"], cap["port"]
    assert float(pj.scale) == float(pt.scale)
    dcode = np.abs(np.asarray(pj.data).astype(np.int32)
                   - pt.data.numpy().astype(np.int32))
    assert dcode.max() <= 1 and dcode.mean() <= 0.01
    wq = np.abs(np.round(np.asarray(lp["out_proj"]) * 128) / 128)
    out_j = np.asarray(out_j)
    reach = float(pj.scale) * (dcode.reshape(-1, 128) @ wq).reshape(
        out_j.shape) + 2.0 ** -23 * np.abs(out_j)
    assert (np.abs(out_t.numpy() - out_j) <= reach).all()
    np.testing.assert_array_equal(ns_t["conv"].numpy(),
                                  np.asarray(ns_j["conv"]))
    hj = np.asarray(ns_j["h"])
    assert np.abs(ns_t["h"].numpy() - hj).max() <= 2.0 ** -18 * np.abs(
        hj).max()


def _logits_close(got, want, vocab=128):
    got, want = got[..., :vocab], np.asarray(want)[..., :vocab]
    assert np.abs(got - want).max() <= 2.0 ** -10 * np.abs(want).max()


def test_ssmlm_prefill_and_serve_step_logits(models, exact_pow2):
    """(f) Parallel prefill of 2 x 21 tokens, then 4 decode steps: logits
    within 2^-10 of their largest magnitude at every step."""
    _, _, jm, params, tm = models
    r = np.random.default_rng(7)
    toks = r.integers(0, 128, (2, 21)).astype(np.int32)
    sj, lj = jm.prefill(params, jnp.asarray(toks))
    st, lt = tm.prefill(_t(toks))
    _logits_close(lt.numpy(), lj)
    assert tuple(st["h"].shape) == (2, 2, 128, 4)
    assert st["pos"].tolist() == [21, 21]
    for _ in range(4):
        nxt = r.integers(0, 128, (2,)).astype(np.int32)
        sj, lj = jm.serve_step(params, sj, jnp.asarray(nxt))
        st, lt = tm.serve_step(st, _t(nxt))
        _logits_close(lt.numpy(), lj)
    assert st["pos"].tolist() == [25, 25]


def test_prefill_page_from_zero_equals_prefill(models):
    """A chunked-prefill page from the zero slot equals the parallel
    prefill of the same tokens bit for bit (the zero conv window is the
    zero padding, and the scan from zeros is the scan from h0 = None);
    one decode step after either agrees too."""
    tm = models[4]
    toks = _t(np.random.default_rng(8).integers(0, 128, 8).astype(np.int32))
    lg, dense = tm.prefill_page(tm.init_slots(1), None, toks, 0)
    st, lp = tm.prefill(toks[None])
    assert torch.equal(lg, lp)
    assert torch.equal(dense["h"], st["h"])
    assert torch.equal(dense["conv"], st["conv"])
    nxt = torch.tensor([5])
    assert torch.equal(tm.paged_decode_step(dense, None, nxt)[0],
                       tm.serve_step(st, nxt)[1])
    slot, kv = tm.slot_from_cache(st, 0)
    assert kv is None
    assert torch.equal(slot["h"], dense["h"][:, 0]) and int(slot["pos"]) == 8


# --------------------------------------------------------------------------
# (g) the engine
# --------------------------------------------------------------------------

KW = dict(max_lanes=2, page_size=8, max_ctx=32, prefill_chunk=2)
PROMPT_LENS = (8, 13, 21, 16, 5)
NEW = 6


def _serve(engine, prompts, new=NEW):
    rids = [engine.submit(p, new) for p in prompts]
    out = engine.drain()
    return [out[r] for r in rids]


def test_engine_tokens_equal_reference(exact_pow2):
    """(g) Chunked prefill (full pages two at a time, masked pages past a
    prompt, then the ragged tail through the B=1 decode step) and dense
    slot decode over both lanes: 5 prompts on 2 lanes, so lanes are
    reused and dead lanes ride along with stale state.  Greedy tokens
    equal the reference engine's; every lane's final slot agrees."""
    jeng = jmake_engine("falcon-mamba-7b", mode="native", reduced=True,
                        seed=0, prefill_mode="chunked", **KW)
    r = np.random.default_rng(11)
    prompts = [r.integers(0, 128, n).astype(np.int32) for n in PROMPT_LENS]
    want = _serve(jeng, prompts)
    tm = build_model(get("falcon-mamba-7b").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray,
                                                    jeng.params)))
    eng = Engine(tm, prefill_mode="chunked", **KW)
    assert eng.pool is None and eng.scheduler.pool is None
    got = _serve(eng, prompts)
    assert got == want
    slots = jax.tree.map(np.asarray, jeng.slots)
    np.testing.assert_array_equal(eng.slots["conv"].numpy(), slots["conv"])
    assert np.abs(eng.slots["h"].numpy() - slots["h"]).max() <= \
        2.0 ** -18 * np.abs(slots["h"]).max()
    m = eng.metrics()
    assert "pool" not in m and m["completed"] == len(PROMPT_LENS)
    assert m["generated_tokens"] == NEW * len(PROMPT_LENS)
    assert m["prefill_tokens"] == sum(PROMPT_LENS)
    assert m["live_lanes"] == 0 and not eng._pf_dense


def test_make_engine_serves_ssm_on_cpu():
    eng = make_engine("falcon-mamba-7b", reduced=True, device="cpu", seed=3,
                      prefill_mode="chunked", **KW)
    a = eng.model.a
    assert isinstance(eng.model, SSMLM)
    assert (a.d_model, a.d_inner, a.ssm_state, a.vocab) == (64, 128, 4, 128)
    r = np.random.default_rng(12)
    toks = _serve(eng, [r.integers(0, 128, n) for n in PROMPT_LENS])
    assert all(len(t) == NEW and all(0 <= x < 128 for x in t) for t in toks)
    assert eng.metrics()["decode_steps"] > 0


# --------------------------------------------------------------------------
# (h) what is not ported, and the full-width layout
# --------------------------------------------------------------------------


def test_unported_ssm_options_raise(models):
    tm = models[4]
    with pytest.raises(NotImplementedError, match="item 5"):
        TS.mamba1_block(tm.q, tm.a, tm._layer(0), torch.zeros(1, 1, 64),
                        "decode", tm.init_state(1), tp_size=2)


def test_configs_match_reference():
    for name in ("falcon-mamba-7b",):
        for cfg, jcfg in ((get(name), jget(name)),
                          (get(name).reduced(), jget(name).reduced())):
            for f in ("n_layers", "d_model", "vocab", "vocab_padded",
                      "ssm_state", "ssm_kind", "d_conv", "expand",
                      "d_inner", "headdim", "scan_chunk",
                      "unroll_scan_chunks", "family", "name"):
                assert getattr(cfg, f) == getattr(jcfg, f), f


def test_full_width_layouts_at_cut_depth():
    """chip_smoke.py's model: every width of falcon-mamba-7b, 4 of 64
    layers (built on the meta device: shapes only, no storage)."""
    model = build_model(get("falcon-mamba-7b").replace(n_layers=4),
                        preset("full8"), device="meta")
    shapes = {k: tuple(p.shape[1:]) for k, p in model.layers.items()}
    assert shapes["in_proj"] == (4096, 16384)
    assert shapes["x_proj"] == (8192, 288)
    assert shapes["dt_proj"] == (256, 8192)
    assert shapes["out_proj"] == (8192, 4096)
    assert shapes["A_log"] == (8192, 16)
    assert tuple(model.embed.shape) == (65024, 4096)
    per_layer = sum(p[0].numel() for p in model.layers.values())
    assert per_layer == 105_312_256
    assert model.n_params() == 953_929_728
