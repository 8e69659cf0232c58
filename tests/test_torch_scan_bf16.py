"""The Mamba1 scan on bf16 carriers (`QConfig.scan_dtype="bf16"`) against
the reference package's, on the CPU.

The reference casts a, b, c and h0 to bf16 after the fp32 discretisation
and runs its chunked associative scan (`_sscan_chunked`) in bf16
arithmetic; y goes back to fp32 (and h_last in chunk mode).  The port
casts the same operands, but its scan (K9; `ref.selective_scan` on the
CPU) widens them exactly to fp32, keeps h in fp32 with the fp32 route's
two roundings a step and the float64 n-ordered sum for y, and rounds each
output once to bf16 (y float64 -> fp32 -> bf16); the gradient (K9b,
`ref.selective_scan_bwd`) likewise, every output rounded once to bf16.

Tolerances, and why:
- The scan and its gradient: the fp32 slice's normwise bounds
  (tests/test_torch_ssm.py, tests/test_torch_ssm_train.py), with the
  unit roundoff of bf16, U = 2^-8, in place of 2^-24: the reference's
  roundings now happen in bf16 (the same count, K_H = 4 + 2 log2(c) for
  h, N more for its sum over n in y, K_G = 6 + 2 log2(c) for the
  gradient), the port's in fp32 plus one bf16 rounding of each output.
  Measured at most 1.8 (y), 2.4 (h_last), 4.2 (db), 4.0 (da), 1.4 (dc)
  and 4.6 (dh0) units of 2^-8 of the norm against bounds of 12 to 81, so
  the port's fp32 arithmetic inside the scan leaves it no further from
  the reference's bf16 scan than the fp32 slice's bound: no documented
  divergence.
- The block: bf16 moves y by about an ulp of bf16, which reaches
  out_proj's 8-bit input payload where a value sits near a rounding
  boundary: the scale equal, at most 5% of the codes flipped, by at most
  one (measured 0.7% in chunk mode), the output within what the flipped
  codes can move; the new h within 2^-5 of max |h|, four bf16 ulps of
  the largest (measured 2^-6.9 and 2^-6.5).
- The model (SSMLM.loss and its gradients): the loss within 2^-10
  relative; each leaf's gradient no further from the reference's than
  twice the reference's own move from fp32 to bf16 carriers (the flipped
  payload codes move the error that every earlier layer and the exempt
  leaves see: ROADMAP Queue 3, D3, with the readings).
- Three full8 steps beside the reference's make_train_step: the loss
  within 2e-3 relative at every step and the hidden weights' k_WU-grid
  codes within full8's 5-step bound of tests/test_torch_train.py (95% of
  the codes, 8192 apart).  The LM's step-1 bound (0.1% of the codes, 26
  apart) does not hold here (D3): measured 29.8% of the codes, 390 apart,
  after step 1, 87.7%, 1196 apart, after step 3, losses within 2.1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.launch.train import make_train_step as jmake_step
from repro.models.ssm_lm import SSMLM as JSSMLM
from repro.optim import init_momentum as jinit_momentum
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, ssm_params_from_jax
from repro_torch.core import QConfig, preset
from repro_torch.data import TokenTask
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import ssm as TS
from repro_torch.optim import flatten

from test_torch_ssm_train import _norms, _scan_inputs
from torch_parity import exact_pow2  # noqa: F401

U8 = 2.0 ** -8
ARCH = "falcon-mamba-7b"
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (test_torch_resnet.py): the suite's workers
    share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf(x):
    """numpy fp32 -> the same values rounded to bf16, as fp32."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


def _tb(x):
    return None if x is None else torch.tensor(x).to(BF)


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _within(got, want, scale, bound, what):
    k = float((np.abs(got - want) / np.maximum(U8 * scale, 1e-300)).max())
    print(f"{what}: {k:.3f} x 2^-8 of the norm (bound {bound:.1f})")
    assert k <= bound, f"{what}: {k:.3f} * 2^-8 of the norm > {bound}"


def test_scan_dtype_bf16_validates():
    """The field reads as the reference's: "bf16" selects bf16 carriers
    and passes validate(), "f32" stays the default."""
    QConfig(scan_dtype="bf16").validate()
    QConfig(mode="sim", scan_dtype="bf16").validate()
    assert QConfig().scan_dtype == "f32" == jpreset("full8").scan_dtype


# (shape, chunk, with h0, with dh_last)
CASES = [((2, 37, 24, 4), 16, True, True),
         ((2, 37, 24, 4), 256, True, False),
         ((2, 33, 10, 16), 16, False, True),
         ((1, 64, 64, 16), 256, True, True)]


@pytest.mark.parametrize("shape,chunk,with_h0,with_dh", CASES)
def test_bf16_scan_and_gradient_against_reference(shape, chunk, with_h0,
                                                  with_dh):
    """ref.selective_scan and ref.selective_scan_bwd on bf16 operands
    against `_sscan_chunked` and its jax.vjp on the same bf16 values:
    outputs in bf16, within the normwise bounds at U = 2^-8."""
    a, b, c, h0, dy, dh = map(_bf, _scan_inputs(*shape,
                                                seed=sum(shape) + chunk))
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    jh0 = (jnp.zeros(shape[:1] + shape[2:], jnp.bfloat16) if h0 is None
           else _jb(h0))
    (jy, jhl), vjp = jax.vjp(lambda a_, b_, c_, h_: JS._sscan_chunked(
        a_, b_, c_, h_, chunk), _jb(a), _jb(b), _jb(c), jh0)
    wa, wb, wc, wh0 = map(_f64, vjp((_jb(dy), jnp.zeros_like(jh0)
                                     if dh is None else _jb(dh))))
    y, hl = ref.selective_scan(_tb(a), _tb(b), _tb(c), _tb(h0))
    da, db, dc, dh0 = ref.selective_scan_bwd(_tb(a), _tb(b), _tb(c),
                                             _tb(dy), _tb(h0), _tb(dh))
    assert all(t.dtype == BF for t in (y, hl, da, db, dc))
    mp, mt, gs = _norms(a, b, c, h0, dy, dh)
    lc = 2 * np.log2(min(chunk, shape[1]))
    kh, kg, n = 4 + lc, 6 + lc, shape[3]
    _within(_f64(y), _f64(jy), (np.abs(c)[:, :, None, :] * mt).sum(-1),
            kh + n, "y")
    _within(_f64(hl), _f64(jhl), mt[:, -1], kh, "h_last")
    _within(_f64(db), wb, gs, kg, "db")
    _within(_f64(da), wa, gs * mp, kg + kh + 1, "da")
    dcn = (np.abs(dy.astype(np.float64))[..., None] * mt).sum(2)
    _within(_f64(dc), wc, dcn, kh + shape[2] + 1, "dc")
    if h0 is None:
        assert dh0 is None
    else:
        assert dh0.dtype == BF
        _within(_f64(dh0), wh0, np.abs(a[:, 0]) * gs[:, 0], kg + 1, "dh0")


def test_bf16_plain_versions_round_the_fp32_route_once():
    """The stated chain: the bf16 plain versions are the fp32 ones on the
    exact fp32 values, each output rounded once to bf16 to nearest even
    (y and dc from their float64 sums through fp32).  Mixed dtypes raise
    in the op's checks on the card only; CPU tensors take the plain
    version, whose outputs follow the operands' dtype."""
    a, b, c, h0, dy, dh = (torch.tensor(_bf(x)) for x in _scan_inputs(
        2, 19, 40, 16, seed=3))
    y32, h32 = ref.selective_scan(a, b, c, h0)
    y, h = ref.selective_scan(*(t.to(BF) for t in (a, b, c, h0)))
    assert torch.equal(y, y32.to(BF)) and torch.equal(h, h32.to(BF))
    g32 = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    g = ref.selective_scan_bwd(*(t.to(BF) for t in (a, b, c, dy, h0, dh)))
    for x, w in zip(g, g32):
        assert x.dtype == BF and torch.equal(x, w.to(BF))
    ops.reset_launches()
    yo, ho = ops.selective_scan(*(t.to(BF) for t in (a, b, c, h0)))
    assert torch.equal(yo, y) and torch.equal(ho, h)
    assert ops.LAUNCHES["selective_scan"] == 0


def test_bf16_scan_autograd_routes_to_the_bf16_gradient():
    """autograd through ops.selective_scan on bf16 operands returns bf16
    gradients equal to ref.selective_scan_bwd's."""
    a, b, c, h0, dy, dh = (torch.tensor(_bf(x)).to(BF) for x in
                           _scan_inputs(1, 12, 8, 4, seed=4))
    leaves = [t.clone().requires_grad_() for t in (a, b, c, h0)]
    y, h = ops.selective_scan(*leaves)
    torch.autograd.backward((y, h), (dy, dh))
    want = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == BF and torch.equal(t.grad, w)


# --------------------------------------------------------------------------
# the block and the model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    ja = jget(ARCH).reduced()
    jq = jpreset("full8", "native").replace(scan_dtype="bf16")
    jm = JSSMLM(ja, jq)
    params = jm.init(jax.random.PRNGKey(0))
    tq = preset("full8").replace(scan_dtype="bf16")
    tm = build_model(get(ARCH).reduced(), tq, device="cpu")
    tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray, params)))
    return jq, ja, jm, params, tm


def _capture_out_proj(monkeypatch, module, store, key):
    inner = module.qdense

    def qdense(cfg, x, w, *a, **k):
        if tuple(w.shape) == (128, 64):
            store[key] = x
        return inner(cfg, x, w, *a, **k)
    monkeypatch.setattr(module, "qdense", qdense)


@pytest.mark.parametrize("mode,bsz,s", [("train", 2, 21), ("chunk", 1, 8)])
def test_mamba1_block_bf16_against_reference(models, monkeypatch,
                                             exact_pow2, mode, bsz, s):
    """One block with scan_dtype "bf16": out_proj's input payload (scale
    equal, at most 5% of the codes flipped, by one), the output within
    what the flipped codes move, the conv window equal, the new h within
    2^-5 of max |h|; train mode's h_last is bf16 (the reference's
    carrier), chunk mode's fp32 (the slot store)."""
    jq, ja, _, params, tm = models
    cap = {}
    _capture_out_proj(monkeypatch, JS, cap, "ref")
    _capture_out_proj(monkeypatch, TS, cap, "port")
    r = np.random.default_rng(6)
    x = r.standard_normal((bsz, s, 64)).astype(np.float32)
    st = None
    if mode == "chunk":
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
            tm.q, tm.a, {k: torch.tensor(np.asarray(v)) for k, v in
                         lp.items()}, torch.tensor(x), mode,
            None if st is None else {k: torch.tensor(v)
                                     for k, v in st.items()})
    pj, pt = cap["ref"], cap["port"]
    assert float(pj.scale) == float(pt.scale)
    dcode = np.abs(np.asarray(pj.data).astype(np.int32)
                   - pt.data.numpy().astype(np.int32))
    print(f"{mode}: out_proj input codes flipped {dcode.mean():.4f}, "
          f"max {dcode.max()}")
    assert dcode.max() <= 1 and dcode.mean() <= 0.05
    wq = np.abs(np.round(np.asarray(lp["out_proj"]) * 128) / 128)
    out_j = np.asarray(out_j)
    reach = float(pj.scale) * (dcode.reshape(-1, 128) @ wq).reshape(
        out_j.shape) + 2.0 ** -23 * np.abs(out_j)
    assert (np.abs(out_t.numpy() - out_j) <= reach).all()
    np.testing.assert_array_equal(ns_t["conv"].numpy(),
                                  np.asarray(ns_j["conv"]))
    hj = _f64(ns_j["h"])
    want_dtype = torch.float32 if mode == "chunk" else BF
    assert ns_t["h"].dtype == want_dtype
    assert str(ns_j["h"].dtype) == ("float32" if mode == "chunk"
                                    else "bfloat16")
    gap = np.abs(_f64(ns_t["h"]) - hj).max() / np.abs(hj).max()
    print(f"{mode}: new h within {gap:.3e} of max |h|")
    assert gap <= 2.0 ** -5


def test_ssmlm_bf16_loss_and_gradients(models, exact_pow2):
    """SSMLM.loss with bf16 carriers and every leaf's gradient against
    the reference's under jax.grad.  The loss within 2^-10 relative; each
    leaf's gradient, measured in its largest magnitude, no further from
    the reference's bf16 gradient than twice the reference's own move
    from fp32 to bf16 carriers on that leaf (ROADMAP Queue 3, D3: the
    port's fp32 arithmetic inside the scan flips some payload codes that
    the reference's bf16 arithmetic does not).  Measured: the loss 8.4e-5
    apart; the leaves 1.7% to 7.0% apart, the reference's own move 1.6%
    to 8.0%, the largest ratio 1.75."""
    _, ja, jm, params, tm = models
    r = np.random.default_rng(9)
    batch = {"tokens": r.integers(0, 128, (2, 21)).astype(np.int32),
             "labels": r.integers(0, 128, (2, 21)).astype(np.int32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jbatch)
    j32 = JSSMLM(ja, jpreset("full8", "native"))
    _, jg32 = jax.jit(jax.value_and_grad(j32.loss, has_aux=True))(
        params, jbatch)
    tm.zero_grad(set_to_none=True)
    loss, _ = tm.loss(batch)
    rel = abs(float(loss.detach()) - float(jl)) / float(jl)
    print(f"loss {float(loss.detach()):.7f} vs {float(jl):.7f}: rel "
          f"{rel:.3e}")
    assert rel <= 2.0 ** -10
    loss.backward()

    def gap(x, w):
        return float(np.abs(x - w).max() / max(np.abs(w).max(), 1e-30))

    for i, (p, w, w32) in enumerate(zip(flatten(tm.params()),
                                        jax.tree.leaves(jg),
                                        jax.tree.leaves(jg32))):
        w, w32 = np.asarray(w), np.asarray(w32)
        got, own = gap(p.grad.numpy(), w), gap(w, w32)
        print(f"leaf {i}: {got:.4f} of its largest magnitude; the "
              f"reference's own fp32 -> bf16 move {own:.4f}")
        assert got <= 2 * own, (i, got, own)
    tm.zero_grad(set_to_none=True)


HIDDEN = ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj")


def _codes(get_w) -> np.ndarray:
    return np.concatenate([np.asarray(get_w(k), np.float64).ravel() * 2 ** 23
                           for k in HIDDEN])


def test_three_bf16_steps_within_bounds(exact_pow2):
    """Three full8 make_train_step steps with scan_dtype "bf16" from the
    same weights as the reference's, over TokenTask batches of 4 x 32:
    the loss within 2e-3 relative at every step, the hidden codes within
    full8's 5-step bound (95%, 8192 apart)."""
    acfg = jget(ARCH).reduced()
    jcfg = jpreset("full8", "native").replace(scan_dtype="bf16")
    jm = JSSMLM(acfg, jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    cfg = preset("full8").replace(scan_dtype="bf16")
    tm = build_model(get(ARCH).reduced(), cfg, device="cpu")
    tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05)
    task = TokenTask(acfg.vocab, 32, 4)
    for s in range(3):
        batch = task.batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        loss = float(tstep(topt, batch, s)["loss"])
        jl = float(met["loss"])
        d = np.abs(_codes(lambda k: tm.layers[k].detach().numpy())
                   - _codes(lambda k: params["layers"][k]))
        print(f"step {s + 1}: loss {loss:.6f} vs {jl:.6f} (rel "
              f"{abs(loss - jl) / jl:.3e}), codes differing "
              f"{np.mean(d > 0):.5f}, max distance {d.max():.0f}")
        assert abs(loss - jl) <= 2e-3 * jl
        assert np.mean(d > 0) <= 0.95 and d.max() <= 8192
