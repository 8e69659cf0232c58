"""The port's Mamba1 training (repro_torch: K9b's plain version, the scan's
gradient, mamba1_block in train mode, SSMLM.loss and make_train_step)
against the reference package's, on the CPU.

Sizes are falcon-mamba-7b.reduced() (2 layers, d_model 64, d_inner 128,
N 4, vocab 128) for the model, and the scan shapes listed below.  Inputs
are made from seeded numpy generators; every test that runs the quantized
model uses the `exact_pow2` fixture.

Tolerances, and why:
- The scan's backward.  The port reverses the recurrence step by step
  (ref.selective_scan_bwd: dy * c, + the carry, and a * g each round
  once); the reference differentiates its chunked associative scan
  (`jax.vjp` of `_sscan_chunked`).  The same function associated
  differently, so a normwise bound as the forward's in
  tests/test_torch_ssm.py, with G the reverse recurrence on absolute
  values, G_t = |a_{t+1}| G_{t+1} + |dy_t| |c_t|, G_S = |dh_last|, and M
  the forward's (M_t = |a_t| M_{t-1} + |b_t|, M_{-1} = |h0|):
      |ddb_t| <= K_G U G_t,            |dda_t| <= (K_G + K_H + 1) U G_t M_{t-1},
      |ddh0| <= (K_G + 1) U |a_0| G_0, |ddc_t| <= (K_H + D + 1) U sum_d |dy_t| M_t,
  with U = 2^-24, K_H = 2 + 2 log2(c) + 2 the forward h's rounding count
  (tests/test_torch_ssm.py) and K_G = 3 + 2 log2(c) + 3 the gradient's
  (the port's three roundings a step, the reference's reversed tree over
  a chunk of c and its product), and D for the reference's fp32 sum over
  the channels in dc.  Measured at most 5.6 (db), 6.3 (da), 1.8 (dc) and
  4.3 (dh0) against bounds of 14 to 27.
- Finite differences: torch.autograd.gradcheck in float64 (its own
  default tolerances) on the plain forward and backward.
- The block and the model.  Every quantized weight's gradient is an int32
  dot times pow2 scales (K3's plain version against the reference's K3
  oracle): measured equal.  The other leaves (norm gains, the exempt
  embedding, head, dt_bias, A_log, the conv) sit behind fp32 sums in
  another order (the scan and its reverse, the conv's taps, XLA's fp32
  contractions): every leaf within 2^-18 of its largest magnitude
  (measured 2^-21.6), the loss within 2^-20 relative.
- Five steps (full8, e2_16) as the LM's in tests/test_torch_train.py: the
  steps are exact until an ulp tips one pow2 error scale or one
  stochastic-rounding comparison; the loss within 2e-3 relative at every
  step, and the share of the hidden weights' k_WU-grid codes that differ
  and their largest distance after steps 1 and 5 within the reference's
  own spread under a one-ulp change of its backbone's output error, plus
  the LM's step-1 bound (the test's docstring gives the readings).
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, ssm_params_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import ssm as TS
from repro_torch.optim import flatten

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

U = 2.0 ** -24
ARCH = "falcon-mamba-7b"


def _t(x):
    return torch.tensor(np.asarray(x))


def _scan_inputs(b, s, d, n, seed):
    """The model's scan inputs (as tests/test_torch_ssm.py makes them), and
    a gradient dy ~ N(0, 1) and dh_last ~ N(0, 1)."""
    r = np.random.default_rng(seed)
    dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (b, s, d)))
    a = np.exp(dt[..., None] * -np.arange(1, n + 1)).astype(np.float32)
    bb = (r.standard_normal((b, s, d, n)) * 0.1).astype(np.float32)
    c = r.standard_normal((b, s, n)).astype(np.float32)
    h0 = r.standard_normal((b, d, n)).astype(np.float32)
    dy = r.standard_normal((b, s, d)).astype(np.float32)
    dh = r.standard_normal((b, d, n)).astype(np.float32)
    return a, bb, c, h0, dy, dh


def _norms(a, b, c, h0, dy, dh):
    """M_{t-1}, M_t (B, S, D, N) and G_t (B, S, D, N) in float64."""
    a, b, c, dy = (x.astype(np.float64) for x in (a, b, c, dy))
    bsz, s, d, n = a.shape
    m = np.zeros((bsz, d, n)) if h0 is None else np.abs(h0.astype(
        np.float64))
    mp, mt = np.zeros(a.shape), np.zeros(a.shape)
    for t in range(s):
        mp[:, t] = m
        m = np.abs(a[:, t]) * m + np.abs(b[:, t])
        mt[:, t] = m
    g = np.zeros((bsz, d, n)) if dh is None else np.abs(dh.astype(
        np.float64))
    gs = np.zeros(a.shape)
    for t in range(s - 1, -1, -1):
        g = g + np.abs(dy[:, t, :, None] * c[:, t, None, :])
        gs[:, t] = g
        g = np.abs(a[:, t]) * g
    return mp, mt, gs


def _within(got, want, scale, bound, what):
    k = float((np.abs(got.astype(np.float64) - want)
               / np.maximum(U * scale, 1e-300)).max())
    print(f"{what}: {k:.3f} x 2^-24 of the norm (bound {bound:.1f})")
    assert k <= bound, f"{what}: {k:.3f} * 2^-24 of the norm > {bound}"


# --------------------------------------------------------------------------
# the scan's backward
# --------------------------------------------------------------------------

# (shape, chunk, with h0, with dh_last): N 4 and 16, S ragged against the
# chunk (37, 33, 70 against 16) or shorter than it (256), every pairing of
# h0 and dh_last at both N
BWD_CASES = [((1, 16, 8, 4), 16, False, False),
             ((2, 37, 24, 4), 16, True, True),
             ((2, 37, 24, 4), 256, True, False),
             ((1, 16, 8, 4), 256, False, True),
             ((2, 33, 10, 16), 16, False, True),
             ((2, 33, 10, 16), 256, True, True),
             ((1, 70, 40, 16), 16, True, False),
             ((1, 70, 40, 16), 256, False, False)]


@pytest.mark.parametrize("shape,chunk,with_h0,with_dh", BWD_CASES)
def test_scan_bwd_against_reference_vjp(shape, chunk, with_h0, with_dh):
    """ref.selective_scan_bwd against jax.vjp of the reference's
    `_sscan_chunked`, S ragged against the chunk, with and without h0 and
    dh_last, within the normwise bound."""
    a, b, c, h0, dy, dh = _scan_inputs(*shape, seed=sum(shape) + chunk)
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    jh0 = jnp.zeros(shape[:1] + shape[2:]) if h0 is None else jnp.asarray(h0)
    _, vjp = jax.vjp(lambda a_, b_, c_, h_: JS._sscan_chunked(
        a_, b_, c_, h_, chunk), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(c), jh0)
    jdh = jnp.zeros_like(jh0) if dh is None else jnp.asarray(dh)
    wa, wb, wc, wh0 = (np.asarray(x) for x in vjp((jnp.asarray(dy), jdh)))
    da, db, dc, dh0 = ref.selective_scan_bwd(
        _t(a), _t(b), _t(c), _t(dy), None if h0 is None else _t(h0),
        None if dh is None else _t(dh))
    mp, mt, gs = _norms(a, b, c, h0, dy, dh)
    lc = 2 * np.log2(min(chunk, shape[1]))
    kh, kg = 4 + lc, 6 + lc
    _within(db.numpy(), wb, gs, kg, "db")
    _within(da.numpy(), wa, gs * mp, kg + kh + 1, "da")
    dcn = (np.abs(dy.astype(np.float64))[..., None] * mt).sum(2)
    _within(dc.numpy(), wc, dcn, kh + shape[2] + 1, "dc")
    if h0 is None:
        assert dh0 is None
    else:
        _within(dh0.numpy(), wh0, np.abs(a[:, 0]) * gs[:, 0], kg + 1, "dh0")


def test_scan_bwd_finite_differences():
    """gradcheck in float64 through ops.selective_scan's autograd Function
    (the plain forward and ref.selective_scan_bwd on CPU tensors): with
    and without h0, over ragged dc tiles (D 3 of 128 at N 4, D 9 of 32 at
    N 16)."""
    r = np.random.default_rng(5)
    for shape in ((2, 5, 3, 4), (1, 3, 9, 16)):
        b_, s, d, n = shape
        a = torch.tensor(r.uniform(0.4, 0.9, shape), requires_grad=True)
        bb = torch.tensor(r.standard_normal(shape) * 0.1, requires_grad=True)
        c = torch.tensor(r.standard_normal((b_, s, n)), requires_grad=True)
        h0 = torch.tensor(r.standard_normal((b_, d, n)), requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda *x: ops.selective_scan(*x), (a, bb, c, h0))
        assert torch.autograd.gradcheck(
            lambda *x: ops.selective_scan(*x)[0], (a, bb, c))


def test_scan_bwd_numerics_are_the_kernels():
    """The plain backward's arithmetic spelled out: the carry and each
    product rounded once in fp32, and dc's float64 sum in the stated
    group, tile and tile-sum order (D 40 at N 16: 2 tiles of 4 groups of
    8, the second padded with zero products)."""
    a, b, c, h0, dy, dh = (_t(x) for x in _scan_inputs(2, 9, 40, 16, 6))
    da, db, dc, dh0 = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    hs, h = [], h0.clone()
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    g = dh.clone()
    for t in range(8, -1, -1):
        g = g + dy[:, t, :, None] * c[:, t, None, :]
        assert torch.equal(db[:, t], g)
        assert torch.equal(da[:, t], g * (hs[t - 1] if t else h0))
        g = a[:, t] * g
    assert torch.equal(dh0, g)
    assert ref.scan_dc_groups(16) == (8, 4) and ref.scan_dc_groups(4) == (
        32, 4)
    pad = torch.zeros(2, 9, 24, 16)
    hp = torch.cat([torch.stack(hs, 1), pad], 2).double()
    dyp = torch.cat([dy, pad[..., 0]], 2).double()
    for t in range(9):
        tot = None
        for tile in range(2):
            tsum = None
            for grp in range(4):
                gsum = None
                for j in range(8):
                    ch = tile * 32 + grp * 8 + j
                    p = dyp[:, t, ch, None] * hp[:, t, ch]
                    gsum = p if gsum is None else gsum + p
                tsum = gsum if tsum is None else tsum + gsum
            tot = tsum if tot is None else tot + tsum
        assert torch.equal(dc[:, t], tot.float())


def test_scan_gradient_routes_and_counts():
    """CPU tensors take the plain backward (no launch counted); without
    autograd the op is the forward alone; an N the kernel lacks raises on
    the op's checks only on the card, so here it runs the plain version."""
    ops.reset_launches()
    a, b, c, h0, dy, dh = (_t(x) for x in _scan_inputs(1, 6, 8, 4, 7))
    want = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    got = ops.selective_scan_bwd(a, b, c, dy, h0, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    a.requires_grad_()
    y, h = ops.selective_scan(a, b, c, h0)
    assert y.grad_fn is not None
    torch.autograd.backward((y, h), (dy, dh))
    assert torch.equal(a.grad, want[0])
    with torch.no_grad():
        assert ops.selective_scan(a, b, c, h0)[0].grad_fn is None
    assert ops.LAUNCHES["selective_scan_bwd"] == 0


# --------------------------------------------------------------------------
# the block and the model against jax.grad
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    ja = jget(ARCH).reduced()
    jq = jpreset("full8", "native")
    jm = JSSMLM(ja, jq)
    params = jm.init(jax.random.PRNGKey(0))
    return jq, ja, jm, params


def _port_model(params):
    tm = build_model(get(ARCH).reduced(), preset("full8"), device="cpu")
    return tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))


def _leaves_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        gap = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= 2.0 ** -18, f"{what} leaf {i}: {gap:.3e}"


def test_mamba1_block_train_gradients(models, exact_pow2):
    """One block in train mode: the gradients of sum(out * R) with respect
    to every parameter and to x, against jax.grad of the reference's
    block.  conv_w's gradient reaches it through qweight's STE, and the
    scan's inputs reach the conv through qt_carrier(xq)."""
    jq, ja, _, params = models
    lp = jax.tree.map(lambda v: v[1], params["layers"])
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 21, 64)).astype(np.float32)
    proj = r.standard_normal((2, 21, 64)).astype(np.float32)

    def jloss(p, x_):
        out, _ = JS.mamba1_block(jq, ja, p, x_, "train")
        return jnp.sum(out * proj)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(lp, jnp.asarray(x))
    tm = _port_model(params)
    tp = {k: _t(v).requires_grad_() for k, v in lp.items()}
    tx = _t(x).requires_grad_()
    out, _ = TS.mamba1_block(tm.q, tm.a, tp, tx, "train")
    torch.sum(out * _t(proj)).backward()
    keys = sorted(tp)
    assert all(float(tp[k].grad.abs().max()) > 0 for k in keys)
    _leaves_close([tp[k].grad for k in keys] + [tx.grad],
                  [jgp[k] for k in keys] + [jgx], "block")


def test_ssmlm_loss_and_gradients(models, exact_pow2):
    """SSMLM.loss (embedding, the backbone in train mode, logits,
    logsumexp minus the label's logit, mean) and the gradient of every
    leaf against the reference's loss under jax.grad; params() is the
    reference's tree in JAX flatten order."""
    _, _, jm, params = models
    r = np.random.default_rng(9)
    batch = {"tokens": r.integers(0, 128, (2, 21)).astype(np.int32),
             "labels": r.integers(0, 128, (2, 21)).astype(np.int32)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tm = _port_model(params)
    loss, met = tm.loss(batch)
    assert set(met) == set(jmet) == {"loss"}
    assert abs(float(loss.detach()) - float(jl)) <= 2.0 ** -20 * float(jl)
    loss.backward()
    leaves = flatten(tm.params())
    assert [tuple(p.shape) for p in leaves] == [
        x.shape for x in jax.tree.leaves(params)]
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(params))
    assert all(p.grad is not None for p in leaves)
    _leaves_close([p.grad for p in leaves], jax.tree.leaves(jg), "loss")


# --------------------------------------------------------------------------
# five training steps against the reference
# --------------------------------------------------------------------------

HIDDEN = ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj")
# What the port may add to the reference's own spread, after step 1 and
# after step 5: the LM's step-1 bound (tests/test_torch_train.py), 0.1% of
# the codes, 26 apart.
SLACK = (1e-3, 26)


def _codes(get_w) -> np.ndarray:
    return np.concatenate([np.asarray(get_w(k), np.float64).ravel() * 2 ** 23
                           for k in HIDDEN])


def _one_ulp(jm) -> None:
    """Move the error that reaches jm's backbone output one ulp up in 4 of
    every 7 elements (by flat index); the forward is unchanged.  The port's
    error there differs from the reference's by that much: the head's fp32
    contraction and the final norm's sums run in another order."""
    logits = jm._logits

    @jax.custom_vjp
    def ulp(x):
        return x

    def bwd(_, g):
        i = jnp.arange(g.size, dtype=jnp.uint32).reshape(g.shape)
        return (jnp.where(i * jnp.uint32(40503) % 7 < 4,
                          jnp.nextafter(g, jnp.inf), g),)

    ulp.defvjp(lambda x: (x, None), bwd)
    jm._logits = lambda params, x: logits(params, ulp(x))


def _ref_trajectory(name, batches, ulp=False):
    """The reference's make_train_step from PRNGKey(0) over `batches`:
    (initial params, initial optimizer state, per step (loss, codes))."""
    acfg = jget(ARCH).reduced()
    jcfg = jpreset(name, "native")
    jm = JSSMLM(acfg, jcfg)
    if ulp:
        _one_ulp(jm)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    init = (params, jopt)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    out = []
    for s, batch in enumerate(batches):
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        out.append((float(met["loss"]),
                    _codes(lambda k: params["layers"][k])))
    return init, out


def _gap(a, b) -> tuple[float, float, float]:
    """(loss's relative gap, share of codes that differ, largest distance)
    of two steps' (loss, codes)."""
    d = np.abs(a[1] - b[1])
    return abs(a[0] - b[0]) / b[0], float(np.mean(d > 0)), float(d.max())


@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_ssm_train_slice_within_bounds(name, exact_pow2):
    """make_train_step of both packages from the same weights over 5
    TokenTask batches of 4 x 32: per step the loss's relative gap (within
    2e-3), the share of the hidden weights' k_WU-grid codes that differ
    and their largest distance.  After steps 1 and 5 the port lands no
    farther from the reference than the reference lands from itself when
    the error at its backbone output moves one ulp (`_one_ulp`), plus
    SLACK.

    Measured on the CPU: full8 is equal at every step, and so is the
    reference against itself.  e2_16 differs in 1.500% of the codes, 104
    apart, after step 1 and in 94.94%, 4576 apart, after step 5; the
    reference against itself in 1.502%, 104, and 94.94%, 4576.  The
    spread is the model's, not the scan's: with the port's scan gradient
    replaced by jax.vjp's of `_sscan_chunked` the port still read 1.500%,
    104.  The head's ulps flip about 1 in 10^4 of the 8-bit error codes at
    the scan's output, and the reverse scan and dc's sum over the channels
    carry each flip to every earlier position and every channel, where
    e2_16's 16-bit grid resolves it (full8's 8-bit grid does not)."""
    task = TokenTask(jget(ARCH).reduced().vocab, 32, 4)
    batches = [task.batch(s) for s in range(5)]
    (params, jopt), ref = _ref_trajectory(name, batches)
    _, own = _ref_trajectory(name, batches, ulp=True)
    cfg = preset(name)
    tm = build_model(get(ARCH).reduced(), cfg, device="cpu")
    tm.load_params(ssm_params_from_jax(jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05)
    gaps = []
    for s, batch in enumerate(batches):
        loss = float(tstep(topt, batch, s)["loss"])
        gaps.append(_gap((loss, _codes(lambda k: tm.layers[k].detach()
                                       .numpy())), ref[s]))
        print(f"{name} step {s + 1}: loss rel {gaps[-1][0]:.3e} (bound "
              f"2e-3), codes differing {gaps[-1][1]:.5f}, max distance "
              f"{gaps[-1][2]:.0f}; the reference against itself "
              f"{_gap(own[s], ref[s])}")
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    for s in (0, 4):
        _, share, dist = _gap(own[s], ref[s])
        assert gaps[s][1] <= share + SLACK[0], (s + 1, gaps[s], share)
        assert gaps[s][2] <= max(dist, SLACK[1]), (s + 1, gaps[s], dist)


# --------------------------------------------------------------------------
# the rest of training: the CLI, resume
# --------------------------------------------------------------------------


def test_ssm_train_cli_save_and_resume(capsys, tmp_path):
    """The CLI trains falcon-mamba-7b (reduced) on the CPU; --save-every 2
    over 4 steps against 2 steps and then --resume to 4: the step-4
    checkpoints are equal bit for bit."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--save-every", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttrain.main(argv + ["--steps", "4", "--ckpt-dir", a])
    out = capsys.readouterr().out
    assert f"[train] {ARCH}-smoke full8/native on cpu" in out
    assert "step     3 loss" in out
    ttrain.main(argv + ["--steps", "2", "--ckpt-dir", b])
    assert "resumed" not in capsys.readouterr().out
    ttrain.main(argv + ["--steps", "4", "--ckpt-dir", b, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     1 loss" not in out
    for d in (a, b):
        assert CheckpointManager(d).all_steps() == [2, 4]
    with np.load(f"{a}/step-0000000004/arrays.npz") as x, \
            np.load(f"{b}/step-0000000004/arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert any("conv_b" in k for k in x.files)
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("name", ["w4a8", "a4", "g16"])
def test_ssm_presets_and_microbatching_run(name):
    """The bit-width presets and n_micro go through the same step for the
    SSM: one finite step each; n_micro=2 on a batch of 4 gives the mean of
    its microbatches' losses."""
    cfg = preset(name)
    tm = build_model(get(ARCH).reduced(), cfg, device="cpu").init(0)
    from repro_torch.optim import init_momentum
    opt = init_momentum(tm.params())
    batch = TokenTask(tm.a.vocab, 16, 4).batch(0)
    met = ttrain.make_train_step(tm, cfg, n_micro=2)(opt, batch, 0)
    assert opt.step == 1 and np.isfinite(float(met["loss"]))
