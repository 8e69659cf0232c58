"""The port's Mamba2 (SSD) block (repro_torch.models.ssm) against the
reference package's (repro.models.ssm), on the CPU.

Sizes are zamba2-7b.reduced() with scan_chunk 8: d_model 64, d_inner 128
(16 SSD heads of 8 channels), ssm_state N = 4, d_conv 4; a train-mode
sequence of 21 steps runs 3 chunks (the carried state crosses two chunk
boundaries) over 3 steps of zero padding.  The reference's weights come
from `repro.models.ssm.mamba2_init`; every test that runs the quantized
block uses the `exact_pow2` fixture.

Tolerances, and why:
- out_proj's input payload (the Q_A of the gated, normed y): scale equal,
  at most 1% of its codes flipped, by one; the block output within what
  the flipped codes can move plus one rounding of x + out.  The SSD's fp32
  parts are the reference's operations in its order, but three of them
  round differently: XLA's CPU `cumsum` is an associative scan (JAX lowers
  cumsum to one off the TPU) where torch's sums in sequence, XLA's `exp`
  and its fp32 dot orders (the inter-chunk einsum, the state update) are
  not torch's, and XLA's CPU build may fuse a multiply and an add.  So the
  carried state h stays within 2^-20 of max |h| (16 ulps of its largest
  element).  Measured: every output and every payload equal bit for bit,
  h within 2^-22.9 of max |h| over 5 decode steps after a chunk.
- Gradients of the train-mode block (jax.grad against autograd): the four
  projections' gradients are integer dots on both sides and equal bit for
  bit; the rest (the norms' gains, the conv, dt_bias, A_log, D_skip and
  x) are fp32 sums over batch and sequence in another order, whose terms
  can be larger than the sum (ssm_norm's gain sums 42 rows), within 2^-18
  of the leaf's largest |gradient| (measured 2^-19.0 for ssm_norm, at
  most 2^-21.4 for the others).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro_torch.configs import get
from repro_torch.core import preset
from repro_torch.models import ssm as TS

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

CHUNK = 8
DI, DM = 128, 64                     # d_inner, d_model


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def layer():
    """(reference QConfig and ArchConfig, the port's, one layer's
    parameters as numpy) at zamba2-7b.reduced() with scan_chunk 8."""
    ja = jget("zamba2-7b").reduced().replace(scan_chunk=CHUNK)
    ta = get("zamba2-7b").reduced().replace(scan_chunk=CHUNK)
    jq = jpreset("full8", "native")
    lp = jax.tree.map(np.asarray, JS.mamba2_init(jq, ja,
                                                 jax.random.PRNGKey(0)))
    return jq, ja, preset("full8"), ta, lp


def _capture_out_proj(monkeypatch, module, store, key):
    """Record the QTensor that enters out_proj (the (d_inner, d_model)
    qdense) in `module`'s mamba2_block."""
    inner = module.qdense

    def qdense(cfg, x, w, *a, **k):
        if tuple(w.shape) == (DI, DM):
            store[key] = x
        return inner(cfg, x, w, *a, **k)
    monkeypatch.setattr(module, "qdense", qdense)


def _state(r, bsz):
    return {"conv": (r.integers(-200, 200, (bsz, 3, DI)) * 2.0 ** -7
                     ).astype(np.float32),
            "h": (r.standard_normal((bsz, 16, 4, 8)) * 0.5).astype(
                np.float32)}


def _h_close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 2.0 ** -20 * np.abs(
        want).max()


@pytest.mark.parametrize("mode,bsz,s", [("train", 2, 21), ("chunk", 1, 13),
                                        ("decode", 3, 1)])
def test_mamba2_block_against_reference(layer, monkeypatch, exact_pow2,
                                        mode, bsz, s):
    """One block in each mode from the same input and carried state
    ("train" and "chunk" over 2 chunks of 8 with padding): out_proj's
    input payload (scale equal, <= 1% of codes flipped, by one), the
    output within what the flipped codes can move, the new conv window
    equal and h within 2^-20 of max |h|."""
    jq, ja, tq, ta, lp = layer
    cap = {}
    _capture_out_proj(monkeypatch, JS, cap, "ref")
    _capture_out_proj(monkeypatch, TS, cap, "port")
    r = np.random.default_rng(6)
    x = r.standard_normal((bsz, s, DM)).astype(np.float32)
    st = None if mode == "train" else _state(r, bsz)
    out_j, ns_j = JS.mamba2_block(jq, ja, jax.tree.map(jnp.asarray, lp),
                                  jnp.asarray(x), mode,
                                  None if st is None else
                                  jax.tree.map(jnp.asarray, st))
    with torch.no_grad():
        out_t, ns_t = TS.mamba2_block(
            tq, ta, {k: _t(v) for k, v in lp.items()}, _t(x), mode,
            None if st is None else {k: _t(v) for k, v in st.items()})
    pj, pt = cap["ref"], cap["port"]
    assert float(pj.scale) == float(pt.scale)
    dcode = np.abs(np.asarray(pj.data).astype(np.int32)
                   - pt.data.numpy().astype(np.int32))
    assert dcode.max() <= 1 and dcode.mean() <= 0.01
    wq = np.abs(np.round(lp["out_proj"] * 128) / 128)
    out_j = np.asarray(out_j)
    reach = float(pj.scale) * (dcode.reshape(-1, DI) @ wq).reshape(
        out_j.shape) + 2.0 ** -23 * np.abs(out_j)
    assert (np.abs(out_t.numpy() - out_j) <= reach).all()
    np.testing.assert_array_equal(ns_t["conv"].numpy(),
                                  np.asarray(ns_j["conv"]))
    assert tuple(ns_t["h"].shape) == (bsz, 16, 4, 8)
    _h_close(ns_t["h"].numpy(), ns_j["h"])


def test_chunk_then_decode_carries_state(layer, exact_pow2):
    """A chunked-prefill page of 8 steps from the zero state, then 5
    decode steps, each continuing from the state the step before left, in
    both packages: every output equal within the block bound (measured
    bitwise), every conv window equal and every h within 2^-20 of max
    |h|; and the chunk from the zero state equals train mode over the same
    steps bit for bit (the zero window is the zero padding)."""
    jq, ja, tq, ta, lp = layer
    jp = jax.tree.map(jnp.asarray, lp)
    tp = {k: _t(v) for k, v in lp.items()}
    r = np.random.default_rng(7)
    xs = r.standard_normal((1, 13, DM)).astype(np.float32)
    zero = TS.mamba2_state_init(ta, 1)
    jst = {k: jnp.asarray(v.numpy()) for k, v in zero.items()}
    tst = zero
    with torch.no_grad():
        train, tr_st = TS.mamba2_block(tq, ta, tp, _t(xs[:, :8]), "train")
    for t0, t1, mode in [(0, 8, "chunk")] + [(t, t + 1, "decode")
                                             for t in range(8, 13)]:
        oj, jst = JS.mamba2_block(jq, ja, jp, jnp.asarray(xs[:, t0:t1]),
                                  mode, jst)
        with torch.no_grad():
            ot, tst = TS.mamba2_block(tq, ta, tp, _t(xs[:, t0:t1]), mode,
                                      tst)
        if mode == "chunk":
            assert torch.equal(ot, train)
            assert all(torch.equal(tst[k], tr_st[k]) for k in tst)
        oj = np.asarray(oj)
        assert np.abs(ot.numpy() - oj).max() <= 2.0 ** -20 * np.abs(
            oj).max()
        np.testing.assert_array_equal(tst["conv"].numpy(),
                                      np.asarray(jst["conv"]))
        _h_close(tst["h"].numpy(), jst["h"])


def test_train_block_gradients_against_jax_grad(layer, exact_pow2):
    """jax.grad of sum(out * r) for a 21-step train-mode block against
    autograd: in_proj, bc_proj, dt_proj and out_proj bitwise; every other
    leaf and x within 2^-18 of its largest |gradient|."""
    jq, ja, tq, ta, lp = layer
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 21, DM)).astype(np.float32)
    ct = r.standard_normal((2, 21, DM)).astype(np.float32)

    def loss(p, xx):
        out, _ = JS.mamba2_block(jq, ja, p, xx, "train")
        return jnp.sum(out * ct)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, lp),
                                            jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in lp.items()}
    tx = _t(x).requires_grad_()
    out, _ = TS.mamba2_block(tq, ta, tp, tx, "train")
    (out * _t(ct)).sum().backward()
    for k in lp:
        want, got = np.asarray(gp[k]), tp[k].grad.numpy()
        if k in ("in_proj", "bc_proj", "dt_proj", "out_proj"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert np.abs(got - want).max() <= 2.0 ** -18 * np.abs(
                want).max(), k
    want = np.asarray(gx)
    assert np.abs(tx.grad.numpy() - want).max() <= 2.0 ** -18 * np.abs(
        want).max()


def test_init_layouts_and_labels_match_reference(layer):
    """mamba2_init_'s leaves: the reference's names and shapes (at the
    reduced and the full width), its labels, and its formulas' constants
    (unit gains, zero conv bias and A_log, unit D, dt = softplus(dt_bias)
    in [1e-3, 1e-1])."""
    jq, ja, tq, ta, lp = layer
    for acfg, jcfg in ((ta, ja), (get("zamba2-7b"), jget("zamba2-7b"))):
        shapes = jax.eval_shape(lambda k, c=jcfg: JS.mamba2_init(jq, c, k),
                                jax.random.PRNGKey(0))
        assert TS.mamba2_shapes(acfg) == {k: v.shape
                                          for k, v in shapes.items()}
    assert set(TS.MAMBA2_KEYS) == set(lp)
    assert TS.mamba2_labels() == JS.mamba2_labels()
    p = {k: torch.empty(s) for k, s in TS.mamba2_shapes(ta).items()}
    TS.mamba2_init_(tq, ta, p, torch.Generator().manual_seed(0))
    for k in ("ln", "ssm_norm", "D_skip"):
        assert bool((p[k] == 1).all())
    assert not p["conv_b"].any() and not p["A_log"].any()
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 1.1e-1)).all())
    w = p["in_proj"].double() * 2.0 ** (tq.k_wu - 1)    # the k_WU grid
    assert torch.equal(w, torch.round(w))


def test_tensor_parallel_mamba2_refuses(layer):
    _, _, tq, ta, lp = layer
    with pytest.raises(NotImplementedError, match="item 5"):
        TS.mamba2_block(tq, ta, {k: _t(v) for k, v in lp.items()},
                        torch.zeros(1, 1, DM), "decode",
                        TS.mamba2_state_init(ta, 1), tp_size=2)
    with pytest.raises(ValueError, match="mode"):
        TS.mamba2_block(tq, ta, {k: _t(v) for k, v in lp.items()},
                        torch.zeros(1, 1, DM), "bogus")
