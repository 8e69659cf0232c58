"""The port's training step (repro_torch) against the JAX reference.

Same numpy inputs through `repro` (native mode, fused kernels, CPU oracles)
and `repro_torch` (device="cpu", plain versions).  Tolerances:

  threefry PRNGKey / fold_in / uniform: bitwise.
  qeinsum gradients (fused K3 route and unfused route, flag8 and sq16),
  quantizers, momentum_update (every label, dr_bits 8 and 7): bitwise.
  qact backward: silu's derivative takes sigmoid, which XLA and PyTorch
     round differently on the CPU by an ulp: |d| <= 2^-22 * max|d|;
     the identity activation is bitwise.
  qrmsnorm backward: the recomputed statistics are fp32 sums in another
     order and sqrt/mean derivatives round differently: the gradients agree
     within 2^-18 of their largest magnitude.
  The slice (equality kind 3 of the ROADMAP): 5 steps of make_train_step
     from one init, on identical TokenTask batches.  The steps are exact
     until an ulp (exp, sigmoid, the UBN sums, the fp32 lm_head product)
     tips one pow2 error scale R(amax) or one stochastic-rounding
     comparison; from there the trajectories separate as two runs of the
     reference under two compilers would.  Bounds per preset: the loss of
     every step within 2e-3 relative; after step 1 the hidden weights'
     k_WU-grid codes equal on all but 0.1%, at most 26 codes apart (one CQ
     step times lr = 26 * 2^-9); after step 5 at most `share` of the codes
     differ, by at most `dist` codes (full8's flag-format error is the
     coarser, so its trajectories separate faster).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.core.qdense import qeinsum as jqeinsum
from repro.core.qtensor import QTensor as JQT
from repro.data import TokenTask as JTask
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import MomentumState as JState
from repro.optim import init_momentum as jinit_momentum
from repro.optim import momentum_update as jmomentum_update
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, params_from_jax
from repro_torch.core import prng, preset, qact, qrmsnorm
from repro_torch.core.qdense import qeinsum
from repro_torch.core.qtensor import QTensor, get_quantizer
from repro_torch.data import TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import MomentumState, flatten, momentum_update

from torch_parity import exact_pow2  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# threefry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 7, 123456])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (4, 64, 97)])
def test_threefry_uniform_bitwise(step, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(17), step)
    key = prng.fold_in(prng.prng_key(17), step)
    assert key == tuple(np.asarray(jkey).tolist())
    for leaf in (0, 11):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(jkey, 1), leaf), shape))
        got = prng.uniform(prng.fold_in(prng.fold_in(key, 1), leaf),
                           shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_uniform_flat_slices_compose():
    key = prng.fold_in(prng.prng_key(17), 3)
    full = prng.uniform(key, (1000,))
    parts = torch.cat([prng.uniform_flat(key, i, 250) for i in
                       range(0, 1000, 250)])
    assert torch.equal(full, parts)


# --------------------------------------------------------------------------
# quantizers and configuration
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,k", [("sq", 8), ("sq", 16), ("flag", 8),
                                    ("none", 16), ("scaled", 8)])
def test_quantizers_bitwise(kind, k, exact_pow2):
    from repro.core.qtensor import get_quantizer as jget_quantizer
    x = (np.random.default_rng(k).standard_normal((9, 40)) * 0.02).astype(
        np.float32)
    jq, tq = jget_quantizer(kind, k), get_quantizer(kind, k)
    want, got = jq.quantize(jnp.asarray(x)), tq.quantize(_t(x))
    for (a, sa), (b, sb) in zip(got.planes(), want.planes()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(sa) == float(sb)
    np.testing.assert_array_equal(tq(_t(x)).numpy(),
                                  np.asarray(jq(jnp.asarray(x))))
    jp, tp = jq.fused_plan(jnp.asarray(x)), tq.fused_plan(_t(x))
    assert jp[0] == tp[0] and jp[2] == tp[2]
    assert [float(s) for s in jp[1]] == [float(s) for s in tp[1]]


@pytest.mark.parametrize("dr_bits", [8, 7])
def test_cq_bitwise(dr_bits, exact_pow2):
    from repro.core import qfuncs as jqf
    from repro_torch.core import qfuncs
    g = (np.random.default_rng(dr_bits).standard_normal((3, 17, 29))
         * 1e-3).astype(np.float32)
    want = jqf.cq(jnp.asarray(g), jax.random.fold_in(
        jax.random.PRNGKey(17), 4), dr_bits, 15)
    got = qfuncs.cq(_t(g), prng.fold_in(prng.prng_key(17), 4), dr_bits, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_presets_match_reference(name):
    j, t = jpreset(name, "native"), preset(name)
    for f in ("k_w", "k_a", "k_e1", "k_e2", "k_gw", "k_gc", "k_ggamma",
              "k_gbeta", "k_mom", "k_acc", "k_lr", "k_wu", "e2_kind",
              "e_attn_kind", "stochastic_g", "norm_full_bwd"):
        assert getattr(j, f) == getattr(t, f), f
    for f in ("w", "a", "e1", "e2", "e_attn", "g"):
        assert (getattr(j, f).kind, getattr(j, f).k) == \
            (getattr(t, f).kind, getattr(t, f).k), f


# --------------------------------------------------------------------------
# qeinsum / qact / qrmsnorm gradients
# --------------------------------------------------------------------------

SPECS = {"fused": ("mk,kn->mn", (24, 40), (40, 56), True),
         "unfused": ("bskgd,btkd->bskgt", (1, 8, 2, 2, 16), (1, 12, 2, 16),
                     False)}


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_qeinsum_grads_bitwise(route, name, exact_pow2):
    spec, sha, shb, b_weight = SPECS[route]
    r = np.random.default_rng(len(spec) + len(name))
    a8 = r.integers(-127, 128, sha).astype(np.int8)
    b8 = r.integers(-127, 128, shb).astype(np.int8)
    sa, sb = 2.0 ** -5, 2.0 ** -7
    jcfg, cfg = jpreset(name, "native"), preset(name)

    def jfn(ac, bc):
        return jqeinsum(jcfg, spec, "default", b_weight,
                        JQT(jnp.asarray(a8), jnp.float32(sa), 8, carrier=ac),
                        JQT(jnp.asarray(b8), jnp.float32(sb), 8, carrier=bc))

    ac, bc = a8.astype(np.float32) * sa, b8.astype(np.float32) * sb
    y, vjp = jax.vjp(jfn, jnp.asarray(ac), jnp.asarray(bc))
    ct = (r.standard_normal(y.shape) * 0.01).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(ct))

    tac, tbc = _t(ac).requires_grad_(), _t(bc).requires_grad_()
    ty = qeinsum(cfg, spec, "default", b_weight,
                 QTensor(_t(a8), torch.tensor(sa), 8, carrier=tac),
                 QTensor(_t(b8), torch.tensor(sb), 8, carrier=tbc))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(_t(ct))
    np.testing.assert_array_equal(tac.grad.numpy(), np.asarray(jda))
    np.testing.assert_array_equal(tbc.grad.numpy(), np.asarray(jdb))


def test_qeinsum_raw_operand_grads_bitwise(exact_pow2):
    """A raw fp32 operand is grid-decomposed once; its gradient lands on
    the array itself (the reference's "arr" tag)."""
    from repro.core import qdense as jqdense
    from repro_torch.core import qdense
    r = np.random.default_rng(9)
    x = (r.standard_normal((6, 32)) * 2).astype(np.float32)
    w = np.clip(np.round(r.standard_normal((32, 24)) / 6 * 2 ** 23)
                / 2 ** 23, -0.99, 0.99).astype(np.float32)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    y, vjp = jax.vjp(lambda a, b: jqdense(jcfg, a, b), jnp.asarray(x),
                     jnp.asarray(w))
    ct = (r.standard_normal(y.shape) * 0.1).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(ct))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    qdense(cfg, tx, tw).backward(_t(ct))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jdw))


@pytest.mark.parametrize("act", ["none", "silu"])
def test_qact_backward_within_ulps(act, exact_pow2):
    from repro.core import qact as jqact
    r = np.random.default_rng(10)
    x = (r.standard_normal((6, 40)) * 3).astype(np.float32)
    ct = (r.standard_normal((6, 40)) * 0.01).astype(np.float32)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    _, vjp = jax.vjp(lambda t: jqact(jcfg, act, t).carrier, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = _t(x).requires_grad_()
    qact(cfg, act, tx).carrier.backward(_t(ct))
    got = tx.grad.numpy()
    if act == "none":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -22 * np.abs(want).max()


def test_qrmsnorm_backward_within_ulps(exact_pow2):
    from repro.core import qrmsnorm as jqrmsnorm
    r = np.random.default_rng(11)
    x = (r.standard_normal((2, 8, 64)) * 0.5).astype(np.float32)
    gam = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    ct = (r.standard_normal(x.shape) * 0.01).astype(np.float32)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    _, vjp = jax.vjp(lambda a, b: jqrmsnorm(jcfg, a, b), jnp.asarray(x),
                     jnp.asarray(gam))
    jdx, jdg = (np.asarray(t) for t in vjp(jnp.asarray(ct)))
    tx, tg = _t(x).requires_grad_(), _t(gam).requires_grad_()
    qrmsnorm(cfg, tx, tg).backward(_t(ct))
    for got, want in ((tx.grad.numpy(), jdx), (tg.grad.numpy(), jdg)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        print(f"qrmsnorm grad: max |d| = {rel:.3e} of max |grad| "
              f"(bound 2^-18 = {2.0 ** -18:.3e})")
        assert rel <= 2.0 ** -18


# --------------------------------------------------------------------------
# quantized Momentum
# --------------------------------------------------------------------------


def _opt_tree(r):
    def w(shape):
        return np.clip(np.round(r.standard_normal(shape) * 0.05 * 2 ** 23)
                       / 2 ** 23, -0.99, 0.99).astype(np.float32)
    params = {"embed": w((16, 8)), "final_norm": np.ones(8, np.float32),
              "layers": {"ln1": w((2, 8)) + 1.0, "wq": w((2, 8, 12)),
                         "w_up": w((2, 8, 20))},
              "lm_head": w((8, 16))}
    labels = {"embed": "exempt", "final_norm": "gamma",
              "layers": {"ln1": "gamma", "wq": "w", "w_up": "w"},
              "lm_head": "exempt"}
    tmap = jax.tree.map
    grads = tmap(lambda p: (r.standard_normal(p.shape) * 1e-3).astype(
        np.float32), params)
    acc = tmap(lambda p: (np.round(r.standard_normal(p.shape) * 2 ** 6)
                          / 2 ** 12).astype(np.float32), params)
    return params, grads, acc, labels


@pytest.mark.parametrize("dr_bits", [8, 7])
def test_momentum_update_bitwise(dr_bits, exact_pow2):
    """Eager JAX (op by op, so nothing contracts into an FMA) against the
    port, from the same params, grads, accumulator and key."""
    params, grads, acc, labels = _opt_tree(np.random.default_rng(dr_bits))
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    lr = 26.0 / 512
    key = jax.random.fold_in(jax.random.PRNGKey(17), 5)
    jp, js = jmomentum_update(
        jcfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        JState(acc=jax.tree.map(jnp.asarray, acc), step=jnp.int32(0)),
        labels, key, lr, dr_bits=dr_bits)
    tmap = jax.tree.map
    tp, tg = tmap(_t, params), tmap(_t, grads)
    st = MomentumState(acc=tmap(_t, acc))
    momentum_update(cfg, tp, tg, st, labels,
                    prng.fold_in(prng.prng_key(17), 5), lr, dr_bits=dr_bits)
    labs = flatten(labels)
    assert set(labs) == {"w", "gamma", "exempt"}
    for got, want, lab in zip(flatten(tp), jax.tree.leaves(jp), labs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), lab)
    for got, want, lab in zip(flatten(st.acc), jax.tree.leaves(js.acc),
                              labs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), lab)
    assert st.step == 1


def test_leaf_order_is_jax_flatten_order():
    acfg = jget("granite-3-8b").reduced()
    jm = jbuild(acfg, jpreset("full8", "native"))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = build_model(get("granite-3-8b").reduced(), preset("full8"),
                     device="meta")
    assert [tuple(x.shape) for x in flatten(tm.params())] == \
        [x.shape for x in jax.tree.leaves(jparams)]
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(jparams))


def test_token_task_equals_reference():
    for kind in ("arith", "uniform"):
        a = TokenTask(100, 16, 4, kind=kind, seed=3).batch(5, 1, 2)
        b = JTask(100, 16, 4, kind=kind, seed=3).batch(5, 1, 2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# the slice: 5 training steps against the reference
# --------------------------------------------------------------------------

HIDDEN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BOUNDS = {"full8": dict(share=0.95, dist=8192),
          "e2_16": dict(share=0.01, dist=1024)}


def _codes(get_w) -> np.ndarray:
    return np.concatenate([np.asarray(get_w(k), np.float64).ravel() * 2 ** 23
                           for k in HIDDEN])


@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_train_slice_within_bounds(name, exact_pow2):
    acfg = jget("granite-3-8b").reduced()
    jcfg = jpreset(name, "native")
    jm = jbuild(acfg, jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    cfg = preset(name)
    tm = build_model(get("granite-3-8b").reduced(), cfg, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05)
    task = TokenTask(acfg.vocab, 32, 4)
    b = BOUNDS[name]
    for s in range(5):
        batch = task.batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        loss = float(tstep(topt, batch, s)["loss"])
        rel = abs(loss - float(met["loss"])) / float(met["loss"])
        d = np.abs(_codes(lambda k: params["layers"][k])
                   - _codes(lambda k: tm.layers[k].detach().numpy()))
        share, dist = float(np.mean(d > 0)), float(d.max())
        print(f"{name} step {s + 1}: loss rel {rel:.3e} (bound 2e-3), "
              f"codes differing {share:.5f}, max distance {dist:.0f}")
        assert rel <= 2e-3
        if s == 0:
            assert share <= 1e-3 and dist <= 26, (share, dist)
        if s == 4:
            assert share <= b["share"] and dist <= b["dist"], (share, dist)


def test_train_cli_runs_on_cpu(capsys):
    ttrain.main(["--arch", "granite-3-8b", "--reduced", "--mode", "native",
                 "--steps", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu", "--dr-boundaries", "1"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "CQ dr width -> 7 bits" in out


@pytest.mark.parametrize("argv,item", [
    (["--mode", "sim"], "item 7"), (["--mode", "fp32"], "item 7"),
    (["--preset", "w4a8"], "item 7"), (["--preset", "a4"], "item 7"),
    (["--preset", "g16"], "item 7"), (["--preset", "fp32"], "item 7"),
    (["--dp", "2"], "item 5"), (["--tp", "2"], "item 5"),
    (["--elastic"], "item 5"), (["--ckpt-dir", "ck"], "item 1"),
    (["--resume"], "item 1")])
def test_unported_training_options_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(["--arch", "granite-3-8b", "--reduced", "--steps", "1",
                     "--device", "cpu", *argv])


def test_microbatching_raises():
    tm = build_model(get("granite-3-8b").reduced(), preset("full8"),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        ttrain.make_train_step(tm, preset("full8"), n_micro=2)


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "granite-3-8b", "--reduced", "--steps", "1"])
