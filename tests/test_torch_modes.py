"""The port's sim and fp32 numeric modes against the JAX reference: the
configuration, the quantized ops, the optimizer, the CLI and checkpoints.

Same numpy inputs through `repro` (eager, CPU) and `repro_torch`
(device="cpu", plain versions).  Tolerances:

  QConfig / preset(name, mode): every field equal, for every preset and
     mode; the one divergence is the default mode (the port's "native",
     the reference's "sim"), tested by name.
  qact, qdense, qeinsum, qconv forwards on grid values: bitwise (every fp32
     partial sum is exact: K * 127^2 < 2^24).  A zero may differ in sign
     (sim takes the grid value from the payload, the reference from its
     formula), which `assert_array_equal` counts as equal.
  qact backward: relu and the identity bitwise; silu within 2^-22 of the
     largest magnitude (sigmoid rounds differently in XLA and PyTorch).
  qeinsum / qconv gradients: the Q_E2 grid values times grid operands are
     no longer exact sums, so the two libraries' summation orders differ:
     within ULPS ulps of the largest magnitude of the gradient.
  qrmsnorm / qbatchnorm / qlayernorm: sim forwards within the K4 row
     tolerance (`ubn_rows_ok`: a statistic summed in another order lands
     one k_sigma step away on at most 5% of the rows), fp32 forwards
     within 2^-20 of the largest magnitude; gradients within 2^-18 of the
     largest magnitude, as the native qrmsnorm test states.
  momentum_update in sim and fp32: bitwise; fp32 is vanilla Momentum.
  fp32 checkpoints: bitwise across the two packages, both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import get as jget
from repro.core import PRESETS as JPRESETS
from repro.core import QConfig as JQConfig
from repro.core import preset as jpreset
from repro.core import qact as jqact
from repro.core import qbatchnorm as jqbatchnorm
from repro.core import qconv as jqconv
from repro.core import qdense as jqdense
from repro.core import qlayernorm as jqlayernorm
from repro.core import qrmsnorm as jqrmsnorm
from repro.core import qweight as jqweight
from repro.core.qdense import qeinsum as jqeinsum
from repro.data import TokenTask as JTokenTask
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import MomentumState as JState
from repro.optim import init_momentum as jinit_momentum
from repro.optim import momentum_update as jmomentum_update
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, params_from_jax
from repro_torch.core import (FP32, PRESETS, QConfig, preset, qact,
                              qbatchnorm, qconv, qdense, qlayernorm,
                              qrmsnorm, qweight)
from repro_torch.core.qdense import qeinsum
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.layers import winit_
from repro_torch.optim import (MomentumState, fixed_point_lr, flatten,
                               init_momentum, momentum_update)
from repro_torch.optim.momentum import _mom_coeff

from torch_parity import (exact_pow2, one_torch_thread,  # noqa: F401
                          ubn_rows_ok)

MODES = ("fp32", "sim", "native")
# qeinsum / qconv gradients: ulps of the gradient's largest magnitude
ULPS = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _ulps(got, want) -> float:
    """max |got - want| in ulps of max |want|."""
    want = np.asarray(want)
    return float(np.abs(got - want).max()
                 / np.spacing(np.float32(np.abs(want).max())))


def _grid(r, shape, step, lim=127):
    return (r.integers(-lim, lim + 1, shape) * step).astype(np.float32)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


def _fields(cfg) -> dict:
    """The port's QConfig fields of `cfg` (either package's), a QuantSpec
    as its (kind, k, params)."""
    def value(v):
        return dataclasses.astuple(v) if dataclasses.is_dataclass(v) else v
    return {f.name: value(getattr(cfg, f.name))
            for f in dataclasses.fields(QConfig)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_preset_equals_reference(name, mode):
    """preset(name, mode) field for field against the reference's, with the
    quantize / native properties; the port has every reference preset."""
    assert sorted(PRESETS) == sorted(JPRESETS)
    got, want = preset(name, mode), jpreset(name, mode)
    assert _fields(got) == _fields(want)
    assert (got.quantize, got.native) == (want.quantize, want.native)


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_default_mode_is_native_documented_divergence(name):
    """The one divergence from the reference's configuration (ROADMAP
    Queue 3): without a mode the port's presets and QConfig() are native
    (the kernel paths), the reference's sim; fp32 stays fp32.  Every other
    field is equal."""
    got, want = preset(name), jpreset(name)
    assert got.mode == ("fp32" if name == "fp32" else "native")
    assert want.mode == ("fp32" if name == "fp32" else "sim")
    assert _fields(got) == dict(_fields(want.replace(mode=got.mode)),
                                mode=got.mode)
    assert QConfig().mode == "native" and JQConfig().mode == "sim"
    assert FP32 == preset("fp32") == QConfig(mode="fp32")


def test_unknown_mode_and_preset_are_refused():
    with pytest.raises(ValueError, match="unknown mode"):
        QConfig(mode="int4").validate()
    with pytest.raises(ValueError, match="unknown preset"):
        preset("fp16")


# --------------------------------------------------------------------------
# qact, qweight, qdense, qeinsum
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "silu", "none"])
@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_qact_forward_and_backward(mode, act, exact_pow2):
    """sim: the Q_A grid value, Q_E1 then the activation's derivative on
    the way back; fp32: the activation and its derivative alone."""
    r = np.random.default_rng(len(act))
    x = (r.standard_normal((6, 40)) * 3).astype(np.float32)
    ct = (r.standard_normal((6, 40)) * 0.01).astype(np.float32)
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    y, vjp = jax.vjp(lambda t: jqact(jcfg, act, t), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = _t(x).requires_grad_()
    ty = qact(cfg, act, tx)
    assert isinstance(ty, torch.Tensor)
    if act != "silu":
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    else:
        assert _ulps(ty.detach().numpy(), y) <= 1
    with torch.no_grad():       # serving: the same value, no autograd
        np.testing.assert_array_equal(qact(cfg, act, _t(x)).numpy(),
                                      ty.detach().numpy())
    ty.backward(_t(ct))
    got = tx.grad.numpy()
    if act == "silu":
        assert np.abs(got - want).max() <= 2.0 ** -22 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_qweight_is_a_float_grid_value_with_ste(mode):
    r = np.random.default_rng(3)
    w = (r.standard_normal((32, 16)) * 0.4).astype(np.float32)
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    tw = _t(w).requires_grad_()
    q = qweight(cfg, tw)
    assert isinstance(q, torch.Tensor)
    np.testing.assert_array_equal(q.detach().numpy(),
                                  np.asarray(jqweight(jcfg, jnp.asarray(w))))
    q.sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.ones_like(w))


@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_qdense_sim_forward_bitwise_and_native_exact(name, exact_pow2):
    """The reference's test_sim_native_forward_exact, across the packages:
    sim qdense of a Q_A output equals the reference's sim and the port's
    native bit for bit."""
    r = np.random.default_rng(0)
    x = (r.standard_normal((6, 32)) * 0.5).astype(np.float32)
    w = (r.standard_normal((32, 16)) * 0.15).astype(np.float32)
    jcfg, cfg = jpreset(name, "sim"), preset(name, "sim")
    want = jqdense(jcfg, jqact(jcfg, "relu", jnp.asarray(x)), jnp.asarray(w))
    got = qdense(cfg, qact(cfg, "relu", _t(x)), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ncfg = preset(name, "native")
    native = qdense(ncfg, qact(ncfg, "relu", _t(x)), _t(w))
    np.testing.assert_array_equal(got.numpy(), native.numpy())


@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_sim_native_grads_close(name):
    """The reference's test_sim_native_grads_close on the port: the weight
    gradient of sim and native within the reference's rtol 1e-4."""
    r = np.random.default_rng(0)
    x = _t((r.standard_normal((6, 32)) * 0.5).astype(np.float32))
    w = (r.standard_normal((32, 16)) * 0.15).astype(np.float32)
    grads = []
    for mode in ("sim", "native"):
        cfg, tw = preset(name, mode), _t(w).requires_grad_()
        torch.sum(qdense(cfg, qact(cfg, "relu", x), tw) ** 2).backward()
        grads.append(tw.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-5)


def test_fp32_qdense_is_plain_autograd():
    r = np.random.default_rng(1)
    x = _t((r.standard_normal((6, 32)) * 0.5).astype(np.float32))
    w = (r.standard_normal((32, 16)) * 0.15).astype(np.float32)
    tw, pw = _t(w).requires_grad_(), _t(w).requires_grad_()
    torch.sum(qdense(FP32, torch.relu(x), tw) ** 2).backward()
    torch.sum((torch.relu(x) @ pw) ** 2).backward()
    assert torch.equal(tw.grad, pw.grad)


SPECS = {"dense": ("mk,kn->mn", (24, 40), (40, 16)),
         "scores": ("bskgd,btkd->bskgt", (2, 5, 2, 3, 16), (2, 7, 2, 16))}


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("mode,e_kind", [("sim", "default"), ("sim", "sq16"),
                                         ("sim", "sq8"), ("fp32", "default")])
def test_qeinsum_forward_and_grads(mode, e_kind, spec, exact_pow2):
    """The einsum of grid carriers bitwise; both gradients (after Q_E2 in
    sim) within ULPS ulps of their largest magnitude."""
    eq, sha, shb = SPECS[spec]
    r = np.random.default_rng(len(e_kind) + len(spec))
    a, b = _grid(r, sha, 2.0 ** -5), _grid(r, shb, 2.0 ** -7)
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    y, vjp = jax.vjp(lambda p, q: jqeinsum(jcfg, eq, e_kind, True, p, q),
                     jnp.asarray(a), jnp.asarray(b))
    ct = (r.standard_normal(y.shape) * 0.01).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(ct))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    ty = qeinsum(cfg, eq, e_kind, True, ta, tb)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(_t(ct))
    for got, want in ((ta.grad.numpy(), jda), (tb.grad.numpy(), jdb)):
        u = _ulps(got, want)
        print(f"{mode} {e_kind} {spec}: gradient within {u:.1f} ulps "
              f"(bound {ULPS})")
        assert u <= ULPS


@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_qconv_forward_and_grads(mode, exact_pow2):
    """The convolution of grid values bitwise; its gradients (Q_E2 in sim)
    within ULPS ulps of their largest magnitude."""
    r = np.random.default_rng(5)
    x = _grid(r, (2, 8, 8, 16), 2.0 ** -4)
    w = (r.standard_normal((3, 3, 16, 8)) * 0.2).astype(np.float32)
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    y, vjp = jax.vjp(lambda p, q: jqconv(jcfg, p, jqweight(jcfg, q), 2,
                                         "SAME"),
                     jnp.asarray(x), jnp.asarray(w))
    ct = (r.standard_normal(y.shape) * 0.01).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(ct))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = qconv(cfg, tx, qweight(cfg, tw), 2)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(_t(ct))
    for got, want in ((tx.grad.numpy(), jdx), (tw.grad.numpy(), jdw)):
        u = _ulps(got, want)
        print(f"qconv {mode}: gradient within {u:.1f} ulps (bound {ULPS})")
        assert u <= ULPS


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


NORMS = {"rms": ((2, 8, 64), lambda c, x, g, b: qrmsnorm(c, x, g),
                 lambda c, x, g, b: jqrmsnorm(c, x, g)),
         "layer": ((2, 8, 64), qlayernorm, jqlayernorm),
         "batch": ((4, 6, 6, 16), qbatchnorm, jqbatchnorm)}


@pytest.mark.parametrize("kind", sorted(NORMS))
@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_norms_forward_and_grads(mode, kind, exact_pow2):
    shape, fn, jfn = NORMS[kind]
    c = shape[-1]
    r = np.random.default_rng(len(kind))
    x = (r.standard_normal(shape) * 0.7 + 0.2).astype(np.float32)
    gam = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    bet = (0.1 * r.standard_normal(c)).astype(np.float32)
    ct = (r.standard_normal(shape) * 0.01).astype(np.float32)
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    y, vjp = jax.vjp(lambda p, q, s: jfn(jcfg, p, q, s), jnp.asarray(x),
                     jnp.asarray(gam), jnp.asarray(bet))
    want = vjp(jnp.asarray(ct))
    ins = [_t(v).requires_grad_() for v in (x, gam, bet)]
    ty = fn(cfg, *ins)
    got = ty.detach().numpy().reshape(-1, c)
    y = np.asarray(y).reshape(-1, c)
    if mode == "sim":
        ubn_rows_ok(got, y)
    else:
        assert np.abs(got - y).max() <= 2.0 ** -20 * np.abs(y).max()
    ty.backward(_t(ct))
    for t, w in zip(ins, want):
        if kind == "rms" and t is ins[2]:
            assert t.grad is None
            continue
        rel = np.abs(t.grad.numpy() - np.asarray(w)).max() \
            / np.abs(np.asarray(w)).max()
        print(f"{kind} {mode}: gradient within {rel:.3e} of max |grad| "
              f"(bound 2^-18)")
        assert rel <= 2.0 ** -18


def test_fp32_batchnorm_is_plain_bn():
    """The reference's test_qbatchnorm_fp32_is_plain_bn, and the exempt
    stem's batchnorm is the fp32 qbatchnorm bit for bit."""
    from repro_torch.core import batchnorm
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 8)).astype(np.float32) * 3)
    y = qbatchnorm(FP32, x, torch.ones(8), torch.zeros(8))
    assert abs(float(y.mean())) < 1e-4
    assert abs(float(y.std(unbiased=False)) - 1.0) < 0.05
    assert torch.equal(batchnorm(x, torch.ones(8), torch.zeros(8)), y)


# --------------------------------------------------------------------------
# the optimizer
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
    grads = jax.tree.map(lambda p: (r.standard_normal(p.shape) * 1e-3)
                         .astype(np.float32), params)
    acc = jax.tree.map(lambda p: (r.standard_normal(p.shape) * 1e-3)
                       .astype(np.float32), params)
    return params, grads, acc, labels


@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_momentum_update_bitwise(mode, exact_pow2):
    """Eager JAX against the port from the same tree, key and learning
    rate; in fp32 every leaf is vanilla Momentum, the reference's
    test_fp32_mode_is_vanilla_everywhere formula."""
    params, grads, acc, labels = _opt_tree(np.random.default_rng(4))
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    lr = fixed_point_lr(0.05, cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(17), 2)
    jp, js = jmomentum_update(
        jcfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        JState(acc=jax.tree.map(jnp.asarray, acc), step=jnp.int32(0)),
        labels, key, lr)
    tp, tg = jax.tree.map(_t, params), jax.tree.map(_t, grads)
    st = MomentumState(acc=jax.tree.map(_t, acc))
    momentum_update(cfg, tp, tg, st, labels,
                    ttrain.prng.fold_in(ttrain.prng.prng_key(17), 2), lr)
    for got, want in zip(flatten(tp) + flatten(st.acc),
                         jax.tree.leaves(jp) + jax.tree.leaves(js.acc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "fp32":
        for p, g, a, got in zip(flatten(params), flatten(grads),
                                flatten(acc), flatten(tp)):
            vanilla = p - np.float32(lr) * (np.float32(0.75) * a + g)
            np.testing.assert_array_equal(got.numpy(), vanilla)


def test_fp32_learning_rate_and_momentum_are_as_given():
    assert fixed_point_lr(0.05, FP32) == 0.05
    assert fixed_point_lr(0.05, preset("full8", "sim")) == 26 / 512
    assert _mom_coeff(FP32, 0.9) == 0.9
    assert _mom_coeff(preset("full8", "sim"), 0.9) == 1.0


def test_fp32_init_is_off_the_grid():
    """winit in fp32 mode leaves the normal draw as it is; quantized modes
    put it on the k_WU grid."""
    ws = []
    for cfg in (FP32, preset("full8", "sim")):
        w = torch.empty(64, 32)
        winit_(cfg, w, 64, torch.Generator().manual_seed(0))
        ws.append(w.double() * 2 ** 23)
    assert not torch.equal(ws[0], ws[0].round())
    assert torch.equal(ws[1], ws[1].round())


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("argv,mode", [
    (["--mode", "sim"], "sim"), (["--mode", "fp32"], "fp32"),
    (["--preset", "fp32"], "fp32"), (["--preset", "fp32", "--mode", "sim"],
                                     "fp32")])
def test_train_cli_modes(argv, mode, capsys):
    """--mode sim|fp32 train, and --preset fp32 ignores --mode as the
    reference's CLI does; the [train] line names the mode that ran."""
    ttrain.main(["--arch", "granite-3-8b", "--reduced", "--steps", "2",
                 "--batch", "2", "--seq", "8", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert f"/{mode} on cpu" in out and "step     1 loss" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


# --------------------------------------------------------------------------
# fp32 checkpoints across the packages
# --------------------------------------------------------------------------


def _encoding(cm, key: str) -> str:
    """How the latest checkpoint under `cm` stored the leaf `key`."""
    return cm.meta()["qsave"][key]["enc"]


def _fp32_reference_state():
    acfg = jget("granite-3-8b").reduced()
    jm = jbuild(acfg, jpreset("fp32"))
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    step = jax.jit(jmake_step(jm, jpreset("fp32"), jm.labels(params),
                              lr=0.05))
    batch = JTokenTask(acfg.vocab, 16, 2).batch(0)
    params, jopt, _ = step(params, jopt, jax.tree.map(jnp.asarray, batch),
                           jnp.int32(0))
    return jm, params, jopt


def test_fp32_masters_pack_raw_and_restore_in_the_port(tmp_path):
    """fp32 masters are off every grid: the reference's checkpoint of an
    fp32 step stores them raw, and the port restores them bit for bit;
    convert.py carries the same leaves across unchanged."""
    jm, params, jopt = _fp32_reference_state()
    cm = JManager(str(tmp_path))
    cm.save(1, (params, jopt))
    cm.wait()
    want = _flatten_with_paths((params, jopt))
    tm = build_model(get("granite-3-8b").reduced(), FP32,
                     device="cpu").init(1)
    opt = init_momentum(tm.params())
    _, step, _ = CheckpointManager(str(tmp_path)).restore((tm.params(), opt))
    got = flatten_with_paths((tm.params(), opt))
    assert step == 1 and list(got) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, k)
    assert _encoding(CheckpointManager(str(tmp_path)), "0/layers/wq") == "raw"
    conv = build_model(get("granite-3-8b").reduced(), FP32, device="cpu")
    conv.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    for a, b in zip(flatten(conv.params()), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    acc = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    for a, b in zip(flatten(acc.acc), jax.tree.leaves(jopt.acc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fp32_port_checkpoint_restores_in_reference(tmp_path):
    """One fp32 step of the port, saved; the reference restores every
    leaf bit for bit, the off-grid hidden weights stored raw."""
    cfg = FP32
    tm = build_model(get("granite-3-8b").reduced(), cfg, device="cpu").init(0)
    opt = init_momentum(tm.params())
    step = ttrain.make_train_step(tm, cfg, lr=0.05)
    step(opt, JTokenTask(tm.a.vocab, 16, 2).batch(0), 0)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, (tm.params(), opt))
    cm.wait()
    want = flatten_with_paths((tm.params(), opt))
    jm = jbuild(jget("granite-3-8b").reduced(), jpreset("fp32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree, at, _ = JManager(str(tmp_path)).restore(
        (shapes, jax.eval_shape(jinit_momentum, shapes)))
    got = _flatten_with_paths(tree)
    assert at == 1 and list(got) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, k)
    assert _encoding(cm, "0/layers/wq") == "raw"
