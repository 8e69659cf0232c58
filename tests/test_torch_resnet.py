"""The port's ResNet training slice (repro_torch) against the JAX reference.

Same numpy inputs through `repro` (native mode, CPU oracles) and
`repro_torch` (device="cpu", plain versions).  Tolerances:

  qconv forward and both gradients, full8 and e2_16: bitwise.  Every sum
     is exact in fp32 at these widths, so the two libraries' summation
     orders cannot show: activation and weight payloads of at most 3 bits,
     Q_E2 payloads of at most 15 bits (sq16; flag8's two planes span 14),
     and at most 64 products per output, so every partial sum stays below
     2^24 units of its grid.  At full width a 3x3x512 sum of int8 x int8
     grid products can pass 2^24, and fp32 sums depend on their order.
  The SAME-padded stem convolution and max pool (values and gradients):
     bitwise, on small integers (exact sums), odd and even sizes, with
     ties in the pool (the gradient goes to the first maximum).
  qbatchnorm forward: the per-column form of the K4 bound (torch_parity.
     ubn_rows_ok on the transposed output: a column's statistic is a sum
     in another order, so at most 5% of the columns may land one k_sigma
     grid step away).  Backward: the recomputed statistics are fp32 sums
     in another order, so a column's mu_q or sigma_q may land one 2^-15
     step away, which moves its gradients by about 2^-15 / sigma of their
     size: within 2^-14 of the largest gradient (sigma about 2 here).
  The reduced resnet18 / resnet50 loss and gradients from the same
     weights: on pixels of the npz pipeline (the 2^-7 grid) every
     quantized leaf's gradient differs in at most 2% of its elements, by
     at most 2^-12 of its largest magnitude, and the fp32 leaves (stem,
     bn_stem, fc, fc_b) by at most 2^-18; on the synthetic N(0, 1) images
     the fp32 stem convolution and BN differ by ulps between XLA and
     PyTorch, which may flip Q_A payload codes after the pool (the share is
     printed and bounded by 1%), and a flipped code or a BN column one
     grid step away moves the quantized errors: the loss within 1e-3
     relative, every gradient leaf at cosine >= 0.99.
  5 training steps of make_train_step beside the reference's (synthetic
     images, batch 8): the loss of every step within 2e-3 relative; after
     step 5 at most 95% of the hidden weights' k_WU-grid codes differ, by
     at most 2^14 codes (2^-9 of weight).  `-s` prints each step's gap.
  The same trajectory held tighter where it can be (measured on the CPU
     over resnet18 / resnet50 x full8 / e2_16, these inputs):
     after step 1 on the synthetic images at most 33.8% of the hidden
     codes differ, by at most 1794 codes (the stem's ulps above); bound
     45% and 2^12.  On the npz pipeline's images (`write_demo_dataset`,
     the 2^-7 grid) step 1 differs in at most 0.185% of the codes, by at
     most 26; bound 0.5% and 64.  Over 5 npz steps the loss is within
     2.61e-3 relative (bound 5e-3), and after step 5 at most 97.9% of the
     codes differ, by at most 6422 (bound 99% and 2^13): from step 2 on,
     a BN column one grid step away in either package moves whole layers'
     updates, so the npz trajectory is no tighter than the synthetic one
     after step 1 (e2_16 diverges from step 2, resnet18 full8 from step 3,
     resnet50 full8 stays within 104 codes in 0.001% of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.core import qbatchnorm as jqbatchnorm
from repro.core import qconv as jqconv
from repro.core import qweight as jqweight
from repro.data import ImageTask as JImageTask
from repro.data import NpzImageTask as JNpzTask
from repro.data import write_demo_dataset as jwrite_demo
from repro.kernels import ops as jops
from repro.kernels.ubn import ubn_norm as pallas_ubn
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, resnet_params_from_jax
from repro_torch.core import preset, qact, qbatchnorm, qconv, qweight
from repro_torch.core.qdense import conv_valid, pad_same, same_pads
from repro_torch.data import (ImageTask, NpzImageTask, resolve_image_task,
                              write_demo_dataset)
from repro_torch.launch import train as ttrain
from repro_torch.models import ResNet, build_model
from repro_torch.models.resnet import max_pool_same
from repro_torch.optim import flatten, init_momentum

from torch_parity import exact_pow2, ubn_rows_ok  # noqa: F401

ARCHS = ("resnet18", "resnet50")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced ResNets run thousands of tiny PyTorch ops; under the
    suite's parallel workers, every op's thread pool waits on threads the
    other workers hold.  One intra-op thread keeps this file's time
    independent of the load (the bounds do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _grid(r, shape, step, lim=7):
    """Grid values n * step with |n| <= lim (small payloads: exact sums)."""
    return (r.integers(-lim, lim + 1, shape) * step).astype(np.float32)


# --------------------------------------------------------------------------
# qconv, the stem convolution and the max pool
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,size", [(1, 1, 8), (1, 2, 8), (3, 1, 7),
                                           (3, 2, 8), (3, 2, 9)])
@pytest.mark.parametrize("name", ["full8", "e2_16"])
def test_qconv_forward_and_grads_bitwise(k, stride, size, name, exact_pow2):
    r = np.random.default_rng(k * 100 + stride * 10 + size)
    x = _grid(r, (1, size, size, 4), 2.0 ** -3)
    w = _grid(r, (k, k, 4, 6), 2.0 ** -7)
    jcfg, cfg = jpreset(name, "native"), preset(name)
    y, vjp = jax.vjp(lambda a, b: jqconv(jcfg, a, jqweight(jcfg, b), stride,
                                         "SAME"), jnp.asarray(x),
                     jnp.asarray(w))
    ct = (r.standard_normal(y.shape) * 0.01).astype(np.float32)
    jdx, jdw = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = qconv(cfg, tx, qweight(cfg, tw), stride)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(_t(ct))
    np.testing.assert_array_equal(tx.grad.numpy(), jdx)
    np.testing.assert_array_equal(tw.grad.numpy(), jdw)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (7, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (9, 3, 1, (1, 1))])
def test_same_pads_match_jax(size, k, stride, want):
    assert same_pads(size, k, stride) == want
    lo_hi = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert tuple(lo_hi) == want


@pytest.mark.parametrize("size", [7, 8, 16, 17])
def test_stem_conv_and_max_pool_bitwise(size):
    r = np.random.default_rng(size)
    img = _grid(r, (2, size, size, 3), 1.0, lim=3)
    w = _grid(r, (7, 7, 3, 5), 1.0, lim=3)
    dn = ("NHWC", "HWIO", "NHWC")
    y, vjp = jax.vjp(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (2, 2), "SAME", dimension_numbers=dn), jnp.asarray(img),
        jnp.asarray(w))
    ct = _grid(r, y.shape, 1.0, lim=3)
    ti, tw = _t(img).requires_grad_(), _t(w).requires_grad_()
    ty = conv_valid(pad_same(ti, 7, 7, 2), tw, 2)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(_t(ct))
    for got, want in zip((ti.grad, tw.grad), vjp(jnp.asarray(ct))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the pool, on integers with many ties in a window
    x = _grid(r, (2, size, size, 3), 1.0, lim=2)
    p, pvjp = jax.vjp(lambda a: jax.lax.reduce_window(
        a, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"),
        jnp.asarray(x))
    pct = r.standard_normal(p.shape).astype(np.float32)
    tx = _t(x).requires_grad_()
    tp = max_pool_same(tx)
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(p))
    tp.backward(_t(pct))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(pvjp(jnp.asarray(pct))[0]))


# --------------------------------------------------------------------------
# qbatchnorm (K4 "batch")
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (2, 8, 8, 24),
                                   (3, 5, 5, 8)])
def test_qbatchnorm_forward_and_backward(shape, exact_pow2):
    r = np.random.default_rng(shape[-1])
    x = (r.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    c = shape[-1]
    gamma = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    beta = (0.1 * r.standard_normal(c)).astype(np.float32)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    y, vjp = jax.vjp(lambda *a: jqbatchnorm(jcfg, *a), jnp.asarray(x),
                     jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (_t(v).requires_grad_() for v in (x, gamma, beta))
    ty = qbatchnorm(cfg, tx, tg, tb)
    got = ty.detach().numpy().reshape(-1, c)
    ubn_rows_ok(got.T, np.asarray(y).reshape(-1, c).T)
    kw = dict(kind="batch", k_mu=16, k_sigma=16, k_bn=16, k_gamma=8,
              k_beta=8, eps=2.0 ** -8)
    jargs = (jnp.asarray(x.reshape(-1, c)), jnp.asarray(gamma),
             jnp.asarray(beta))
    ubn_rows_ok(got.T, np.asarray(jops.ubn_norm_op(*jargs, **kw)).T)
    ubn_rows_ok(got.T, np.asarray(pallas_ubn(*jargs, bt=8, interpret=True,
                                             **kw)).T)
    ct = (r.standard_normal(shape) * 0.01).astype(np.float32)
    ty.backward(_t(ct))
    for t, want in zip((tx, tg, tb), vjp(jnp.asarray(ct))):
        want = np.asarray(want)
        rel = np.abs(t.grad.numpy() - want).max() / np.abs(want).max()
        print(f"qbatchnorm grad {want.shape}: max |d| = {rel:.3e} of max "
              f"|grad| (bound 2^-14)")
        assert rel <= 2.0 ** -14


# --------------------------------------------------------------------------
# the model: tree, loss and gradients
# --------------------------------------------------------------------------


_REF_INIT: dict = {}


def _models(arch, name="full8"):
    """The reduced config, the reference model and its weights (its eager
    init takes seconds, so both are made once per module and preset) and a
    fresh port model holding the same weights."""
    acfg = jget(arch).reduced()
    if (arch, name) not in _REF_INIT:
        jm = jbuild(acfg, jpreset(name, "native"))
        _REF_INIT[arch, name] = jm, jm.init(jax.random.PRNGKey(0))
    jm, params = _REF_INIT[arch, name]
    tm = build_model(get(arch).reduced(), preset(name), device="cpu")
    tm.load_params(resnet_params_from_jax(jax.tree.map(np.asarray, params)))
    return acfg, jm, params, tm


@pytest.mark.parametrize("arch", ARCHS + ("resnet34",))
def test_tree_order_is_jax_tree_leaves(arch):
    for acfg, tacfg in ((jget(arch), get(arch)),
                        (jget(arch).reduced(), get(arch).reduced())):
        jm = jbuild(acfg, jpreset("full8", "native"))
        jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        tm = build_model(tacfg, preset("full8"), device="meta")
        assert isinstance(tm, ResNet)
        assert [tuple(x.shape) for x in flatten(tm.params())] == \
            [x.shape for x in jax.tree.leaves(jparams)]
        assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(jparams))
        assert jax.tree.structure(tm.labels()) == \
            jax.tree.structure(jm.labels(jparams))
        if arch == "resnet50" and acfg.stage_sizes == (3, 4, 6, 3):
            leaves = flatten(tm.params())
            assert len(leaves) == 161
            assert abs(sum(x.numel() for x in leaves) - 25.6e6) < 0.1e6


def _leaf_kinds(tm):
    """Per leaf: "fp32" (the exempt stem, bn_stem, fc, fc_b) or "q"."""
    t = tm.params()
    fp32 = {id(x) for x in flatten({"stem": t["stem"], "bn": t["bn_stem"],
                                    "fc": t["fc"], "fc_b": t["fc_b"]})}
    return ["fp32" if id(x) in fp32 else "q" for x in flatten(t)]


@pytest.mark.parametrize("images", ["npz", "synthetic"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_within_bounds(arch, images, exact_pow2):
    acfg, jm, params, tm = _models(arch)
    batch = JImageTask(acfg.img_size, acfg.num_classes, 8).batch(0)
    if images == "npz":      # the npz pipeline's pixels: the 2^-7 grid
        batch["images"] = np.clip(np.round(batch["images"] * 32), -128,
                                  127).astype(np.float32) / 128
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    loss, met = tm.loss(batch)
    loss.backward()
    rel = abs(float(loss.detach()) - float(jl)) / float(jl)
    print(f"{arch} {images}: loss rel {rel:.3e}")
    assert set(met) == {"loss", "acc"}
    for t, g, kind in zip(flatten(tm.params()), jax.tree.leaves(jg),
                          _leaf_kinds(tm)):
        got, want = t.grad.numpy().astype(np.float64), np.asarray(g, np.float64)
        d = np.abs(got - want).max() / np.abs(want).max()
        if images == "npz":
            if kind == "fp32":
                assert d <= 2.0 ** -18, (want.shape, d)
            else:
                assert d <= 2.0 ** -12, (want.shape, d)
                assert np.mean(got != want) <= 0.02, want.shape
        else:
            cos = got.ravel() @ want.ravel() / (
                np.linalg.norm(got) * np.linalg.norm(want))
            assert cos >= 0.99, (want.shape, cos)
    if images == "npz":
        assert rel <= 2.0 ** -20
        return
    assert rel <= 1e-3
    # the first Q_A payload (after the exempt stem and the pool)
    x = jax.lax.conv_general_dilated(
        jnp.asarray(batch["images"]), params["stem"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    from repro.core import qact as jqact
    from repro.core.qconfig import FP32
    from repro.core import qbatchnorm as jbn
    x = jbn(FP32, x, params["bn_stem"]["gamma"], params["bn_stem"]["beta"])
    x = jax.lax.reduce_window(jax.nn.relu(x), -jnp.inf, jax.lax.max,
                              (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    want = np.asarray(jqact(jpreset("full8", "native"), "none", x).data)
    from repro_torch.core import batchnorm
    t = tm.params()
    with torch.no_grad():
        y = conv_valid(pad_same(_t(batch["images"]), 7, 7, 2), t["stem"], 2)
        y = batchnorm(y, t["bn_stem"]["gamma"], t["bn_stem"]["beta"])
        got = qact(preset("full8"), "none",
                   max_pool_same(torch.relu(y))).data.numpy()
    share = float(np.mean(got != want))
    print(f"{arch}: post-pool Q_A payload flip share {share:.2e} (bound 1%)")
    assert share <= 0.01


# --------------------------------------------------------------------------
# the slice: 5 training steps against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["full8", "e2_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_slice_within_bounds(arch, name, exact_pow2):
    gaps, topt = _synthetic(arch, name)
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    share, dist = gaps[-1][1:]
    assert share <= 0.95 and dist <= 2 ** 14, (share, dist)
    assert topt.step == 5
    assert all(torch.isfinite(x).all() for x in flatten(topt.acc))


_SYNTHETIC: dict = {}


def _synthetic(arch, name):
    """The 5-step trajectory on the synthetic images (batch 8), made once
    per module for the 5-step and the step-1 tests: (gaps, the port's
    optimizer state after step 5)."""
    if (arch, name) not in _SYNTHETIC:
        acfg = get(arch).reduced()
        _SYNTHETIC[arch, name] = _trajectory(
            arch, name, ImageTask(acfg.img_size, acfg.num_classes, 8), 5,
            keep_opt=True)
    return _SYNTHETIC[arch, name]


def _trajectory(arch, name, task, steps, n_micro=1, keep_opt=False):
    """make_train_step of both packages from the same weights over `steps`
    batches of `task`: per step the loss's relative gap, the share of the
    hidden weights' k_WU-grid codes that differ and their largest
    distance in codes (with `keep_opt`, also the port's optimizer state
    at the end)."""
    acfg, jm, params, tm = _models(arch, name)
    jcfg, cfg = jpreset(name, "native"), preset(name)
    jopt = jinit_momentum(params)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05,
                               n_micro=n_micro))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05, n_micro=n_micro)
    hidden = [i for i, lab in enumerate(flatten(tm.labels())) if lab == "w"]

    def codes(leaves):
        return np.concatenate([np.asarray(leaves[i], np.float64).ravel()
                               * 2 ** 23 for i in hidden])

    gaps = []
    for s in range(steps):
        batch = task.batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        tmet = tstep(topt, batch, s)
        assert set(tmet) == set(met)
        rel = abs(float(tmet["loss"]) - float(met["loss"])) \
            / float(met["loss"])
        d = np.abs(codes(jax.tree.leaves(params))
                   - codes([p.detach().numpy()
                            for p in flatten(tm.params())]))
        gaps.append((rel, float(np.mean(d > 0)), float(d.max())))
        print(f"{arch} {name} step {s + 1}: loss rel {rel:.3e}, codes "
              f"differing {gaps[-1][1]:.5f}, max distance {gaps[-1][2]:.0f}")
    return (gaps, topt) if keep_opt else gaps


@pytest.mark.parametrize("name", ["full8", "e2_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step1_within_bounds(arch, name, exact_pow2):
    """Step 1 on the synthetic images: at most 45% of the hidden codes
    differ, by at most 2^12 (measured 33.8% and 1794).  Step 1 of the
    5-step trajectory, which is made once for both tests."""
    rel, share, dist = _synthetic(arch, name)[0][0]
    assert rel <= 2e-3
    assert share <= 0.45 and dist <= 2 ** 12, (share, dist)


@pytest.mark.parametrize("name", ["full8", "e2_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_slice_npz_within_bounds(arch, name, exact_pow2, tmp_path):
    """5 steps on the npz pipeline's images: step 1 within 0.5% of the
    hidden codes and 64 codes (measured 0.185% and 26), every loss within
    5e-3 relative (2.61e-3), after step 5 within 99% and 2^13 codes (97.9%
    and 6422)."""
    write_demo_dataset(str(tmp_path), n=256, img_size=16, num_classes=10)
    gaps = _trajectory(arch, name, NpzImageTask(str(tmp_path), 8), 5)
    assert gaps[0][1] <= 0.005 and gaps[0][2] <= 64, gaps[0]
    assert all(rel <= 5e-3 for rel, _, _ in gaps), gaps
    assert gaps[-1][1] <= 0.99 and gaps[-1][2] <= 2 ** 13, gaps[-1]


def test_n_micro_within_bounds(exact_pow2):
    """resnet50, n_micro=2 (BN statistics over each microbatch of 4)
    beside the reference's n_micro=2 over 2 synthetic batches of 8: every
    loss within 2e-3 relative, step 1 within the synthetic step-1 bound
    (45% of the hidden codes, 2^12 apart), step 2 within the 5-step bound
    (95%, 2^14)."""
    acfg = get("resnet50").reduced()
    gaps = _trajectory("resnet50", "full8", ImageTask(
        acfg.img_size, acfg.num_classes, 8), 2, n_micro=2)
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    assert gaps[0][1] <= 0.45 and gaps[0][2] <= 2 ** 12, gaps[0]
    assert gaps[1][1] <= 0.95 and gaps[1][2] <= 2 ** 14, gaps[1]


def test_train_cli_runs_resnet_on_cpu(capsys, tmp_path):
    ttrain.main(["--arch", "resnet50", "--reduced", "--mode", "native",
                 "--steps", "2", "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "16x16x3 images, 10 classes" in out
    assert "step     1 loss" in out and " acc " in out
    write_demo_dataset(str(tmp_path), n=64, img_size=8, num_classes=4)
    ttrain.main(["--arch", "resnet18", "--reduced", "--steps", "1",
                 "--batch", "4", "--device", "cpu", "--data-dir",
                 str(tmp_path)])
    assert "8x8x3 images, 4 classes" in capsys.readouterr().out


def test_resnet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get("resnet50").reduced(), preset("full8"))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def test_image_task_equals_reference():
    for size, classes, batch, seed in ((16, 10, 8, 0), (12, 5, 6, 3)):
        mine = ImageTask(size, classes, batch, seed=seed)
        ref = JImageTask(size, classes, batch, seed=seed)
        for step, shard, n in ((0, 0, 1), (3, 1, 2), (7, 2, 3)):
            a, b = mine.batch(step, shard, n), ref.batch(step, shard, n)
            for k in ("images", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(mine.holdout_batch(1)["images"],
                                      ref.holdout_batch(1)["images"])
    task = ImageTask(8, 3, 2)
    task.batch(0)
    task.seed = 5           # the cached prototypes follow the fields
    np.testing.assert_array_equal(task.batch(1)["images"],
                                  JImageTask(8, 3, 2, seed=5).batch(1)[
                                      "images"])


def test_npz_image_task_equals_reference(tmp_path):
    a, b = tmp_path / "mine", tmp_path / "ref"
    info = write_demo_dataset(str(a), n=200, img_size=8, num_classes=4)
    assert info == {**jwrite_demo(str(b), n=200, img_size=8,
                                  num_classes=4),
                    "paths": info["paths"]}
    for f in ("train_000.npz", "val_000.npz"):
        with np.load(a / f) as x, np.load(b / f) as y:
            for k in ("images", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    mine, ref = NpzImageTask(str(a), 24, seed=2), JNpzTask(str(b), 24, seed=2)
    assert (mine.img_size, mine.num_classes, mine.n_train) == \
        (ref.img_size, ref.num_classes, ref.n_train)
    for step, shard, n in ((0, 0, 1), (9, 1, 2), (17, 0, 3)):
        x, y = mine.batch(step, shard, n), ref.batch(step, shard, n)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
    np.testing.assert_array_equal(mine.holdout_batch(2)["images"],
                                  ref.holdout_batch(2)["images"])
    task, tag = resolve_image_task(4, data_dir=str(a))
    assert isinstance(task, NpzImageTask) and tag == "real:mine"
    task, tag = resolve_image_task(4, data_dir="", synthetic=True)
    assert isinstance(task, ImageTask) and tag == "synthetic"


def test_optimizer_walks_the_resnet_tree():
    tm = build_model(get("resnet18").reduced(), preset("full8"),
                     device="cpu").init(0)
    opt = init_momentum(tm.params())
    assert isinstance(opt.acc["stages"][1][0]["bn_proj"]["gamma"],
                      torch.Tensor)
    assert [tuple(x.shape) for x in flatten(opt.acc)] == \
        [tuple(x.shape) for x in flatten(tm.params())]
