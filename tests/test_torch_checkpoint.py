"""The port's checkpoints (repro_torch.checkpoint) against the reference's.

Same numpy inputs through `repro.checkpoint` and `repro_torch.checkpoint`,
the models on the CPU.  Tolerances:

  qsave: `pack_tree` gives equal payload arrays (values and dtypes) and
     equal format dicts in both packages for every encoding; unpacking
     gives the input bit for bit.  `export_int8` gives equal payloads and
     scales.
  Keys: the port's (params, MomentumState) key list equals the reference's
     `_flatten_with_paths` key list of (params, MomentumState(acc, step)),
     order included, for the reduced granite-3-8b, resnet50 and
     falcon-mamba-7b (whose conv_b is a "beta" leaf and dt_bias, A_log
     and D_skip exempt ones).
  Cross-package restore (2 reference steps under exact_pow2, then its
     CheckpointManager's step-2 checkpoint): restores in the port to the
     reference's arrays, equal; the port's own checkpoint after 2 more
     steps restores in the reference's CheckpointManager, equal, dtypes
     included.  "Equal" is value equality: the packed format (the
     reference's) stores a zero as payload 0, so a -0.0 in an accumulator
     (CQ rounds small negative gradients to it) restores as +0.0 in both
     packages; every other bit is kept, and a signed zero changes no
     nonzero value of a later step.
  Resume in the port: 4 unbroken steps give the same parameters and
     accumulator (equal) and losses (bitwise) as 2 steps, a save, a fresh
     model and optimizer state, a restore and 2 steps; the writer thread
     runs while the unbroken model steps on in place.
  Cross-package continuation: the port's steps 3 and 4 from the
     reference's step-2 checkpoint against the reference's own steps 3
     and 4, within the bounds of the train-slice tests: every loss within
     2e-3 relative, and after step 4 the hidden k_WU-grid codes within
     full8's 5-step bound (the LMs: 95% differing, 8192 codes apart; the
     ResNet: 95%, 2^14).  The step-1 bound of the LM's slice does not
     carry over: from the reference's step-2 state the LM's step 3
     differs in 15.4% of the codes, by at most 468, which are the
     numbers of step 3 of the unbroken slice in test_torch_train.py (the
     two packages agree exactly up to step 2 there; an ulp in step 3's
     gradients tips stochastic-rounding comparisons and CQ scales).
  The manager's semantics (retention, tmp sweep, failed publish, key and
     shape mismatch, dtype cast, dense mode) mirror tests/test_checkpoint.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import qsave as jqsave
from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.data import ImageTask as JImageTask
from repro.data import TokenTask as JTokenTask
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro_torch.checkpoint import CheckpointManager, qsave
from repro_torch.checkpoint.manager import flatten_with_paths, tree_keys
from repro_torch.configs import get
from repro_torch.core import QTensor, get_quantizer, preset
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import MomentumState, flatten, init_momentum

from torch_parity import exact_pow2_patched

ARCHS = ("granite-3-8b", "resnet50", "falcon-mamba-7b")
# a leaf key each tree must hold (the SSM's conv_b is its "beta" leaf)
A_KEY = {"granite-3-8b": "1/acc/layers/wq", "resnet50": "0/stages/0/0/conv1",
         "falcon-mamba-7b": "1/acc/layers/conv_b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in test_torch_resnet.py: the reduced models
    run many tiny ops, whose thread pools wait on the other workers'."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def manager(tmp_path):
    """make(sub, **kw) -> a CheckpointManager under tmp_path; every one is
    waited for when the test ends."""
    made = []

    def make(sub="ck", **kw):
        cm = CheckpointManager(str(tmp_path / sub), **kw)
        made.append(cm)
        return cm

    yield make
    for cm in made:
        cm.wait()


def _task(arch):
    acfg = jget(arch).reduced()
    if arch == "resnet50":
        return JImageTask(acfg.img_size, acfg.num_classes, 8)
    return JTokenTask(acfg.vocab, 32, 4)


def _port_model(arch, seed=0):
    return build_model(get(arch).reduced(), preset("full8"),
                       device="cpu").init(seed)


def _hidden_codes(arch, leaves) -> np.ndarray:
    """The hidden weights' k_WU-grid codes, from leaves in tree order."""
    labels = flatten(build_model(get(arch).reduced(), preset("full8"),
                                 device="meta").labels())
    return np.concatenate([np.asarray(x, np.float64).ravel() * 2 ** 23
                           for x, lab in zip(leaves, labels) if lab == "w"])


# --------------------------------------------------------------------------
# the reference's run: 4 steps, its step-2 checkpoint
# --------------------------------------------------------------------------


def _reference_run(arch, directory):
    with exact_pow2_patched():
        acfg = jget(arch).reduced()
        jcfg = jpreset("full8", "native")
        jm = jbuild(acfg, jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        out = {"dir": directory, "losses": [], "codes": []}
        jopt = jinit_momentum(params)
        jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
        task = _task(arch)
        cm = JManager(directory)
        try:
            for s in range(4):
                params, jopt, met = jstep(
                    params, jopt, jax.tree.map(jnp.asarray, task.batch(s)),
                    jnp.int32(s))
                out["losses"].append(float(met["loss"]))
                out["codes"].append(_hidden_codes(arch,
                                                  jax.tree.leaves(params)))
                if s == 1:
                    cm.save(2, (params, jopt))
                    out["step2"] = _flatten_with_paths((params, jopt))
        finally:
            cm.wait()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    runs = {}

    def run(arch):
        if arch not in runs:
            runs[arch] = _reference_run(
                arch, str(tmp_path_factory.mktemp(f"ref-{arch}")))
        return runs[arch]

    return run


@pytest.fixture(scope="module")
def continuation(reference, tmp_path_factory):
    """The port restored from the reference's step-2 checkpoint, then 2
    steps (losses and hidden codes kept) and a save of step 4."""
    runs = {}

    def run(arch):
        if arch in runs:
            return runs[arch]
        ref = reference(arch)
        tm = _port_model(arch, seed=1)
        opt = init_momentum(tm.params())
        _, step, _ = CheckpointManager(ref["dir"]).restore(
            (tm.params(), opt))
        restored, opt_step = flatten_with_paths((tm.params(), opt)), opt.step
        tstep = ttrain.make_train_step(tm, preset("full8"), lr=0.05)
        task, losses, codes = _task(arch), [], []
        for s in (2, 3):
            losses.append(float(tstep(opt, task.batch(s), s)["loss"]))
            codes.append(_hidden_codes(
                arch, [p.detach().numpy() for p in flatten(tm.params())]))
        cm = CheckpointManager(str(tmp_path_factory.mktemp(f"port-{arch}")))
        try:
            cm.save(4, (tm.params(), opt))
        finally:
            cm.wait()
        runs[arch] = dict(step=step, opt_step=opt_step, restored=restored,
                          losses=losses, codes=codes, dir=cm.dir,
                          final=flatten_with_paths((tm.params(), opt)))
        return runs[arch]

    return run


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_port(arch, continuation,
                                                reference):
    want, got = reference(arch)["step2"], continuation(arch)
    assert got["step"] == 2 and got["opt_step"] == 2
    assert list(got["restored"]) == list(want)
    for k, a in want.items():
        b = got["restored"][k]
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b, a, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(arch, continuation):
    got = continuation(arch)
    acfg = jget(arch).reduced()
    jm = jbuild(acfg, jpreset("full8", "native"))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(jinit_momentum, params)
    tree, step, _ = JManager(got["dir"]).restore((params, opt))
    assert step == 4 and int(tree[1].step) == 4
    restored = _flatten_with_paths(tree)
    assert list(restored) == list(got["final"])
    for k, a in got["final"].items():
        assert restored[k].dtype == a.dtype, k
        np.testing.assert_array_equal(restored[k], a, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_continues_reference_checkpoint(arch, continuation, reference):
    ref, got = reference(arch), continuation(arch)
    for i, s in enumerate((2, 3)):
        rel = abs(got["losses"][i] - ref["losses"][s]) / ref["losses"][s]
        d = np.abs(got["codes"][i] - ref["codes"][s])
        share, dist = float(np.mean(d > 0)), float(d.max())
        print(f"{arch} step {s + 1} from the reference's step 2: loss rel "
              f"{rel:.3e} (bound 2e-3), codes differing {share:.5f}, max "
              f"distance {dist:.0f}")
        assert rel <= 2e-3
    bound = (2 ** 14 if arch == "resnet50" else 8192)
    assert share <= 0.95 and dist <= bound, (share, dist)


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_keys_match_reference(arch):
    jm = jbuild(jget(arch).reduced(), jpreset("full8", "native"))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))
    want = list(_flatten_with_paths((params, jinit_momentum(params))))
    tm = build_model(get(arch).reduced(), preset("full8"), device="meta")
    got = [k for k, _ in tree_keys((tm.params(), init_momentum(
        tm.params())))]
    assert got == want
    assert want[-1] == "1/step"
    assert A_KEY[arch] in want


# --------------------------------------------------------------------------
# resume in the port, bitwise
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_equals_unbroken_run(arch, manager):
    """4 unbroken steps against 2 steps, a save, a fresh model and state,
    a restore and 2 steps.  The save is async and the unbroken model steps
    on while the writer thread packs its snapshot."""
    cfg, task = preset("full8"), _task(arch)
    tm = _port_model(arch)
    opt = init_momentum(tm.params())
    step = ttrain.make_train_step(tm, cfg, lr=0.05)
    cm = manager(async_write=True)
    losses = []
    for s in range(4):
        losses.append(step(opt, task.batch(s), s)["loss"])
        if s == 1:
            cm.save(2, (tm.params(), opt), aux={"arch": arch})
    cm.wait()

    fresh = _port_model(arch, seed=1)
    fopt = init_momentum(fresh.params())
    _, at, aux = cm.restore((fresh.params(), fopt))
    assert (at, fopt.step, aux) == (2, 2, {"arch": arch})
    fstep = ttrain.make_train_step(fresh, cfg, lr=0.05)
    for s in (2, 3):
        got = fstep(fopt, task.batch(s), s)["loss"]
        assert torch.equal(got, losses[s]), s
    assert fopt.step == opt.step == 4
    for a, b in zip(flatten(fresh.params()), flatten(tm.params())):
        assert torch.equal(a, b)
    for a, b in zip(flatten(fopt.acc), flatten(opt.acc)):
        assert torch.equal(a, b)


def test_save_snapshots_before_it_returns(manager):
    """The writer thread packs a host copy: an in-place update right after
    save() does not reach the checkpoint (a CPU tensor's .numpy() shares
    its memory)."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8) / 64
    opt = init_momentum({"w": w})
    cm = manager(async_write=True)
    cm.save(1, ({"w": w}, opt))
    w.add_(1.0)
    opt.acc["w"].fill_(0.5)
    opt.step = 9
    cm.wait()
    tgt = ({"w": torch.zeros(8, 8)},
           MomentumState(acc={"w": torch.ones(8, 8)}, step=5))
    cm.restore(tgt)
    np.testing.assert_array_equal(tgt[0]["w"].numpy(),
                                  (w - 1.0).numpy())
    assert not tgt[1].acc["w"].any() and tgt[1].step == 0


# --------------------------------------------------------------------------
# qsave against the reference's
# --------------------------------------------------------------------------


def _cases():
    r = np.random.default_rng(0)
    return {
        "i8": r.integers(-127, 128, (5, 7)).astype(np.float32) * 2.0 ** -5,
        "i16": r.integers(-2 ** 12 + 1, 2 ** 12, (64,)).astype(np.float32)
        * 2.0 ** -12,
        "hilo": r.integers(-2 ** 23 + 1, 2 ** 23, (16, 9)).astype(
            np.float32) * 2.0 ** -23,
        "i32": r.integers(-2 ** 31 + 1, 2 ** 31, (33,)).astype(np.float64)
        * 2.0 ** -20,
        "raw_off_grid": np.array([1e-20, 1.0 + 2.0 ** -23] * 4, np.float32),
        "raw_int": r.integers(-128, 128, (3, 4)).astype(np.int8),
        "raw_nonfinite": np.array([1.0, np.inf, -2.5], np.float32),
        "zeros": np.zeros((2, 3), np.float32),
        "step": np.asarray(7, np.int32),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_pack_tree_matches_reference(case):
    arrays = {f"t/{case}": _cases()[case]}
    payload, fmt = qsave.pack_tree(arrays)
    jpayload, jfmt = jqsave.pack_tree(arrays)
    assert fmt == jfmt
    want_enc = case if case in qsave.ENCODINGS else (
        "i8" if case == "zeros" else "raw")
    assert fmt[f"t/{case}"]["enc"] == want_enc
    assert list(payload) == list(jpayload)
    for k in payload:
        assert payload[k].dtype == jpayload[k].dtype, k
        np.testing.assert_array_equal(payload[k], jpayload[k])
    a = arrays[f"t/{case}"]
    got = qsave.unpack_array(payload, f"t/{case}", fmt[f"t/{case}"])
    assert got.dtype == a.dtype and got.shape == a.shape
    assert got.tobytes() == a.tobytes()
    assert qsave.report(fmt) == jqsave.report(jfmt)


def test_export_int8_matches_reference():
    r = np.random.default_rng(3)
    w = (r.standard_normal((48, 40)) * 0.1).astype(np.float32)
    b = r.standard_normal(40).astype(np.float32)
    tree = {"w": torch.from_numpy(w), "b": [torch.from_numpy(b)],
            "step": torch.tensor(3, dtype=torch.int32)}
    ex = qsave.export_int8(tree)
    jex = jqsave.export_int8({"w": jnp.asarray(w), "b": [jnp.asarray(b)],
                              "step": jnp.int32(3)})
    for got, want in ((ex["w"], jex["w"]), (ex["b"][0], jex["b"][0])):
        assert isinstance(got, QTensor) and got.carrier is None
        assert got.data.dtype == torch.int8
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert float(got.scale) == float(want.scale)
    assert ex["step"] is tree["step"]
    _, fmt = qsave.pack_tree(flatten_with_paths(ex))
    assert set(fmt) == {"b/0/data", "b/0/scale", "step", "w/data",
                        "w/scale"}
    assert qsave.report(fmt)["ratio"] >= 3.0


# --------------------------------------------------------------------------
# the manager's semantics (as tests/test_checkpoint.py holds the reference)
# --------------------------------------------------------------------------


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "opt": {"acc": torch.ones(3, 4) * 0.5,
                    "step": torch.tensor(7, dtype=torch.int32)},
            "cache": torch.zeros(2, 2, dtype=torch.int8),
            "stages": [{"b": torch.full((2,), 0.25)}]}


def _zeroed(tree):
    return {"w": torch.zeros(3, 4),
            "opt": {"acc": torch.zeros(3, 4),
                    "step": torch.tensor(0, dtype=torch.int32)},
            "cache": torch.ones(2, 2, dtype=torch.int8),
            "stages": [{"b": torch.zeros(2)}]}


def test_roundtrip_in_place(manager):
    cm = manager(async_write=False)
    t = _tree()
    cm.save(10, t, aux={"loss": 1.25})
    tgt = _zeroed(t)
    keep = tgt["w"]
    got, step, aux = cm.restore(tgt)
    assert step == 10 and aux == {"loss": 1.25}
    assert got is tgt and got["w"] is keep
    for (ka, a), (kb, b) in zip(tree_keys(t), tree_keys(got)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_async_write_and_retention(manager):
    cm = manager(keep=2, async_write=True)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree())
    cm.wait()
    assert cm.all_steps() == [3, 4]


def test_latest_and_specific_step(manager):
    cm = manager(keep=5, async_write=False)
    t = _tree()
    cm.save(1, t)
    t["w"].mul_(2)
    cm.save(2, t)
    tgt = _zeroed(t)
    assert cm.restore(tgt)[1] == 2 and torch.equal(tgt["w"], t["w"])
    assert cm.restore(tgt, step=1)[1] == 1
    assert torch.equal(tgt["w"], t["w"] / 2)


def test_no_partial_checkpoint_visible(manager, tmp_path):
    cm = manager(async_write=False)
    os.makedirs(tmp_path / "ck" / "tmp-99")
    assert cm.all_steps() == []
    with pytest.raises(FileNotFoundError):
        cm.restore(_tree())


def test_packed_encoding_roundtrip(manager):
    r = np.random.default_rng(0)
    w = r.integers(-2 ** 23 + 1, 2 ** 23, (64, 32)).astype(np.float32) \
        * 2.0 ** -23
    acc = r.integers(-2 ** 12 + 1, 2 ** 12, (64,)).astype(np.float32) \
        * 2.0 ** -12
    off = np.array([1e-20, 1.0 + 2.0 ** -23] * 4, np.float32)
    tree = {"w": torch.from_numpy(w), "opt": {"acc": torch.from_numpy(acc)},
            "kv": torch.ones(4, dtype=torch.int8),
            "off": torch.from_numpy(off)}
    cm = manager(async_write=False)
    cm.save(1, tree)
    fmt = cm.meta(1)["qsave"]
    assert [fmt[k]["enc"] for k in ("w", "opt/acc", "kv", "off")] == \
        ["hilo", "i16", "raw", "raw"]
    rep = cm.size_report(1)
    assert rep["ckpt_bytes_q"] < rep["ckpt_bytes_f32_dense"]
    assert rep["disk_bytes"] > 0 and cm.last_report == cm.meta(1)["report"]
    tgt = {k: torch.zeros_like(v) for k, v in tree.items() if k != "opt"}
    tgt["opt"] = {"acc": torch.zeros(64)}
    cm.restore(tgt)
    for (_, a), (_, b) in zip(tree_keys(tree), tree_keys(tgt)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_restore_casts_to_target_dtype(manager):
    """Leaf dtypes follow the target: a float64 leaf restores into a
    float32 tensor, an int leaf into a Python int, an array leaf as an
    array of the target's dtype."""
    cm = manager(async_write=False)
    cm.save(1, {"w": np.arange(8, dtype=np.float64) / 3, "n": 5,
                "a": np.ones(2, np.float32)})
    tgt = {"w": torch.zeros(8), "n": 0, "a": np.zeros(2, np.float64)}
    cm.restore(tgt)
    assert tgt["w"].dtype == torch.float32
    np.testing.assert_array_equal(tgt["w"].numpy(),
                                  (np.arange(8) / 3).astype(np.float32))
    assert tgt["n"] == 5 and type(tgt["n"]) is int
    assert tgt["a"].dtype == np.float64 and (tgt["a"] == 1).all()


def test_restore_array_set_mismatch(manager):
    cm = manager(async_write=False)
    cm.save(1, {"w": torch.zeros(3), "b": torch.zeros(2)})
    before = torch.full((3,), 5.0)
    with pytest.raises(ValueError, match="extra"):
        cm.restore({"w": before, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="b"):
        cm.restore({"w": before})
    with pytest.raises(ValueError, match="shape"):
        cm.restore({"w": before, "b": torch.zeros(4)})
    assert (before == 5.0).all()          # nothing copied before the checks


def test_tmp_sweep_and_failed_publish(manager, tmp_path):
    cm = manager(async_write=True)
    cm.save(1, _tree())
    cm.wait()
    cm._fail_next_write = True
    cm.save(2, _tree())
    with pytest.raises(RuntimeError, match="injected"):
        cm.wait()
    assert cm.latest_step() == 1
    assert os.path.isdir(tmp_path / "ck" / "tmp-2")
    cm2 = manager()
    assert not os.path.isdir(tmp_path / "ck" / "tmp-2")
    assert cm2.latest_step() == 1


def test_unpacked_mode(manager, tmp_path):
    cm = manager(async_write=False, packed=False)
    t = _tree()
    cm.save(1, t)
    assert "qsave" not in cm.meta(1)
    with open(tmp_path / "ck" / "step-0000000001" / "meta.json") as f:
        assert json.load(f)["step"] == 1
    tgt = _zeroed(t)
    cm.restore(tgt)
    for (_, a), (_, b) in zip(tree_keys(t), tree_keys(tgt)):
        assert torch.equal(a, b)


def test_qtensor_leaves_roundtrip(manager):
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) / 32.0
    qt = get_quantizer("scaled", 8).quantize(x)
    tree = {"cache": {"k": qt}, "step": 3}
    assert [k for k, _ in tree_keys(tree)] == ["cache/k/data",
                                               "cache/k/scale", "step"]
    cm = manager(async_write=False)
    cm.save(1, tree)
    tgt = {"cache": {"k": QTensor(torch.zeros(4, 6, dtype=torch.int8),
                                  torch.zeros(()), 8)}, "step": 0}
    cm.restore(tgt)
    assert tgt["step"] == 3
    assert torch.equal(tgt["cache"]["k"].dequantize(), qt.dequantize())
