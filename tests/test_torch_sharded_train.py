"""The port's data-parallel sharded step (repro_torch.launch.train
make_sharded_train_step, launch/shard.py, launch/mesh.py) against the JAX
reference and against itself across layouts.

  Against the reference: the port at dp=1, n_shards=4 beside the
     reference's make_sharded_train_step on make_cpu_mesh(1, 1),
     n_shards=4, 2 steps from the same weights (tests/test_sharded_train.py's
     t-lm in full8 and e2_16, t-moe and t-rn), held to the bounds that
     tests/test_torch_train.py applies to make_train_step: the loss of each
     step within 2e-3 relative; the "w" leaves' codes (on 2^-23) after step
     1 differing in at most 0.1%, at most 26 apart (one CQ step times lr),
     after step 2 within the 5-step bounds (full8: 95%, 8192 codes; e2_16:
     1%, 1024); the accumulator's "w" leaves the same, in the units of the
     update they make (lr * acc on 2^-23).  `-s` prints every gap
     (measured on the CPU: 0 but one code in 73728 at t-rn's step 2, 26
     apart).
  Across layouts, bitwise on every parameter and accumulator leaf: one
     process (dp=1) against gloo worlds of 2 and 4 ranks
     (tests/torch_dist.py, one world per size, every case in it), all at
     n_shards=4: t-lm, t-moe, t-rn and falcon-mamba-7b.reduced() (the
     selective scan's and K9b's plain versions) on the default wire (16
     bits, packed), wire 8 at dp=4 (packed and leaf), the leaf codec, and
     ZeRO-1 (t-lm and t-rn: quantized and exempt leaves); every rank ends
     with the same parameters.  One intra-op thread everywhere: the fp32
     CPU products sum in an order that depends on the thread count.
  The wire: a recording transport (compress.TRACE) shows that with
     grad_sync="int_ring" every gradient message is the hop's integer
     dtype (int16 at 16 bits; int8 pairs packed two-per-int16 at 8), every
     gather int32, and the only fp32 collectives the scales' max and the
     loss's mean; grad_sync="psum" is the positive control and sends fp32
     gradients.
  zero_reshard from dp 2 to dp 4 equals the reference's and the dp=4
     world's own accumulator.
  The CLI: --dp 2 --n-shards 4 --device cpu spawns its two ranks, prints
     the reference's [shard] banner, and writes a checkpoint equal, byte
     for byte, to the library's dp=1 n_shards=4 run; the reference's
     CheckpointManager restores it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import get as jget
from repro.configs.base import ArchConfig as JArch
from repro.core import preset as jpreset
from repro.data import ImageTask as JImageTask
from repro.data import TokenTask as JTokenTask
from repro.launch import shard as JS
from repro.launch.mesh import make_cpu_mesh as jmake_cpu_mesh
from repro.launch.train import make_sharded_train_step as jmake_sharded
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import get
from repro_torch.convert import params_from_jax, resnet_params_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch import mesh as M
from repro_torch.launch import shard as S
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import flatten, fixed_point_lr, init_momentum

import torch_dist as TD
from torch_parity import exact_pow2_patched


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the port at dp=1 against the reference's sharded step
# --------------------------------------------------------------------------

REF_RUNS = (("lm", "full8"), ("lm", "e2_16"), ("moe", "full8"),
            ("resnet", "full8"))
BOUNDS = {"full8": dict(share=0.95, dist=8192),
          "e2_16": dict(share=0.01, dist=1024)}


def _ref_run(name: str, pname: str) -> dict:
    """tests/test_sharded_train.py's train() at dp=1, n_shards=4, 2 steps:
    the initial params, each step's loss and params, the final
    accumulator (the last three in the port's layout and leaf order)."""
    a = JArch(**TD.ARCHS[name])
    mesh = jmake_cpu_mesh(1, 1)
    qcfg = jpreset(pname, "native")
    model = jbuild(a, qcfg)
    params = model.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, params)
    opt = jinit_momentum(params)
    raw, specs = jmake_sharded(model, qcfg, model.labels(params), mesh,
                               params, n_shards=TD.N_SHARDS)
    step = jax.jit(raw)
    params = JS.shard_arrays(mesh, params, specs["params"])
    opt = JS.shard_arrays(mesh, opt, specs["opt"])
    task = (JImageTask(img_size=a.img_size, num_classes=a.num_classes,
                       global_batch=8) if name == "resnet"
            else JTokenTask(vocab=a.vocab, seq_len=16, global_batch=8))
    conv = resnet_params_from_jax if name == "resnet" else params_from_jax

    def port_leaves(tree):
        return [t.numpy() for t in flatten(conv(jax.tree.map(np.asarray,
                                                             tree)))]
    out = {"init": init, "losses": [], "params": []}
    for s in range(TD.STEPS):
        params, opt, m = step(params, opt, JS.put_batch(mesh, task.batch(s)),
                              jnp.int32(s))
        out["losses"].append(float(m["loss"]))
        out["params"].append(port_leaves(params))
    out["acc"] = port_leaves(opt.acc)
    return out


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def run(name, pname):
        if (name, pname) not in runs:
            with exact_pow2_patched():
                runs[name, pname] = _ref_run(name, pname)
        return runs[name, pname]
    return run


def _code_gap(got: list, want: list, idx: list, unit: float):
    d = np.concatenate([np.abs(got[i].astype(np.float64) - want[i]).ravel()
                        * unit for i in idx])
    return float(np.mean(d > 0)), float(d.max())


@pytest.mark.parametrize("name,pname", REF_RUNS,
                         ids=[f"{n}-{p}" for n, p in REF_RUNS])
def test_dp1_within_bounds_of_reference(name, pname, reference):
    ref = reference(name, pname)
    got = TD.train(name, pname, init=ref["init"])
    w = [i for i, lab in enumerate(got["labels"]) if lab == "w"]
    assert w and got["opt_step"] == TD.STEPS
    for s in range(TD.STEPS):
        rel = abs(got["losses"][s] - ref["losses"][s]) / ref["losses"][s]
        share, dist = _code_gap(got["params"][s], ref["params"][s], w,
                                2.0 ** 23)
        print(f"{name} {pname} step {s + 1}: loss rel {rel:.3e} (bound "
              f"2e-3), w codes differing {share:.6f}, max distance "
              f"{dist:.0f}")
        assert rel <= 2e-3
        b = (dict(share=1e-3, dist=26) if s == 0 else BOUNDS[pname])
        assert share <= b["share"] and dist <= b["dist"], (s, share, dist)
    lr = fixed_point_lr(0.05, preset(pname))
    share, dist = _code_gap(got["acc"], ref["acc"], w, lr * 2.0 ** 23)
    print(f"{name} {pname} accumulator after {TD.STEPS} steps: differing "
          f"{share:.6f}, max distance {dist:.0f} update codes")
    assert share <= BOUNDS[pname]["share"] and dist <= BOUNDS[pname]["dist"]


# --------------------------------------------------------------------------
# the port across layouts (dp 1, 2 and 4), bitwise
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process():
    runs = {}

    def run(key, **kw):
        if key not in runs:
            runs[key] = TD.train(**kw)
        return runs[key]
    return run


_WORLDS: dict = {}


def _world(n: int):
    """The gloo world of n ranks and its results, made once per module."""
    if n not in _WORLDS:
        _WORLDS[n] = TD.run_world(n, "torch_dist:sharded_cases")
    return n, _WORLDS[n]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    return _world(request.param)


def _acc(run: dict) -> list:
    """The accumulator's leaves as flat (size,) arrays: a ZeRO-1 run's flat
    (dp * chunk,) leaves lose their zero padding, a replicated run's are
    flattened."""
    out = []
    for a, p in zip(run["acc"], run["params"][-1]):
        flat = a.reshape(-1)
        assert not flat[p.size:].any()
        out.append(flat[: p.size])
    return out


def _equal(a: dict, b: dict) -> None:
    for got, want in zip(a["params"][-1] + _acc(a),
                         b["params"][-1] + _acc(b)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert a["opt_step"] == b["opt_step"] == TD.STEPS


@pytest.mark.parametrize("key", [k for k, _ in TD.WORLD_RUNS])
def test_dp_invariance(world, key, one_process):
    n, res = world
    want = one_process(key, **dict(TD.WORLD_RUNS)[key])
    for r in range(n):
        _equal(res[r][key], want)


def test_wire8_dp4_equals_dp1(one_process):
    n, res = _world(4)
    for key, kw in TD.WIRE8_RUNS:
        want = one_process(key, **kw)
        for r in range(n):
            _equal(res[r][key], want)
    # a coarser grid: not the 16-bit wire's weights
    assert any(not np.array_equal(x, y) for x, y in zip(
        want["params"][-1], one_process("lm", name="lm")["params"][-1]))


def test_packed_equals_leaf_and_zero1_equals_replicated(world):
    n, res = world
    for r in range(n):
        _equal(res[r]["lm_leaf"], res[r]["lm"])
        _equal(res[r]["lm_zero1"], res[r]["lm"])
        _equal(res[r]["resnet_zero1"], res[r]["resnet"])


def test_int_ring_messages_are_integers(world):
    n, res = world
    n_leaves = len(res[0]["lm"]["params"][-1])
    for r in range(n):
        for key, hop in (("packed", "torch.int16"), ("leaf", "torch.int16"),
                         ("packed8", "torch.int16")):
            trace = res[r][("trace", key)]
            kinds = {(w, d) for w, d, _ in trace}
            assert kinds == {("amax", "torch.float32"), ("hop", hop),
                             ("gather", "torch.int32"),
                             ("loss", "torch.float32")}, (key, kinds)
            amax = [s for w, _, s in trace if w == "amax"]
            assert amax == ([(n_leaves,)] if key.startswith("packed")
                            else [()] * n_leaves)
            assert [s for w, _, s in trace if w == "loss"] == [()]
        # positive control: the fp32 baseline sends fp32 gradients
        psum = res[r][("trace", "psum")]
        assert sum(w == "psum" and d == "torch.float32" and s != ()
                   for w, d, s in psum) == n_leaves
        assert not any(w in ("hop", "gather") for w, _, _ in psum)


def test_zero_reshard(world, one_process):
    """The world's ZeRO-1 accumulator (dp 2 or 4 chunks) re-chunked for dp
    4 by the port equals the reference's zero_reshard of it, the one
    process's (dp 1) re-chunked the same way, and in the world of 4 the
    world's own; back to dp n it is the world's again."""
    n, res = world
    shapes = [p.shape for p in res[0]["lm"]["params"][-1]]
    params = [np.zeros(sh, np.float32) for sh in shapes]
    acc = res[0]["lm_zero1"]["acc"]
    assert [a.shape for a in acc] == \
        [(n * S.zero_chunk_len(int(np.prod(sh)), n),) for sh in shapes]
    got = S.zero_reshard(acc, params, 4)
    want = JS.zero_reshard(acc, params, 4)
    one = S.zero_reshard(one_process("lm_zero1", name="lm",
                                     opt_shard="zero1")["acc"], params, 4)
    for g, w, o, sh in zip(got, want, one, shapes):
        assert g.shape == (4 * S.zero_chunk_len(int(np.prod(sh)), 4),)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.tobytes() == o.tobytes()
    if n == 4:
        for g, a in zip(got, acc):
            assert g.tobytes() == a.tobytes()
    for a, b in zip(S.zero_reshard(got, params, n), acc):
        assert a.tobytes() == b.tobytes()


def test_zero_layout_matches_reference():
    params = {"a": torch.zeros(5, 3), "b": [torch.zeros(7), torch.zeros(1)]}
    jparams = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), params)
    for dp in (1, 2, 3, 4):
        got = S.zero_init_momentum(params, dp)
        want = JS.zero_init_momentum(jparams, dp)
        assert [tuple(t.shape) for t in flatten(got.acc)] == \
            [x.shape for x in jax.tree.leaves(want.acc)]
        tmpl = S.zero_template(params, dp)
        assert [x.shape for x in flatten(tmpl.acc)] == \
            [x.shape for x in jax.tree.leaves(JS.zero_template(jparams,
                                                               dp).acc)]
        assert S.zero_chunk_len(15, dp) == JS.zero_chunk_len(15, dp)


def test_zero1_update_equals_momentum_update_bytes():
    """Weights that round to zero from below, in a "w" and a "gamma" leaf
    (the k_WU grid) and an exempt leaf (fp32): momentum_update and the
    ZeRO-1 update (dp=1: the flat chunk, the grid leaves' int32 codes
    decoded) end with the same bytes, the grid's zero as +0.0."""
    from repro_torch.core import qfuncs as qf
    from repro_torch.core import prng
    from repro_torch.optim import MomentumState, momentum_update
    cfg = preset("full8")
    lr = fixed_point_lr(0.05, cfg)
    g = 2.0 ** (1 - cfg.k_wu)
    assert torch.signbit(qf.q_direct(torch.tensor([-0.3 * g]), cfg.k_wu))
    vals = [-0.3 * g, -0.6 * g, 0.2 * g, -0.5 * g, 0.5, -0.25, 1.0 - g]

    def tree():
        return {"w": torch.tensor(vals * 3).reshape(3, 7),
                "gamma": torch.tensor(vals), "e": torch.tensor(vals)}
    labels = {"w": "w", "gamma": "gamma", "e": "exempt"}
    grads = {k: torch.zeros_like(v) for k, v in tree().items()}
    key = prng.fold_in(prng.prng_key(ttrain.SEED), 1)
    pa, pb = tree(), tree()
    momentum_update(cfg, pa, grads, MomentumState(acc={
        k: torch.zeros_like(v) for k, v in pa.items()}), labels, key, lr)
    ttrain._zero1_update(cfg, pb, grads, S.zero_init_momentum(pb, 1),
                         labels, key, lr, 0.75, None, M.Mesh(dp=1))
    for k in pa:
        assert pa[k].numpy().tobytes() == pb[k].numpy().tobytes(), k
    for k in ("w", "gamma"):
        zeros = pa[k] == 0
        assert zeros.sum() >= 3 and not torch.signbit(pa[k][zeros]).any()


# --------------------------------------------------------------------------
# mesh, batch split and refusals
# --------------------------------------------------------------------------


def test_mesh_and_batch_split():
    mesh = M.make_cpu_mesh(1)
    assert (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
    assert S.mesh_dims(mesh) == (1, 1)
    assert M.mesh_axes(mesh) == (("data",), "model")
    assert (S.DATA_AXIS, S.MODEL_AXIS) == (JS.DATA_AXIS, JS.MODEL_AXIS)
    with pytest.raises(ValueError, match="process group of 2"):
        M.make_cpu_mesh(2)
    with pytest.raises(NotImplementedError, match="item 5"):
        M.make_cpu_mesh(1, 2)
    batch = TokenTask(64, 8, 8).batch(0)
    for dp in (1, 2, 4):
        parts = [S.put_batch(M.Mesh(dp=dp, rank=r), batch)
                 for r in range(dp)]
        for k in batch:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), batch[k])
    with pytest.raises(ValueError, match="divide by dp=3"):
        S.put_batch(M.Mesh(dp=3), batch)


def test_sharded_step_refusals():
    cfg = preset("full8")
    model = build_model(TD.port_arch("lm"), cfg, device="cpu").init(0)
    with pytest.raises(ValueError, match="multiple of dp=2"):
        ttrain.make_sharded_train_step(model, cfg, mesh=M.Mesh(dp=2),
                                       n_shards=3)
    with pytest.raises(NotImplementedError, match="item 5"):
        ttrain.make_sharded_train_step(model, cfg, mesh=M.Mesh(dp=1, tp=2))
    step = ttrain.make_sharded_train_step(model, cfg, n_shards=3)
    with pytest.raises(ValueError, match="must divide by n_shards=3"):
        step(init_momentum(model.params()), TokenTask(64, 8, 8).batch(0), 0)


def test_sharded_step_times_its_parts():
    """`stats` (the card run's split) gathers each part's seconds."""
    cfg = preset("full8")
    model = build_model(TD.port_arch("lm"), cfg, device="cpu").init(0)
    stats: dict = {}
    step = ttrain.make_sharded_train_step(model, cfg, n_shards=2,
                                          stats=stats)
    opt = init_momentum(model.params())
    for s in range(2):
        step(opt, TokenTask(64, 8, 4).batch(s), s)
    assert set(stats) == {"fwd_bwd", "sync", "opt"}
    assert all(v > 0 for v in stats.values()) and opt.step == 2


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_cli_dp2_checkpoint_equals_library(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--arch", "granite-3-8b", "--reduced", "--steps", "2",
            "--batch", "8", "--seq", "16", "--device", "cpu",
            "--save-every", "2"]
    cli = str(tmp_path / "cli")
    ttrain.main(argv + ["--dp", "2", "--n-shards", "4", "--ckpt-dir", cli])
    out = capsys.readouterr().out
    assert ("[shard] mesh dp=2 tp=1 n_shards=4 wire=int_ring:16b "
            "codec=leaf (gloo:") in out and "opt=replicated" in out
    assert "step     1 loss" in out
    # the library at dp=1, n_shards=4 on the same batches
    cfg = preset("full8")
    model = build_model(get("granite-3-8b").reduced(), cfg,
                        device="cpu").init(0)
    opt = init_momentum(model.params())
    step = ttrain.make_sharded_train_step(model, cfg, lr=0.05, n_shards=4)
    task = TokenTask(model.a.vocab, 16, 8)
    for s in range(2):
        step(opt, task.batch(s), s)
    lib = str(tmp_path / "lib")
    CheckpointManager(lib, async_write=False).save(2, (model.params(), opt))
    with np.load(f"{cli}/step-0000000002/arrays.npz") as x, \
            np.load(f"{lib}/step-0000000002/arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            assert x[k].tobytes() == y[k].tobytes(), k
    # the reference's manager restores it
    jm = jbuild(jget("granite-3-8b").reduced(), jpreset("full8", "native"))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jopt = jax.eval_shape(jinit_momentum, jparams)
    tree, at, _ = JManager(cli).restore((jparams, jopt))
    assert at == 2 and int(tree[1].step) == 2
    restored = _flatten_with_paths(tree)
    want = flatten_with_paths((model.params(), opt))
    assert list(restored) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(restored[k], a, k)
