"""gloo worlds for the port's data-parallel tests (no JAX here).

`run_world(n, "module:function", **kw)` starts n processes on 127.0.0.1,
each joining one gloo group and calling function(rank, n, **kw) with one
intra-op thread; every rank's return value (numpy arrays, numbers,
strings and containers of them) comes back to the caller, a list in rank
order.  A rank that fails or outlives `timeout` fails the world and kills
the others.  The functions below are the cases the test files run in
their worlds: one world per size per file, every case in it.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, target: str, timeout: float = 300, **kw) -> list:
    with tempfile.TemporaryDirectory() as out:
        with open(os.path.join(out, "kw.pkl"), "wb") as f:
            pickle.dump(kw, f)
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
                   TORCH_DIST_TARGET=target, TORCH_DIST_OUT=out,
                   PYTHONPATH=os.pathsep.join(
                       [_SRC, _TESTS] + ([path] if path else [])))
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import torch_dist; torch_dist._worker()"],
            env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            assert p.returncode == 0, (
                f"rank {r} of {n} ({target}) exited with {p.returncode}:\n"
                + logs[r][-4000:])
        results = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _worker() -> None:
    import importlib

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out = os.environ["TORCH_DIST_OUT"]
    with open(os.path.join(out, "kw.pkl"), "rb") as f:
        kw = pickle.load(f)
    mod, fn = os.environ["TORCH_DIST_TARGET"].split(":")
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=n)
    try:
        res = getattr(importlib.import_module(mod), fn)(rank, n, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# --------------------------------------------------------------------------
# inputs both the ranks and the checking process can make
# --------------------------------------------------------------------------

# (hop bits, pack, buckets) of the ring cases
RING_CASES = ((16, False, 1), (16, False, 2), (8, True, 1), (8, True, 2),
              (8, False, 1), (32, False, 2))
RING_SHAPES = ((37,), (5, 7), (1,))
SYNC_BITS = (16, 8, 4)
SYNC_SHARDS = 4


def ring_input(rank: int, n: int, bits: int, shape) -> np.ndarray:
    """int32 contributions whose every partial sum fits the hop width."""
    lim = (2 ** (bits - 1) - 1) // n
    rng = np.random.default_rng([rank, bits, *shape])
    x = rng.integers(-lim, lim + 1, size=shape, dtype=np.int64)
    x.flat[0] = lim if rank % 2 else -lim        # the bound itself
    return x.astype(np.int32)


def grad_tree(rank: int, n: int, vs: int) -> dict:
    """(vs, *shape) fp32 virtual-shard gradients of rank `rank` in a world
    of n (virtual shards rank*vs .. rank*vs+vs-1 of n*vs): the same global
    shards on any layout."""
    shards = [_grad_shard(v) for v in range(rank * vs, (rank + 1) * vs)]
    return {k: np.stack([s[k] for s in shards]) for k in shards[0]}


def _grad_shard(v: int) -> dict:
    rng = np.random.default_rng(1000 + v)
    def g(*shape, scale=1e-3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": g(3, 5), "b": g(7, scale=2.0 ** -9), "z": np.zeros(
        (2, 2), np.float32), "big": g(4, 9, scale=10.0)}


def flat_input(rank: int, shape=(5, 9)) -> np.ndarray:
    rng = np.random.default_rng(2000 + rank)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


# --------------------------------------------------------------------------
# the compress cases
# --------------------------------------------------------------------------


def compress_cases(rank: int, n: int) -> dict:
    import torch

    from repro_torch.optim import flatten
    from repro_torch.runtime import compress as C
    res: dict = {"rank": C.group_rank(), "size": C.group_size()}
    for bits, pack, buckets in RING_CASES:
        for shape in RING_SHAPES:
            x = torch.from_numpy(ring_input(rank, n, bits, shape))
            C.TRACE = []
            y = C.ring_allreduce_int(x, None, n, bits, pack=pack,
                                     buckets=buckets)
            res[("ring", bits, pack, buckets, shape)] = (
                y.numpy(), [(w, str(d), s) for w, d, s in C.TRACE])
    C.TRACE = None
    vs = SYNC_SHARDS // n
    tree = {k: torch.from_numpy(v) for k, v in grad_tree(rank, n, vs).items()}
    for bits in SYNC_BITS:
        C.TRACE = []
        packed = C.wire_sync_tree(tree, None, n_shards=SYNC_SHARDS, n_dev=n,
                                  bits=bits)
        trace_tree = [(w, str(d), s) for w, d, s in C.TRACE]
        C.TRACE = []
        leaf = {k: C.wire_sync_mean(g, None, n_shards=SYNC_SHARDS, n_dev=n,
                                    bits=bits) for k, g in tree.items()}
        trace_leaf = [(w, str(d), s) for w, d, s in C.TRACE]
        C.TRACE = None
        res[("sync", bits)] = (
            {k: v.numpy() for k, v in packed.items()},
            {k: v.numpy() for k, v in leaf.items()}, trace_tree, trace_leaf,
            len(flatten(tree)))
    for bits in (16, 8):
        x = torch.from_numpy(flat_input(rank))
        res[("psum", bits)] = C.compressed_psum_int(x, None, bits).numpy()
        res[("rs", bits)] = C.ring_reduce_scatter_int(x, None, bits).numpy()
    return res


# --------------------------------------------------------------------------
# the sharded-step cases
# --------------------------------------------------------------------------

# tests/test_sharded_train.py's configs (the reference's ArchConfig takes
# the same fields); "ssm" is falcon-mamba-7b.reduced()
ARCHS = {
    "lm": dict(name="t-lm", family="lm", n_layers=2, d_model=32, n_heads=2,
               n_kv=2, d_ff=64, vocab=64, head_dim=16, q_chunk=16,
               kv_chunk=16),
    "moe": dict(name="t-moe", family="moe", n_layers=2, d_model=32,
                n_heads=2, n_kv=2, d_ff=48, vocab=64, head_dim=16,
                q_chunk=16, kv_chunk=16, moe_experts=4, moe_topk=2),
    "resnet": dict(name="t-rn", family="resnet", block="basic",
                   stage_sizes=(1,), num_classes=10, img_size=16),
}
FAMILIES = ("lm", "moe", "resnet", "ssm")
N_SHARDS = 4
STEPS = 2


def port_arch(name: str):
    from repro_torch.configs import get
    from repro_torch.configs.base import ArchConfig
    if name == "ssm":
        return get("falcon-mamba-7b").reduced()
    return ArchConfig(**ARCHS[name])


def task_for(name: str, acfg, batch: int = 8):
    from repro_torch.data import ImageTask, TokenTask
    if name == "resnet":
        return ImageTask(acfg.img_size, acfg.num_classes, batch)
    return TokenTask(acfg.vocab, 16, batch)


def train(name: str, pname: str = "full8", steps: int = STEPS,
          n_shards: int = N_SHARDS, init=None, trace: bool = False,
          **kw) -> dict:
    """`steps` sharded steps of a model built from seed 0 (or loaded from
    `init`, a params tree in the reference layout) over every rank of the
    default group (one process when there is none).  Returns the params
    after each step and the accumulator at the end (gathered into the
    global layout), as numpy leaves in flatten order, the losses, and with
    `trace` the messages of the last step."""
    from repro_torch.core import preset
    from repro_torch.launch import shard as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import flatten, init_momentum
    from repro_torch.runtime import compress as C
    acfg = port_arch(name)
    cfg = preset(pname)
    model = build_model(acfg, cfg, device="cpu").init(0)
    if init is not None:
        model.load_params(init)
    mesh = make_mesh()
    params = model.params()
    zero1 = kw.get("opt_shard") == "zero1"
    opt = (S.zero_init_momentum(params, mesh.dp) if zero1
           else init_momentum(params))
    specs = (S.zero_opt_specs(params) if zero1
             else S.opt_specs(S.param_specs(params)))
    opt = S.shard_arrays(mesh, opt, specs)
    step = make_sharded_train_step(model, cfg, mesh=mesh, n_shards=n_shards,
                                   **kw)
    task = task_for(name, acfg)
    out = {"losses": [], "params": []}
    for s in range(steps):
        C.TRACE = [] if trace else None
        m = step(opt, S.put_batch(mesh, task.batch(s)), s)
        out["trace"] = [(w, str(d), sh) for w, d, sh in C.TRACE or ()]
        C.TRACE = None
        out["losses"].append(float(m["loss"]))
        out["params"].append([p.detach().numpy().copy()
                              for p in flatten(params)])
    whole = S.gather_arrays(mesh, opt, specs)
    out["acc"] = [a.numpy().copy() for a in flatten(whole.acc)]
    out["opt_step"] = opt.step
    out["labels"] = flatten(model.labels())
    return out


# the runs every world makes: (key, train kwargs); the wire-8 runs only in
# the world of 4 (held against one process)
WORLD_RUNS = tuple((f, dict(name=f)) for f in FAMILIES) + (
    ("lm_leaf", dict(name="lm", wire_codec="leaf")),
    ("lm_zero1", dict(name="lm", opt_shard="zero1")),
    ("resnet_zero1", dict(name="resnet", opt_shard="zero1")),
)
WIRE8_RUNS = (("lm_wire8", dict(name="lm", wire_bits=8)),
              ("lm_wire8_leaf", dict(name="lm", wire_bits=8,
                                     wire_codec="leaf")))
# one step each, every message recorded
TRACE_RUNS = (("packed", dict(wire_codec="packed")),
              ("leaf", dict(wire_codec="leaf")),
              ("packed8", dict(wire_codec="packed", wire_bits=8)),
              ("psum", dict(grad_sync="psum")))


def sharded_cases(rank: int, n: int) -> dict:
    res = {key: train(**kw) for key, kw in WORLD_RUNS}
    if n == 4:
        res.update({key: train(**kw) for key, kw in WIRE8_RUNS})
    for key, kw in TRACE_RUNS:
        res[("trace", key)] = train("lm", steps=1, trace=True,
                                    **kw)["trace"]
    return res
