"""The training step and its command-line entry point (single device).

Port of `repro.launch.train.make_train_step` and its CLI.  One step is the
full WAGEUBN loop: the quantized forward (`model.loss`), the quantized
backward (`loss.backward()` through the port's autograd Functions: Q_E1 in
qact, Q_E2 fused into the dgrad/wgrad kernels or before the ResNet's
convolution gradients, the flash kernel's forward with the plain chunked
body's backward, the UBN kernel's forward with the unfused body's
backward), then CQ/Q gradient quantization, quantized Momentum and the
fixed-point update (`optim/momentum.py`).  The stochastic-rounding key is
fold_in(PRNGKey(17), step), then fold_in(., 1) for the optimizer, as in
the reference, so the bits are a pure function of the step index.  The
step is the same in every numeric mode (`--mode native|sim|fp32`, native
by default, core/qconfig.py): sim takes the quantizers' grid values
through fp32 products, the unfused norm and attention bodies; fp32
(`--mode fp32`, or `--preset fp32`, which ignores `--mode` as the
reference's CLI does) is the vanilla float baseline with plain Momentum.

    python -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --mode native --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch falcon-mamba-7b --reduced \
        --mode native --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --reduced --mode native --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch zamba2-7b --reduced \
        --mode native --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch resnet50 --reduced \
        --mode native --steps 3 --batch 4 --device cpu
    python -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --mode sim --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --preset fp32 --steps 3 --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train ... --ckpt-dir DIR --save-every 2
    python -m repro_torch.launch.train ... --ckpt-dir DIR --resume

The LMs (dense, MoE, SSM and the hybrid) train on TokenTask ("arith"); a
ResNet on the synthetic ImageTask at its config's image size and classes,
or on npz shards under `--data-dir` (data/imagenet.py).  With `--ckpt-dir`
the CLI saves
(parameters, MomentumState) after every `--save-every` steps
(checkpoint/manager.py, the reference's format); with `--resume` it
restores the latest checkpoint there and continues from its step, which
gives the same weights as an unbroken run, since the stochastic-rounding
bits depend on the step index alone.  `make_train_step(..., n_micro=N)`
accumulates the gradients of N microbatches, as the reference's does.
The enc-dec (seamless-m4t-large-v2) trains through `make_train_step` on
{"frames", "tokens", "labels"} batches; the CLI, like the reference's,
has no frames task for it.

`make_sharded_train_step` is the data-parallel step of the reference's
`make_sharded_train_step` (its DESIGN.md §9 production step) over a
torch.distributed process group: each rank runs its n_shards/dp virtual
batch shards, the gradients meet on the integer wire
(runtime/compress.py), and the weights after a step are a pure function
of (global batch, n_shards), whatever dp is.  `--dp N` (N > 1) takes it:
under a launcher (torchrun's WORLD_SIZE, RANK, LOCAL_RANK and
MASTER_ADDR/PORT) the CLI joins the launcher's group, gloo on
`--device cpu` and nccl on cuda (one rank a card); without one it
spawns N ranks on 127.0.0.1 itself and prints rank 0's output.  With
`--opt-shard zero1` each rank keeps its chunk of the accumulator, and
checkpoints hold it gathered, in the reference's flat layout.

    python -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --steps 3 --batch 8 --seq 32 --device cpu --dp 2 --n-shards 4
    python -m repro_torch.launch.train ... --dp 2 --opt-shard zero1 \
        --wire-bits 8 --wire-codec packed

Not ported yet (each raises NotImplementedError naming ROADMAP Queue 1
item 5): --tp, --elastic and --rebalance-flags.
"""
from __future__ import annotations

import argparse
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as get_arch
from repro_torch.core import prng
from repro_torch.core.qconfig import preset
from repro_torch.data import ImageTask, NpzImageTask, TokenTask
from repro_torch.launch import shard as S
from repro_torch.launch.mesh import TP_UNPORTED, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import (apply_leaf_update, dr_bits_schedule,
                               fixed_point_lr, flatten, init_momentum,
                               momentum_update, parse_boundaries,
                               quantize_grad_leaf, tree_map, unflatten)
from repro_torch.runtime.compress import (all_gather, all_reduce,
                                          default_wire_codec, wire_sync_mean,
                                          wire_sync_tree)

SEED = 17

UNPORTED = ("is not ported yet: tensor parallelism (step 2b) and the "
            "elastic runtime (step 3) are ROADMAP Queue 1 item 5")


def make_train_step(model, qcfg, labels_tree=None, lr: float = 0.05,
                    mom: float = 0.75, dr_bits: int | None = None,
                    n_micro: int = 1):
    """The training step for `model` (an LMTransformer, dense or MoE, an
    SSMLM, a Zamba2 (the shared block's gradient is the sum over its
    applications, which autograd accumulates), an EncDec or a ResNet: a
    module holding its parameters, with
    `loss(batch) -> (loss, metrics)`, `params()` and `labels()`):
    step(opt_state, batch, step_idx) -> the loss's metrics ({"loss"}, and
    "acc" for the ResNet) as 0-d tensors, updating the model's parameters
    and opt_state.acc IN PLACE.

    dr_bits: CQ range width for this step (None = qcfg.k_gw, the schedule
    base).  n_micro > 1 splits the leading dim of every batch entry (the
    enc-dec's "frames", "tokens" and "labels" alike) into n_micro equal
    microbatches run one after another (each graph freed before the next,
    so activation memory scales down; BN statistics per microbatch) and
    takes the mean of their gradients, summed in fp32 from zeros in
    microbatch order and divided by n_micro, as the reference does; the
    metrics are then {"loss"}, the mean of the microbatch losses."""
    if n_micro < 1:
        raise ValueError(f"n_micro={n_micro} must be >= 1")
    lrq = fixed_point_lr(lr, qcfg)
    labels = model.labels() if labels_tree is None else labels_tree

    def backward(batch: dict) -> dict:
        """The loss's metrics; leaves the batch's gradient in each .grad."""
        model.zero_grad(set_to_none=True)
        if n_micro == 1:
            loss, metrics = model.loss(batch)
            loss.backward()
            return metrics
        b = len(next(iter(batch.values())))
        if b % n_micro:
            raise ValueError(f"n_micro={n_micro} does not divide the batch "
                             f"of {b}")
        mb = b // n_micro
        leaves = flatten(model.params())
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses = []
        for i in range(n_micro):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss({k: v[i * mb:(i + 1) * mb]
                                  for k, v in batch.items()})
            loss.backward()          # frees this microbatch's graph
            losses.append(loss.detach())
            for a, p in zip(acc, leaves):
                a.add_(p.grad)
        for a, p in zip(acc, leaves):
            p.grad = a.div_(n_micro)
        return {"loss": torch.stack(losses).mean()}

    def train_step(opt_state, batch: dict, step_idx: int) -> dict:
        key = prng.fold_in(prng.prng_key(SEED), step_idx)
        metrics = backward(batch)
        params = model.params()
        grads = _grad_tree(params)
        momentum_update(qcfg, params, grads, opt_state, labels,
                        prng.fold_in(key, 1), lrq, mom=mom, dr_bits=dr_bits)
        model.zero_grad(set_to_none=True)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def _grad_tree(tree):
    return tree_map(lambda p: p.grad, tree)


# --------------------------------------------------------------------------
# the sharded data-parallel step (integer-wire gradient sync, ZeRO-1)
# --------------------------------------------------------------------------


def _quant_update_leaf(cfg, lab) -> bool:
    """Leaves whose updated values land on the k_WU grid (Eq. 24): these
    all-gather as integer payloads in the ZeRO-1 layout."""
    return cfg.quantize and lab != "exempt" and cfg.quant_u


@torch.no_grad()
def _zero1_update(cfg, params, grads, state, labels, key, lr, mom, dr_bits,
                  mesh) -> None:
    """ZeRO-1 Momentum step, IN PLACE on params and this rank's chunks.

    The accumulator lives as flat per-rank chunks (launch/shard.py); the
    gradient is quantized on the FULL leaf (CQ amax + stochastic bits are
    leaf-global), then each rank applies the elementwise update to its
    chunk only and the updated chunks all-gather back: as int32 payloads
    on the fixed 2^(1-k_WU) grid for quantized leaves (exact: the update
    already lands on that grid), fp32 for exempt leaves.  Bit-identical to
    the replicated `momentum_update` because the update is elementwise."""
    dp, r = mesh.dp, mesh.rank
    leaves = zip(flatten(params), flatten(grads), flatten(state.acc),
                 flatten(labels))
    for i, (p, g, a, lab) in enumerate(leaves):
        gq = quantize_grad_leaf(cfg, g, lab, prng.fold_in(key, i), dr_bits)
        c = a.shape[0]                       # local chunk length
        p_c = S.pad_flat(p, dp * c)[r * c:(r + 1) * c].clone()
        g_c = S.pad_flat(gq, dp * c)[r * c:(r + 1) * c]
        apply_leaf_update(cfg, p_c, g_c, a, lab, lr, mom)
        if _quant_update_leaf(cfg, lab):     # k_WU grid -> integer gather
            step = 2.0 ** (1 - cfg.k_wu)
            data = torch.round(p_c / step).to(torch.int32)
            full = all_gather(data, mesh.group, "param").reshape(-1)
            full = full.to(torch.float32) * step
        else:
            full = all_gather(p_c, mesh.group, "param").reshape(-1)
        p.copy_(full[: p.numel()].reshape(p.shape))
    state.step += 1


def make_sharded_train_step(model, qcfg, labels_tree=None, mesh=None, *,
                            lr: float = 0.05, mom: float = 0.75,
                            dr_bits: int | None = None,
                            n_shards: int | None = None, wire_bits: int = 16,
                            grad_sync: str = "int_ring",
                            wire_codec: str = "packed",
                            opt_shard: str = "replicated",
                            stats: dict | None = None):
    """The data-parallel step over `mesh` (launch/mesh.py; None: one
    process): step(opt_state, batch, step_idx) -> {"loss"}, with `batch`
    this rank's rows of the global batch (`shard.put_batch`), updating the
    model's parameters and opt_state IN PLACE on every rank.

    Args:
      n_shards: virtual batch shards (quantization granularity), default
        dp.  Must be a multiple of dp; the global batch must divide by it.
      wire_bits: integer wire width of the gradient sync (4/8/16/32).
      grad_sync: "int_ring" (integer wire, DP-invariant) or "psum" (the
        fp32 all-reduce baseline of the per-rank mean).
      wire_codec: "packed" (wire_sync_tree: one stacked max, fused
        pre-sum, one double-buffered ring, int8 hops two-per-int16), "leaf"
        (per-leaf wire_sync_mean rings) or "auto" (by the group's backend,
        runtime/compress.default_wire_codec).  Bitwise-identical results.
      opt_shard: "replicated", or "zero1": opt_state.acc holds this rank's
        flat chunk of each leaf (shard.zero_init_momentum, shard_arrays).
      stats: a dict that each step adds its seconds to, under "fwd_bwd",
        "sync" and "opt" (the card is synchronized between the parts), or
        None for no timing.

    Each of this rank's n_shards/dp virtual shards runs `model.loss` and
    its backward on its own rows, one after another (the counterpart of
    the reference's lax.map: every shard's amax and BN statistics stay its
    own); their gradients stack as (vs_local, *shape).  The stochastic-
    rounding keys are the reference's: fold_in(PRNGKey(17), step), the
    optimizer's fold_in(., 1) and a leaf's fold_in(., i) in
    `momentum_update`'s leaf order, so zero1 equals replicated bit for bit
    and the weights after a step are a pure function of (global batch,
    n_shards), not of the layout."""
    mesh = make_mesh(1) if mesh is None else mesh
    if wire_codec == "auto":
        wire_codec, _ = default_wire_codec(group=mesh.group)
    dp, tp = S.mesh_dims(mesh)
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: {TP_UNPORTED}")
    if grad_sync not in ("int_ring", "psum"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    if wire_codec not in ("packed", "leaf"):
        raise ValueError(f"unknown wire_codec {wire_codec!r}")
    if opt_shard not in ("replicated", "zero1"):
        raise ValueError(f"unknown opt_shard {opt_shard!r}")
    n_shards = dp if n_shards is None else n_shards
    if n_shards % dp:
        raise ValueError(f"n_shards={n_shards} must be a multiple of dp={dp}")
    vs_local = n_shards // dp
    lrq = fixed_point_lr(lr, qcfg)
    labels = model.labels() if labels_tree is None else labels_tree
    on_card = model.device.type == "cuda"

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    def lap(name: str, t0: float) -> float:
        if stats is None:
            return t0
        t = clock()
        stats[name] = stats.get(name, 0.0) + t - t0
        return t

    def sync_grads(grads: list) -> list:
        if grad_sync != "int_ring":                     # fp32-wire baseline
            return [all_reduce(g.mean(0), "sum", mesh.group, "psum") / dp
                    for g in grads]
        if wire_codec == "packed":
            return wire_sync_tree(grads, mesh.group, n_shards=n_shards,
                                  n_dev=dp, bits=wire_bits)
        return [wire_sync_mean(g, mesh.group, n_shards=n_shards, n_dev=dp,
                               bits=wire_bits) for g in grads]

    def train_step(opt_state, batch: dict, step_idx: int) -> dict:
        key = prng.fold_in(prng.prng_key(SEED), step_idx)
        b_local = len(next(iter(batch.values())))
        if b_local % vs_local:
            raise ValueError(
                f"global batch {b_local * dp} must divide by "
                f"n_shards={n_shards} (dp={dp}, {vs_local} virtual shards "
                f"per rank, local batch {b_local})")
        rows = b_local // vs_local
        params = model.params()
        leaves = flatten(params)
        t0 = clock() if stats is not None else 0.0
        grads = [torch.empty((vs_local,) + tuple(p.shape),
                             dtype=torch.float32, device=p.device)
                 for p in leaves]
        losses = []
        for v in range(vs_local):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss({k: x[v * rows:(v + 1) * rows]
                                  for k, x in batch.items()})
            loss.backward()          # frees this shard's graph
            losses.append(loss.detach())
            for g, p in zip(grads, leaves):
                if p.grad is None:
                    g[v].zero_()
                else:
                    g[v].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        t0 = lap("fwd_bwd", t0)
        with torch.no_grad():
            synced = sync_grads(grads)
            del grads
            loss = all_reduce(torch.stack(losses).mean(), "sum", mesh.group,
                              "loss") / dp
            t0 = lap("sync", t0)
            okey = prng.fold_in(key, 1)
            gtree = unflatten(params, synced)
            if opt_shard == "zero1":
                _zero1_update(qcfg, params, gtree, opt_state, labels, okey,
                              lrq, mom, dr_bits, mesh)
            else:
                momentum_update(qcfg, params, gtree, opt_state, labels, okey,
                                lrq, mom=mom, dr_bits=dr_bits)
            lap("opt", t0)
        return {"loss": loss}

    return train_step


def _task(acfg, args):
    """The CLI's data by family: TokenTask for the LM; for a ResNet the
    npz shards under --data-dir (the config takes the shards' image size
    and classes, as the reference's benchmarks do), else the synthetic
    ImageTask at the config's.  Returns (task, config, shape text)."""
    if acfg.family != "resnet":
        return (TokenTask(vocab=acfg.vocab, seq_len=args.seq,
                          global_batch=args.batch), acfg, f"seq {args.seq}")
    if args.data_dir:
        task = NpzImageTask(args.data_dir, global_batch=args.batch)
        acfg = acfg.replace(img_size=task.img_size,
                            num_classes=task.num_classes)
    else:
        task = ImageTask(acfg.img_size, acfg.num_classes, args.batch)
    size = acfg.img_size
    return task, acfg, f"{size}x{size}x3 images, {acfg.num_classes} classes"


def _refuse_unported(p: argparse.ArgumentParser, args) -> None:
    unported = {"tp": 1, "elastic": False, "rebalance_flags": 0}
    for name, default in unported.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {UNPORTED}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv: list, dp: int) -> None:
    """Run this CLI in `dp` worker processes on 127.0.0.1 (a torchrun-like
    environment: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT), print
    rank 0's output as it comes, and raise if any rank fails (the others
    are then killed)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    base = dict(os.environ, WORLD_SIZE=str(dp), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), PYTHONUNBUFFERED="1",
                PYTHONPATH=src + (os.pathsep + path if path else ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(dp)]
    lines: queue.Queue = queue.Queue()

    def pump(r, f):
        for line in f:
            lines.put((r, line))
        lines.put((r, None))

    for r, proc in enumerate(procs):
        threading.Thread(target=pump, args=(r, proc.stdout),
                         daemon=True).start()
    logs: dict = {r: [] for r in range(dp)}
    failed, running = None, dp
    while running:
        r, line = lines.get()
        if line is not None:
            logs[r].append(line)
            if r == 0:
                print(line, end="", flush=True)
            continue
        running -= 1
        if procs[r].wait() and failed is None:
            failed = r
            for q in procs:
                if q.poll() is None:
                    q.kill()
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {dp} exited with {procs[failed].returncode}:"
            f"\n{''.join(logs[failed][-30:])}")


def _join_world(args):
    """Join the launcher's process group (gloo on --device cpu, nccl on
    cuda, each rank on card LOCAL_RANK).  Returns (mesh, device)."""
    import torch.distributed as dist
    world = int(os.environ["WORLD_SIZE"])
    if world != args.dp:
        raise ValueError(f"--dp {args.dp} in a world of {world} ranks")
    device = args.device
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]))
    return make_mesh(args.dp), device


def main(argv=None):
    p = argparse.ArgumentParser("repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--preset", default="full8")
    p.add_argument("--mode", default="native",
                   choices=["fp32", "sim", "native"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--reduced", action="store_true",
                   help="use the reduced smoke config (CPU scale)")
    p.add_argument("--dr-boundaries", default="",
                   help="comma-separated steps where CQ's dr width shrinks "
                        "one bit (paper §III-C); base width is k_gw")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain PyTorch versions "
                        "of the kernels")
    p.add_argument("--data-dir", default="",
                   help="ResNet: train on the npz shards under this "
                        "directory (data/imagenet.py) instead of the "
                        "synthetic ImageTask")
    p.add_argument("--ckpt-dir", default="",
                   help="save (parameters, MomentumState) here every "
                        "--save-every steps")
    p.add_argument("--save-every", type=int, default=25)
    p.add_argument("--resume", action="store_true",
                   help="with --ckpt-dir: continue from its latest "
                        "checkpoint (ignored without --ckpt-dir)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (dp > 1 engages the sharded "
                        "step with integer-wire gradient sync; without a "
                        "launcher's WORLD_SIZE the CLI spawns them)")
    p.add_argument("--n-shards", type=int, default=0,
                   help="virtual batch shards (quantization granularity); "
                        "0 = dp")
    p.add_argument("--wire-bits", type=int, default=16,
                   choices=[4, 8, 16, 32],
                   help="integer wire width of the sharded gradient sync")
    p.add_argument("--grad-sync", default="int_ring",
                   choices=["int_ring", "psum"])
    p.add_argument("--wire-codec", default="auto",
                   choices=["auto", "packed", "leaf"],
                   help="int_ring codec: 'packed' = whole-tree sync, "
                        "'leaf' = per-leaf rings, 'auto' = packed on nccl, "
                        "leaf on gloo (bitwise equal)")
    p.add_argument("--opt-shard", default="replicated",
                   choices=["replicated", "zero1"])
    # the reference CLI's other flags: accepted, and refused unless default
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--rebalance-flags", type=int, default=0)
    args = p.parse_args(argv)
    _refuse_unported(p, args)
    sharded = args.dp > 1
    if sharded and "WORLD_SIZE" not in os.environ:
        if (torch.device(args.device).type == "cuda"
                and torch.cuda.device_count() < args.dp):
            raise RuntimeError(
                f"--dp {args.dp} on cuda needs {args.dp} cards (NCCL puts "
                f"one rank on a card), this machine has "
                f"{torch.cuda.device_count()}; --device cpu runs the ranks "
                f"in a gloo world on the host")
        _spawn(sys.argv[1:] if argv is None else list(argv), args.dp)
        return
    mesh, device = _join_world(args) if sharded else (None, args.device)
    lead = mesh is None or mesh.rank == 0

    acfg = get_arch(args.arch)
    if args.reduced:
        acfg = acfg.reduced()
    # --preset fp32 ignores --mode, as the reference's CLI does
    qcfg = preset(args.preset, args.mode if args.preset != "fp32" else None)
    task, acfg, shape = _task(acfg, args)
    model = build_model(acfg, qcfg, device=device).init(0)
    params = model.params()
    zero1 = sharded and args.opt_shard == "zero1"
    opt = (S.zero_init_momentum(params, args.dp) if zero1
           else init_momentum(params))
    specs = (S.zero_opt_specs(params) if zero1
             else S.opt_specs(S.param_specs(params)))
    bounds = parse_boundaries(args.dr_boundaries)
    say = print if lead else (lambda *a, **k: None)
    say(f"[train] {acfg.name} {args.preset}/{qcfg.mode} on {model.device}: "
        f"{sum(t.numel() for t in flatten(params)) / 1e6:.2f} M params, "
        f"batch {args.batch} x {shape}")
    ckpt, start = None, 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            _, start, _ = ckpt.restore((params, opt))
            say(f"resumed from step {start}")
    if sharded:
        if args.wire_codec == "auto":
            codec, why = default_wire_codec(group=mesh.group)
        else:
            codec, why = args.wire_codec, "forced by --wire-codec"
        opt = S.shard_arrays(mesh, opt, specs)
        say(f"[shard] mesh dp={args.dp} tp={args.tp} "
            f"n_shards={args.n_shards or args.dp} "
            f"wire={args.grad_sync}:{args.wire_bits}b codec={codec} ({why}) "
            f"opt={args.opt_shard}")
    steps: dict[int, object] = {}
    cur = None
    t0 = time.time()
    for step in range(start, args.steps):
        bits = dr_bits_schedule(step, bounds, base_bits=qcfg.k_gw)
        if bits != cur:
            if bounds:
                say(f"[dr] step {step}: CQ dr width -> {bits} bits")
            cur = bits
        if bits not in steps:
            steps[bits] = (make_sharded_train_step(
                model, qcfg, mesh=mesh, lr=args.lr, dr_bits=bits,
                n_shards=args.n_shards or None, wire_bits=args.wire_bits,
                grad_sync=args.grad_sync, wire_codec=codec,
                opt_shard=args.opt_shard) if sharded else make_train_step(
                model, qcfg, lr=args.lr, dr_bits=bits))
        batch = task.batch(step)
        metrics = steps[bits](opt, S.put_batch(mesh, batch) if sharded
                              else batch, step)
        acc = f"acc {float(metrics['acc']):.4f} " if "acc" in metrics else ""
        say(f"step {step:5d} loss {float(metrics['loss']):.4f} {acc}"
            f"({time.time() - t0:.1f}s)")
        if ckpt and (step + 1) % args.save_every == 0:
            whole = S.gather_arrays(mesh, opt, specs) if sharded else opt
            if lead:
                ckpt.save(step + 1, (params, whole))
    if ckpt:
        ckpt.wait()
    if sharded:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
