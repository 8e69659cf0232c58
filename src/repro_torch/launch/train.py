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

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the sharded step and the elastic runtime (--dp, --tp, --elastic, ...).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as get_arch
from repro_torch.core import prng
from repro_torch.core.qconfig import preset
from repro_torch.data import ImageTask, NpzImageTask, TokenTask
from repro_torch.models import build_model
from repro_torch.optim import (dr_bits_schedule, fixed_point_lr, flatten,
                               init_momentum, momentum_update,
                               parse_boundaries, tree_map)

SEED = 17

SHARDED = ("is not ported yet: the sharded step, its gradient wire and the "
           "elastic runtime are ROADMAP Queue 1 item 5")


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


def _refuse_unported(p: argparse.ArgumentParser, args) -> None:
    sharded = {"dp": 1, "tp": 1, "n_shards": 0, "wire_bits": 16,
               "grad_sync": "int_ring", "wire_codec": "auto",
               "opt_shard": "replicated", "elastic": False,
               "rebalance_flags": 0}
    for name, default in sharded.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {SHARDED}")


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
    # the reference CLI's other flags: accepted, and refused unless default
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--n-shards", type=int, default=0)
    p.add_argument("--wire-bits", type=int, default=16)
    p.add_argument("--grad-sync", default="int_ring")
    p.add_argument("--wire-codec", default="auto")
    p.add_argument("--opt-shard", default="replicated")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--rebalance-flags", type=int, default=0)
    args = p.parse_args(argv)
    _refuse_unported(p, args)

    acfg = get_arch(args.arch)
    if args.reduced:
        acfg = acfg.reduced()
    # --preset fp32 ignores --mode, as the reference's CLI does
    qcfg = preset(args.preset, args.mode if args.preset != "fp32" else None)
    task, acfg, shape = _task(acfg, args)
    model = build_model(acfg, qcfg, device=args.device).init(0)
    opt = init_momentum(model.params())
    bounds = parse_boundaries(args.dr_boundaries)
    print(f"[train] {acfg.name} {args.preset}/{qcfg.mode} on {model.device}: "
          f"{sum(t.numel() for t in flatten(model.params())) / 1e6:.2f} M "
          f"params, batch {args.batch} x {shape}")
    ckpt, start = None, 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            _, start, _ = ckpt.restore((model.params(), opt))
            print(f"resumed from step {start}")
    steps: dict[int, object] = {}
    cur = None
    t0 = time.time()
    for step in range(start, args.steps):
        bits = dr_bits_schedule(step, bounds, base_bits=qcfg.k_gw)
        if bits != cur:
            if bounds:
                print(f"[dr] step {step}: CQ dr width -> {bits} bits")
            cur = bits
        if bits not in steps:
            steps[bits] = make_train_step(model, qcfg, lr=args.lr,
                                          dr_bits=bits)
        metrics = steps[bits](opt, task.batch(step), step)
        acc = f"acc {float(metrics['acc']):.4f} " if "acc" in metrics else ""
        print(f"step {step:5d} loss {float(metrics['loss']):.4f} {acc}"
              f"({time.time() - t0:.1f}s)")
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, (model.params(), opt))
    if ckpt:
        ckpt.wait()


if __name__ == "__main__":
    main()
