#!/usr/bin/env python3
"""Time K4, K6 and K9 of two checkouts of the port on one card, in turns.

    python3 tools/kernel_ab.py --base DIR [--out FILE]

DIR is another checkout of this repository (for example the parent commit
unpacked with `git archive`).  The script runs one process per turn, in the
order base, this tree, this tree, base; each imports `repro_torch` from its
own checkout's `src/`, builds that checkout's kernels (into one shared
build directory, so an unchanged source is built once) and times, on the
same seeded inputs:

  ubn_rms_4x4096, ubn_rms_16x4096, ubn_rms_4096x4096
                  ops.ubn_norm kind "rms" (a decode step, a prefill page,
                  the training shape)
  pa_4x512        ops.paged_attention at chip_smoke.py's row (4 lanes of
                  32 / 8 heads of 128 at 115, 52, 271 and 79 of 512)
  pa_16x2048      16 lanes over 2048 positions at 1024-2047 (seeded)
  bn_MxC          ops.ubn_norm kind "batch" at each of ResNet-50's BN
                  shapes at batch 32 (11 shapes, 52 calls a training step)
  bnlib_MxC       F.batch_norm(training=True) at the same shape (the
                  library's yardstick; the port never calls it)
  scan_page, scan_decode, scan_train_4k
                  ops.selective_scan at falcon-mamba-7b's prefill page
                  (1x16x8192x16) and decode step (4x1x8192x16), both from a
                  carried state, and the train_4k length (1x4096x8192x16)
                  from zero state

each as "ms" (CUDA events over 20 calls, which also see the host's issue
rate) and "dev" (the profiler's kernel time per call over 100 calls), with
a checksum of the output, which must agree between the checkouts.  Prints
the card's name and power limit, one JSON line per turn and a summary
(with K4 batch's and F.batch_norm's device time summed over a step's 52
calls); writes all of it to FILE as JSON.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ResNet-50 at batch 32, 224 px: (M, C) of each quantized BN -> calls a step
RESNET50_BN = {(100352, 64): 6, (100352, 256): 4, (100352, 128): 1,
               (25088, 128): 7, (25088, 512): 5, (25088, 256): 1,
               (6272, 256): 11, (6272, 1024): 7, (6272, 512): 1,
               (1568, 512): 5, (1568, 2048): 4}


def time_ms(fn, iters: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def measure(root: str) -> dict:
    """The cases above through `root`'s port."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    gam = 1.0 + 0.1 * torch.randn(4096, generator=g, device=dev)
    for m in (4, 16, 4096):
        x = torch.randn((m, 4096), generator=g, device=dev) * 2
        cases[f"ubn_rms_{m}x4096"] = lambda x=x: ops.ubn_norm(x, gam)
    sc = [torch.tensor(s, device=dev) for s in (2.0 ** -6, 2.0 ** -7,
                                                 2.0 ** -7)]
    for name, b, nb, pos in (
            ("pa_4x512", 4, 32, [115, 52, 271, 79]),
            ("pa_16x2048", 16, 128, None)):
        i8 = lambda *s: torch.randint(-127, 128, s, generator=g,  # noqa
                                      device=dev, dtype=torch.int8)
        kp, vp, q8 = i8(b * nb + 1, 16, 8, 128), i8(b * nb + 1, 16, 8, 128), \
            i8(b, 32, 128)
        tbl = torch.arange(1, b * nb + 1, device=dev,
                           dtype=torch.int32).reshape(b, nb)
        q_pos = (torch.tensor(pos, device=dev, dtype=torch.int32)
                 if pos is not None else
                 torch.randint(1024, 2048, (b,), generator=g, device=dev,
                               dtype=torch.int32))
        args = (q8, kp, vp, tbl, q_pos, q_pos.max() + 1, *sc)
        cases[name] = lambda args=args: ops.paged_attention(
            *args, sm_scale=1.0 / math.sqrt(128))
    import torch.nn.functional as F
    for (m, c) in RESNET50_BN:
        x = torch.randn((m, c), generator=g, device=dev) * 2 + 0.3
        gm = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bt = 0.1 * torch.randn(c, generator=g, device=dev)
        cases[f"bn_{m}x{c}"] = lambda x=x, gm=gm, bt=bt: ops.ubn_norm(
            x, gm, bt, kind="batch")
        cases[f"bnlib_{m}x{c}"] = lambda x=x, gm=gm, bt=bt: F.batch_norm(
            x, None, None, gm, bt, training=True, eps=2.0 ** -8)
    for name, (b, s_, d, n), with_h0 in (
            ("scan_page", (1, 16, 8192, 16), True),
            ("scan_decode", (4, 1, 8192, 16), True),
            ("scan_train_4k", (1, 4096, 8192, 16), False)):
        dt = torch.empty((b, s_, d), device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=g).exp()
        a = torch.exp(dt[..., None] * -torch.arange(
            1, n + 1, device=dev, dtype=torch.float32))
        bb = torch.randn((b, s_, d, n), generator=g, device=dev) * 0.1
        c = torch.randn((b, s_, n), generator=g, device=dev)
        h0 = torch.randn((b, d, n), generator=g, device=dev) \
            if with_h0 else None
        del dt
        cases[name] = lambda a=a, bb=bb, c=c, h0=h0: ops.selective_scan(
            a, bb, c, h0)
    res = {}
    for name, fn in cases.items():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        res[name] = {"ms": time_ms(fn), "dev": device_ms(fn),
                     "checksum": sum(float(o.double().sum()) for o in out)}
    return res


def step_sum(cases: dict, prefix: str) -> float:
    """Device ms of a ResNet-50 step's 52 BN calls at `prefix`'s rows."""
    return sum(k * cases[f"{prefix}_{m}x{c}"]["dev"]
               for (m, c), k in RESNET50_BN.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "kernel_ab.json"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    import torch
    if not torch.cuda.is_available() or not args.base:
        print("kernel_ab: needs a CUDA device and --base", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=os.environ.get(
        "REPRO_TORCH_BUILD_DIR", os.path.join(HERE, "build", "kernels")))
    turns = []
    for tag, root in (("base", args.base), ("change", HERE),
                      ("change", HERE), ("base", args.base)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             os.path.abspath(root)], capture_output=True, text=True, env=env)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append({"tag": tag, "cases": res})
        print(json.dumps(turns[-1]), flush=True)
    for name in turns[0]["cases"]:
        sums = {t["cases"][name]["checksum"] for t in turns}
        row = " / ".join(f"{t['cases'][name]['dev']:.4f}" for t in turns)
        wall = " / ".join(f"{t['cases'][name]['ms']:.4f}" for t in turns)
        if name.startswith("bnlib"):     # the library's, not compared
            sums = {0}
        print(f"{name}: dev {row} ms, wall {wall} ms (base / change / "
              f"change / base); outputs "
              f"{'equal' if len(sums) == 1 else 'DIFFER'}")
        if len(sums) != 1:
            return 1
    for prefix in ("bn", "bnlib"):
        row = " / ".join(f"{step_sum(t['cases'], prefix):.4f}" for t in turns)
        print(f"{prefix}: device ms a ResNet-50 step (52 calls) {row} "
              f"(base / change / change / base)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
