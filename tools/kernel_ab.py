#!/usr/bin/env python3
"""Time K4 rows and K6 of two checkouts of the port on one card, in turns.

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

each as "ms" (CUDA events over 20 calls, which also see the host's issue
rate) and "dev" (the profiler's kernel time per call over 100 calls), with
a checksum of the output, which must agree between the checkouts.  Prints
the card's name and power limit, one JSON line per turn and a summary;
writes all of it to FILE as JSON.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    res = {}
    for name, fn in cases.items():
        res[name] = {"ms": time_ms(fn), "dev": device_ms(fn),
                     "checksum": float(fn().double().sum())}
    return res


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
        print(f"{name}: dev {row} ms, wall {wall} ms (base / change / "
              f"change / base); outputs "
              f"{'equal' if len(sums) == 1 else 'DIFFER'}")
        if len(sums) != 1:
            return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
