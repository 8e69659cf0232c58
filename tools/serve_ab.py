#!/usr/bin/env python3
"""Time the chunked greedy serve run of two checkouts of the port on one
card, in turns.

    python3 tools/serve_ab.py --base DIR [--out FILE]

DIR is another checkout of this repository (for example the parent commit
unpacked with `git archive`).  The script runs one process per turn, in the
order base, this tree, this tree, base, twice over; each imports
`repro_torch` from its own checkout's `src/`, builds that checkout's kernels (into one shared
build directory, so an unchanged source is built once) and, with the
settings of `chip_smoke.py`'s serve phase (deterministic algorithms, no
TF32), serves that phase's four requests (prompts of 100, 37, 256 and 64
seeded tokens, 16 new tokens each) through `make_engine("granite-3-8b",
reduced=False, n_layers=4)` on chunked prefill, 4 lanes, page 16, max_ctx
512.  Each turn serves them 2 * REPS + 1 times on fresh engines over the
same model and drops the first (kernel builds, allocator warm-up); it
reports the decode ms a step, the TTFT mean and the prefill wall of each
kept run, their medians, the tokens (which must agree between the
checkouts), and `prng.fold_in`'s host time a call.  Where the engine has a
`greedy` flag (a greedy engine then skips the sampling key's fold-in),
every second run serves the requests with the flag cleared, which folds
the key in on every sample as before; so every turn does the same work.

Prints the card's name and power limit, one JSON line per turn and a
summary; writes all of it to FILE as JSON.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LENS = (100, 37, 256, 64)
NEW_TOKENS = 16
REPS = 3
ENGINE_KW = dict(max_lanes=4, page_size=16, max_ctx=512,
                 prefill_mode="chunked")


def serve_once(model, prompts, fold_in: bool) -> tuple[dict, list]:
    import torch
    from repro_torch.serving import Engine
    eng = Engine(model, **ENGINE_KW)
    if fold_in:
        eng.greedy = False
    for p in prompts:
        eng.submit(p, NEW_TOKENS)
    torch.cuda.synchronize()
    out = eng.drain()
    torch.cuda.synchronize()
    met = eng.metrics()
    return ({"decode_ms_step": 1e3 * met["decode_wall_s"]
             / max(met["decode_steps"], 1),
             "ttft_ms": 1e3 * met["ttft_mean_s"],
             "prefill_s": met["prefill_wall_s"]},
            [out[i] for i in range(len(prompts))])


def measure(root: str) -> dict:
    """The serve runs above through `root`'s port."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    from repro_torch.core import prng
    from repro_torch.serving import Engine, make_engine
    model = make_engine("granite-3-8b", reduced=False, n_layers=4,
                        device="cuda", seed=0, **ENGINE_KW).model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.a.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    has_flag = "greedy" in Engine(model, **ENGINE_KW).__dict__
    variants = ["plain", "fold_in" if has_flag else "plain"]
    runs = {v: [] for v in variants}
    toks = None
    serve_once(model, prompts, False)           # builds and warm-up
    for _ in range(REPS):
        for v in variants:
            m, t = serve_once(model, prompts, v == "fold_in")
            assert toks is None or t == toks, "tokens differ between runs"
            toks = t
            runs[v].append(m)
    key = prng.prng_key(0)
    prng.fold_in(key, 1)
    t0 = time.perf_counter()
    for n in range(200):
        prng.fold_in(key, n)
    fold_ms = 1e3 * (time.perf_counter() - t0) / 200
    med = {v: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for v, rs in runs.items()}
    return {"runs": runs, "median": med, "fold_in_ms": fold_ms,
            "tokens": toks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "serve_ab.json"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    import torch
    if not torch.cuda.is_available() or not args.base:
        print("serve_ab: needs a CUDA device and --base", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=os.environ.get(
        "REPRO_TORCH_BUILD_DIR", os.path.join(HERE, "build", "kernels")))
    turns = []
    for tag, root in 2 * (("base", args.base), ("change", HERE),
                          ("change", HERE), ("base", args.base)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             os.path.abspath(root)], capture_output=True, text=True, env=env)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append({"tag": tag, **res})
        print(json.dumps(turns[-1]), flush=True)
    for v in ("plain", "fold_in"):
        rows = [t for t in turns if v in t["median"]]
        for k in ("decode_ms_step", "ttft_ms", "prefill_s"):
            vals = " / ".join(f"{t['tag']} {t['median'][v][k]:.4f}"
                              for t in rows)
            print(f"{v} {k} (median a turn): {vals}")
            for tag in ("base", "change"):
                every = sorted(r[k] for t in rows if t["tag"] == tag
                               for r in t["runs"][v])
                if every:
                    print(f"  {tag} every run: median "
                          f"{statistics.median(every):.4f} of "
                          f"{len(every)}: {every}")
    print("fold_in ms a call on the host: " + " / ".join(
        f"{t['tag']} {t['fold_in_ms']:.4f}" for t in turns))
    same = all(t["tokens"] == turns[0]["tokens"] for t in turns)
    print(f"tokens equal across turns: {same}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
