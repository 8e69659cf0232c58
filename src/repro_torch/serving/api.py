"""Serving API surface: engine construction, synthetic traffic, load tests.

    from repro_torch.serving import make_engine, poisson_traffic, run_load

    engine = make_engine("granite-3-8b", reduced=False, n_layers=4,
                         max_lanes=4, page_size=16, max_ctx=512)
    rid = engine.submit(prompt_ids, max_new=16)
    tokens = engine.drain()[rid]
    traffic = poisson_traffic(rate=8.0, n_requests=12,
                              prompt_lens=(8, 16, 24), gen_lens=(4, 8))
    results, metrics = run_load(engine, traffic)

Port of `repro.serving.api` at tp=1, in each numeric mode (`mode="native"`
by default, "sim" or "fp32"; core/qconfig.py).  The engine serves
through monolithic prefill by default, greedy unless `temperature` > 0,
with the fused decode attention unless `fuse_kernels=False`;
`prefill_mode="chunked"` and `radix_cache=True` give chunked prefill and the
prefix cache.  `poisson_traffic` is an open-loop generator with mixed
prompt/generation lengths, `shared_prefix_traffic` biases a fraction of
prompts onto common page-aligned prefixes (what the radix cache exploits),
`run_load` replays traffic against the engine's clock, and `naive_serve`
is the sequential one-request-at-a-time baseline.  Every LM the port
builds serves through them: the dense LMs, the MoE LMs
(granite-moe-1b-a400m, moonshot-v1-16b-a3b; decode routes dropless),
falcon-mamba-7b and the hybrid zamba2-7b (its Mamba2 state in dense
slots, its shared attention's KV in the pool; the radix cache keeps its
dense snapshots).  The enc-dec (seamless-m4t-large-v2) is not an engine
model, here as in the reference: `make_engine` refuses it, and it serves
through `EncDec.prefill` / `serve_step`.  The engine runs on the card
unless `device="cpu"` is passed.  Tensor-parallel serving and the
replica router are not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import preset
from repro_torch.models import build_model

from .engine import Engine, greedy_token


def make_engine(arch: str, *, mode: str = "native", preset_name: str = "full8",
                reduced: bool = True, seed: int = 0, device="cuda",
                n_layers: int | None = None, tp: int = 1,
                fuse_kernels: bool = True, **engine_kw) -> Engine:
    """Build (arch config, model with random weights, Engine) in one call.

    `mode` and `preset_name` pick the QConfig (`preset(preset_name,
    mode)`); `reduced` takes the tiny CPU-test config; `n_layers` cuts the
    depth and keeps every width.  Weights come from `seed` by the reference's init
    formulas (same distributions, not the same bits as `repro`'s).
    `fuse_kernels=False` pins the unfused gather-then-attend decode route
    (the same bits).  The engine's model is `engine.model`."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel serving is not ported yet: ROADMAP Queue 1 "
            "item 5")
    acfg = get(arch)
    if acfg.family == "encdec":
        raise NotImplementedError(
            f"{arch} is an enc-dec: the engine serves decoder-only LMs, as "
            "the reference's does; serve it through EncDec.prefill(frames, "
            "t_self) and EncDec.serve_step(cache, tokens)")
    if reduced:
        acfg = acfg.reduced()
    if n_layers is not None:
        acfg = acfg.replace(n_layers=n_layers)
    qcfg = preset(preset_name, mode).replace(fuse_kernels=fuse_kernels)
    model = build_model(acfg, qcfg, device=device).init(seed)
    return Engine(model, **engine_kw)


def poisson_traffic(rate: float, n_requests: int,
                    prompt_lens=(8, 16, 24), gen_lens=(4, 8, 12),
                    vocab: int = 128, seed: int = 0) -> list[dict]:
    """Open-loop Poisson arrivals with mixed lengths.

    Returns [{"arrival": seconds-from-start, "prompt": int32 array,
    "max_new": int}, ...] sorted by arrival; the reference's draws from
    numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    out = []
    for i in range(n_requests):
        s = int(rng.choice(prompt_lens))
        out.append({
            "arrival": float(arrivals[i]),
            "prompt": rng.integers(0, vocab, size=s).astype(np.int32),
            "max_new": int(rng.choice(gen_lens)),
        })
    return out


def shared_prefix_traffic(rate: float, n_requests: int, sharing: float = 0.5,
                          prefix_len: int = 16, n_prefixes: int = 2,
                          tail_lens=(4, 8), gen_lens=(4, 8),
                          vocab: int = 128, seed: int = 0) -> list[dict]:
    """Poisson arrivals where a `sharing` fraction of prompts open with one
    of `n_prefixes` common prefixes of `prefix_len` tokens (the system-
    prompt pattern the radix cache exploits); the rest draw a fresh random
    prefix of the same length.  Keep `prefix_len` a multiple of the
    engine's page_size so the shared prefix is publishable page for page.
    Same row format as `poisson_traffic`."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, size=prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    out = []
    for i in range(n_requests):
        tail = rng.integers(0, vocab,
                            size=int(rng.choice(tail_lens))).astype(np.int32)
        if rng.random() < sharing:
            head = prefixes[int(rng.integers(n_prefixes))]
        else:
            head = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
        out.append({
            "arrival": float(arrivals[i]),
            "prompt": np.concatenate([head, tail]),
            "max_new": int(rng.choice(gen_lens)),
        })
    return out


def run_load(engine: Engine, traffic: list[dict],
             max_steps: int = 100_000) -> tuple[dict, dict]:
    """Replay open-loop traffic against the engine.

    Requests are submitted when the engine clock passes their arrival
    offset; when the engine is idle ahead of the next arrival it sleeps
    briefly instead of spinning.  Returns ({rid: tokens}, metrics)."""
    t0 = engine.clock()
    pending = sorted(traffic, key=lambda r: r["arrival"])
    i = 0
    for _ in range(max_steps):
        now = engine.clock() - t0
        while i < len(pending) and pending[i]["arrival"] <= now:
            r = pending[i]
            engine.submit(r["prompt"], r["max_new"],
                          arrival=t0 + r["arrival"])
            i += 1
        idle = (not engine.scheduler.queue
                and all(ln is None for ln in engine.lane_req))
        if idle:
            if i >= len(pending):
                break
            time.sleep(min(pending[i]["arrival"] - now, 0.002))
            continue
        engine.step()
    else:
        raise RuntimeError(f"load did not finish in {max_steps} steps")
    results = {r.rid: list(r.generated)
               for r in engine.scheduler.requests.values()}
    return results, engine.metrics()


def naive_serve(model, traffic: list[dict]) -> tuple[list, dict]:
    """Sequential baseline: one request at a time, the model's own
    `prefill` + `serve_step` (a dense int8 cache for the LM, the recurrent
    state for the SSM), greedy.  No batching, no paging.  Returns (token
    lists, {"wall_s", "decode_steps", "decode_wall_s", "generated_tokens",
    "decode_tok_s"}).  (The reference's takes `params` beside the model;
    the port's model holds its weights.)"""
    a = model.a
    outs, decode_steps, decode_wall = [], 0, 0.0
    t0 = time.monotonic()
    for r in traffic:
        prompt = torch.as_tensor(np.asarray(r["prompt"], np.int32)[None],
                                 device=model.device)
        if a.family == "ssm":
            cache, logits = model.prefill(prompt)
        else:
            cache, logits = model.prefill(
                prompt, int(prompt.shape[1]) + int(r["max_new"]))
        tok = greedy_token(logits, a.vocab)
        gen = [int(tok[0])]
        td = time.monotonic()
        for _ in range(r["max_new"] - 1):
            cache, logits = model.serve_step(cache, tok)
            tok = greedy_token(logits, a.vocab)
            gen.append(int(tok[0]))
            decode_steps += 1
        decode_wall += time.monotonic() - td
        outs.append(gen)
    wall = time.monotonic() - t0
    total = sum(len(g) for g in outs)
    return outs, {"wall_s": wall, "decode_steps": decode_steps,
                  "decode_wall_s": decode_wall, "generated_tokens": total,
                  "decode_tok_s": (total / decode_wall
                                   if decode_wall > 0 else 0.0)}
