#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (`src/repro_torch`) only; imports nothing of JAX or of the
reference package.  Phases, in order; any failure exits non-zero and
prints no result line:

  1. build   every hand-written kernel from `src/repro_torch/csrc` (one
             nvcc per source, in parallel) into `build/kernels/`; print the
             card's name and power limit (nvidia-smi).
  2. kernels each kernel against its plain PyTorch version on the card at
             the serving and training paths' shapes, bit for bit (K1
             qmatmul on both routes - M <= 16 narrow, M > 16 wide - with
             transposed operands, batched chunks and the attention views
             _int_contract passes, timed at the decode, prefill-page,
             training and attention-chunk shapes with its device time
             beside; K2 quantize, K3 dgrad/wgrad in the affine k=8,
             affine k=16 and flag k=8 modes at the four qdense shapes, a
             ragged and a split shape, K4 ubn_norm by rows (rms and
             layer, M 1 to 4096 on both routes, N 4096, 8192 and ragged,
             timed at 4, 16 and 4096 rows with its device time, beside
             the exhaustive check of the fp32 division and sqrt it
             shares with K6; kind "layer" at the enc-dec's 4096 x 1024
             and 4 x 1024, F.layer_norm beside) and by columns ("batch", every BN shape of
             a ResNet-50 step at batch 32 on both routes, a row each with
             its device time and F.batch_norm beside, a ragged M and an
             unaligned view), K5
             flash_attention at train_4k and its tile-skip edge cases
             (offset positions, leading padding, rows without keys,
             k_a = 4, dh = 64, 3 heads per KV head) with the share
             of tiles it skipped and the exhaustive check of its p codes,
             and at monolithic prefill's shapes (prompts of 100, 37, 256,
             64 and 1500 tokens: below 512 one kv chunk of T, ragged
             where T is no multiple of 64), timed at 100 tokens beside
             SDPA in bf16, and non-causal at the enc-dec's encoder (1 x
             4096 over 4096) and cross (1024 queries over 4096 frames)
             shapes, 16/16 heads of 64, every tile visited, SDPA bf16
             beside, and at every head width from 16 to 128 and zamba2-7b's
             (32/32 heads of 112: 1 x 4096 causal and a 100-token
             prefill, SDPA bf16 beside), K7 page_gather with one pool (4
             lanes x 128
             pages, the unfused decode route's call) and with K and V in
             one launch, head-major (wall time beside device time), K6
             paged_attention at 4 lanes over 512 positions and 16 lanes
             over 2048 with its device time, the sweep's edge cases and
             a profiler listing of one call's launches, K8
             cq_stochastic, which no path calls, K9 selective_scan at a
             prefill page, a decode step, the train_4k length from zero
             state (each with its device time) and ragged shapes across
             its staged tiles), K9b selective_scan_bwd (the scan's
             gradient: at ragged shapes and at the ssm_train step's
             1 x 4096 x 8192 x 16, with its device time and the call's
             peak memory), K9 and K9b again on bf16 carriers
             (scan_dtype "bf16": a prefill page, train_4k and ragged
             shapes, bitwise), with
             its time, bound, plain time and the time of one PyTorch call
             for the same function where one exists (used only as a
             yardstick); this phase runs without deterministic mode's
             fill of fresh tensors (no_fill).
  3. serve   `make_engine("granite-3-8b", reduced=False, n_layers=4)`: the
             full-width model (4096 wide, 32 query / 8 KV heads of 128,
             FFN 12800, vocab 49155) with depth cut to 4 of 40 layers and
             random weights from a seed; 4 greedy requests (prompts of 100,
             37, 256 and 64 tokens, 16 new tokens each) through chunked
             prefill and decode, every kernel's launch count > 0; then the
             same requests through the plain versions on the card, which
             must give the same tokens and logits; then a torch.profiler
             breakdown of the decode step, and of one prefill page (one
             K7 launch a layer, no aten::copy_ inside its contractions).
  3b. serve_mono  the serve phase's model on the engine's default,
             monolithic prefill (max_ctx 2048, one more prompt of 1500
             tokens): greedy (K5 flash_attention, K1, K2, K4, K6 launched;
             no K7 in decode steps), tokens equal to the plain versions'
             run on the card and the first logits of the 100- and
             1500-token prompts at distance 0; sampled at temperature 0.7,
             top-k 50, tokens equal to the plain run's; chunked prefill
             with the radix cache over 6 shared-prefix requests on one
             lane (hit rate > 0, tokens equal to the run without the
             cache); fuse_kernels=False (K7 launched and K6 not in decode
             steps, tokens equal to the fused run's); defrag() after step
             3 (pages moved, tokens equal to the run without it).
  4. train   `repro_torch.launch.train.make_train_step` on granite-3-8b at
             full width, 4 of 40 layers, seed 0, full8 native, one
             TokenTask ("arith") sequence of the train_4k length (batch 1 x
             4096 tokens): 3 steps with their loss, wall time, forward /
             backward / optimizer split, peak memory and kernel launches
             (dgrad, wgrad and flash_attention > 0 in every step);
             K1's launches by contraction (qdense forwards, attention
             chunks); a torch.profiler breakdown of one more step (with
             K1's, K3's and K5's device time per step, K1's split into
             qdense and attention chunks); then
             step 1 again from the same weights through the plain versions
             on the card, whose loss, parameters and momentum accumulator
             must equal the kernel run's bit for bit; then step 1 once
             more with remat "none" (every layer's activations kept),
             whose loss, parameters and accumulator must equal the remat
             "full" run's (the default: each layer recomputed in the
             backward), with both peaks.  Since remat, a training step's
             launches count the recomputed forward's too.
  5. resnet  the paper's ResNet-50 at full size (bottleneck stages 3/4/6/3,
             widths 64 -> 2048, 224 x 224 x 3 images, 1000 classes, 161
             parameter leaves, 25.6 M parameters), seed 0, full8 native,
             lr 0.05: 3 steps of make_train_step on ImageTask(224, 1000,
             32, seed=0) batches (the reference's batch of 128 cut to 32)
             with loss, accuracy, wall time, forward / backward /
             optimizer split, images/s and kernel launches
             (ubn_norm, which is K4 "batch" here, and quantize > 0 in every
             step; K4 batch's launches by (M, C), which must be the 52 a
             step of RESNET50_BN), peak memory and a torch.profiler breakdown of
             one more step with K4 batch's device time summed over its 52
             calls; then step 1 again from the same weights through the
             plain versions, whose loss, 161 parameter leaves and 161
             accumulator leaves must equal the kernel run's bit for bit.
  6. ckpt    checkpoints, microbatching and the bit-width presets:
             ResNet-50 at full size (as phase 5, full8, batch 32) 4 steps
             unbroken, against 2 steps, a CheckpointManager save (under
             build/ckpt, removed afterwards), a fresh model and optimizer
             state, a restore and 2 steps: losses, 161 parameter leaves
             and 161 accumulator leaves equal, with the time save holds
             the caller, the write, the packed and dense-f32 bytes and the
             restore's time; then 2 steps of the reference's batch of 128
             as n_micro = 4 microbatches of 32 (K4 batch 208 launches a
             step) with their peak memory beside phase 5's; then one step
             each of the w4a8 (every Q_W payload within +-7) and g16
             presets on ResNet-50 and of a4 on phase 4's granite shape
             (K5 at k_a = 4), each with a finite loss and every kernel of
             its path launched.
  7. ssm     `make_engine("falcon-mamba-7b", reduced=False, n_layers=4)`:
             Mamba1 at every published width (d_model 4096, d_inner 8192,
             ssm_state 16, d_conv 4, dt rank 256, vocab 65024), depth cut
             to 4 of 64 layers, random weights from seed 0; the serve
             phase's 4 greedy requests through chunked prefill and
             dense-slot decode (selective_scan, qmatmul, quantize and
             ubn_norm launches > 0); the same requests through the plain
             versions on the card, which must give the same tokens and
             first-step logits; a torch.profiler breakdown of the decode
             step and of one prefill page, each with K9's device time; then
             the same requests through monolithic prefill (K9 over each
             whole prompt), kernels against the plain versions.
  8. ssm_train  make_train_step on falcon-mamba-7b at every published
             width (as phase 7), 4 of 64 layers, seed 0, full8 native, one
             1 x 4096 TokenTask ("arith") sequence: 3 steps with their
             loss, wall time, peak memory, forward / backward / optimizer
             split and kernel launches (selective_scan, selective_scan_bwd,
             K1 wide, K2, K3 and K4 > 0 in every step); a torch.profiler
             breakdown of one more step with K9's and K9b's device time;
             then step 1 again from the same weights through the plain
             versions on the card, whose loss, parameters and accumulator
             must equal the kernel run's bit for bit; then the same 3
             steps with scan_dtype "bf16" (K9 and K9b on bf16 carriers),
             step 1 against the plain versions, walls and peak beside
             the fp32 run's.
  9. dense   granite-34b, phi4-mini-3.8b, minitron-4b and chameleon-34b,
             each at every published width, 2 layers, random weights from
             seed 0: greedy requests of 37 and 100 tokens, 8 new tokens
             each, through `make_engine` on the default monolithic prefill
             (K1, K2, K4, K5 and K6 launched), tokens and the first logits
             equal to the plain versions' run on the card; then one step
             of make_train_step on granite-34b (2 of 88 layers, 48 query
             heads on 1 KV head, FFN 24576) on a 1 x 4096 sequence, whose
             loss, parameters and accumulator equal the plain run's step.
 10. moe     the MoE LMs at every published width: granite-moe-1b-a400m
             (32 experts top-8, d 1024, FFN 512) at 6 of 24 layers,
             and moonshot-v1-16b-a3b (64 experts top-6, d 2048, FFN 1408)
             at 2 of 48 layers, random weights from seed 0: greedy
             requests of 37 and 100 tokens, 8 new tokens each, on 4 lanes
             through `make_engine` on monolithic prefill (K1 batched over
             the experts, K2, K4, K5 and K6 launched) and then on chunked
             prefill (page 16: capacity 5, K1's narrow route), tokens
             equal to the plain versions' runs and the first logits at
             distance 0; launches per decode step (dropless: capacity 32
             on granite), TTFT, decode ms a step and peak memory; then one
             make_train_step on a 1 x 4096 sequence (capacity 1280 on
             granite, 480 on moonshot), with its forward / backward /
             optimizer split, launches, the share of dropped (token,
             choice) pairs, a torch.profiler breakdown of one more step
             (K1's expert contractions, the router, the dispatch and the
             combine), and step 1 through the plain versions, whose loss,
             parameters and accumulator equal the kernel run's.
 11. modes   the reference's sim and fp32 numeric modes: the table of the
             reference's examples/quickstart.py on granite-3-8b at full
             width, 2 of 40 layers, from one init (full8's): 3 steps on
             one 1 x 4096 arith sequence in each of fp32, e2_16 native,
             full8 sim and full8 native, the four loss curves side by
             side with each mode's step walls and peak memory, and full8
             sim's distance from full8 native after step 1 (reported);
             sim serving of the serve phase's requests at 4 layers on
             monolithic and chunked prefill (launches per decode step:
             K7 and K2), tokens and first logits equal to the plain
             versions', first logits beside native's (reported);
             ResNet-50 2 steps of batch 32 in sim and in fp32;
             falcon-mamba-7b (4 of 64 layers) 3 fp32 steps on ssm_train's
             sequence beside ssm_train's full8 losses; one granite-moe
             sim step (2 of 24 layers).  Every sim and fp32 run equals its
             plain replay bit for bit (step-1 loss, parameters and
             accumulator; tokens and logits) and launches none of K1, K3,
             K4, K5 and K6; the sim runs launch K2.
 12. encdec  seamless-m4t-large-v2 (the enc-dec: d 1024, 16 heads of 64 on
             16 KV heads, FFN 8192 with gelu, LayerNorm, vocab 256206) at
             full width, 6 + 6 of its 24 encoder + 24 decoder layers
             (full depth, 1.63 G parameters, until the full_depth phase
             came; 12 + 12 until the dp phase), random weights from
             seed 0: 4 requests of 4096
             seeded N(0, 1) frames through `EncDec.prefill` (t_self
             1024) and 32 greedy `serve_step`s each from token 0, with the
             prefill wall, decode ms a step, tokens/s and the launches a
             decode step (no K6, no K7; K4 kind "layer" at 4 rows); the
             same through the plain versions, whose tokens and first
             logits must be equal bit for bit; then 3 make_train_step
             steps on 1 x 4096 frames and 1024 TokenTask ("arith")
             target tokens, with the step's split, peak memory, launches (K4 "layer" at
             4096 and 1024 rows, K5 on the encoder's, the decoder's and
             the cross shapes), K5's visited tiles on one forward (every
             tile of the non-causal calls), and step 1 through the plain
             versions, whose loss, parameters and accumulator must equal
             the kernel run's.
 13. hybrid  zamba2-7b (Mamba2 layers of d_model 3584, d_inner 7168 in 112
             SSD heads of 64, ssm_state 64, and one shared attention + MLP
             block of 32/32 heads of 112 and FFN 14336 after every 6) at
             full width, 13 of 81 layers (two groups of 6 and a 1-layer
             tail, so the shared block runs twice and the tail runs),
             random weights from seed 0: the serve phase's 4 greedy
             requests on 4 lanes, page 16, on monolithic prefill (K5 at dh
             112, K6 in decode; decode ms a step, TTFT, tokens/s, launches
             per decode step) against the plain versions' run, tokens and
             first logits equal; then chunked prefill with the radix cache
             over the first two requests and one more sharing the first
             prompt's first 4 pages (a hit, restoring the Mamba2 state
             snapshot): tokens and every lane's Mamba2 slot equal to the
             run without the cache, tokens equal to the plain run's; then 3
             make_train_step steps on 1 x 4096 TokenTask ("arith") tokens
             (the step's split, peak memory, K4 and K5 launches by shape,
             a profile of one more step) and step 1 through the plain
             versions, whose loss, parameters and accumulator must equal
             the kernel run's.
 14. full_depth  phi4-mini-3.8b (d 3072, 24 query / 8 KV heads of 128,
             FFN 8192, vocab 200064) at full width and all 32 layers
             (4.45 G parameters), random weights from seed 0, full8
             native, remat "full": 2 make_train_step steps on one 1 x
             4096 TokenTask ("arith") sequence with the split, peak
             memory (below the card's) and launches a step; then a model
             rebuilt from seed 0 takes step 1 through the plain versions,
             whose loss, parameters and accumulator must equal the kernel
             run's.
 15. dp      the data-parallel sharded step (make_sharded_train_step,
             runtime/compress.py's integer wire): granite-3-8b at full
             width, 2 of 40 layers, full8 native, a global batch of 2 x
             2048 TokenTask ("arith") tokens in n_shards=2 virtual shards,
             2 steps on the packed int16 wire: (a) in this process at
             dp=1; (b) in two spawned ranks that share the card through a
             gloo group (NCCL puts one rank on a card; the wire is staged
             through host memory), dp=2, replicated, whose parameters and
             accumulator after step 2 must equal (a)'s bit for bit (sha256
             of every leaf); (c) the same ranks from a model rebuilt from
             seed 0 with ZeRO-1, whose parameters, and accumulator chunks
             gathered into the flat layout, must equal (a)'s.  Each rank's
             K1-K5 launches must be > 0; per rank the step's wall split
             into forward+backward, sync (gloo over loopback, not an NCCL
             figure) and optimizer, the sync's bytes a step by dtype and
             the peak memory.  A rank that fails or outlives its timeout
             fails the phase.

`python3 chip_smoke.py PHASE ...` (e.g. `modes`) runs the build and the
named phases alone and prints no result lines.  It ends with a line `{"kernels": [...]}`, then the card line, then
`{"ok": true, "device": {...}}` as the last line.  Needs one card.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s, int8 tensor-core ops/s,
# fp32 (non-tensor) flop/s; bound_ms is the larger of bytes and operations
# over these rates
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
FP32_OPS = 67e12

RESULTS: list[dict] = []
# kernel row -> (phase, key): the run whose main-path launch count the row
# takes, and its key there ("none": no path launches it)
PHASE_OF: dict[str, tuple] = {}
# peak device memory in bytes by phase (the ckpt phase prints the resnet
# phase's beside its microbatched run's)
PEAK: dict[str, int] = {}
# train_steps' record of each run by tag (the modes phase compares runs)
RUNS: dict[str, dict] = {}


T0 = time.time()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since start."""
    print(f"[{time.time() - T0:7.1f}] {msg}", flush=True)


def bound_ms(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS, ops / rate if rate else 0.0
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


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


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def device_ms(fn, iters: int = 100) -> float:
    """Device time per call of `fn`: the profiler's kernel time over
    `iters` calls (beside time_ms, whose CUDA events also see the host's
    issue rate when the device finishes first).  100 calls, so one slow
    first kernel under a new profiler moves a few-microsecond mean little."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def record(name, source, replaces, ms, plain_ms, nbytes, ops, rate,
           library_ms, max_abs_err, phase="serve", device_ms=None,
           note=None):
    """One row of the kernels line.  `phase` names the run whose launch
    count the row takes: a phase (the op's own count there) or (phase,
    key) for a count the phase keeps under another key."""
    b, by = bound_ms(nbytes, ops, rate)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0,
           "max_abs_err": float(max_abs_err), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": library_ms}
    if device_ms is not None:
        row["device_ms"] = device_ms
    RESULTS.append(row)
    PHASE_OF[name] = phase if isinstance(phase, tuple) else (
        phase, name.removesuffix("_batch"))
    dev = "" if device_ms is None else f", device {device_ms:.4f} ms"
    log(f"  {name}: {ms:.4f} ms{dev} (bound {b:.4f} ms by {by}), plain "
        f"{plain_ms:.4f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
        f"max_abs_err {max_abs_err}" + (f" [{note}]" if note else ""))


# K1's launches by the contraction that makes them (core/qdense.py
# _int_contract's spec): the qdense forwards, and the attention chunks'
# scores (q . k^T, and dp = go . v^T), out (p . v, and dq = gs . k), dk and
# dv, which also serve the chunked prefill's two contractions
K1_BY_SPEC = {"mk,kn->mn": "qmatmul_qdense",
              "bskgd,btkd->bskgt": "qmatmul_attn_scores",
              "bskgt,btkd->bskgd": "qmatmul_attn_out",
              "bskgd,bskgt->btkd": "qmatmul_attn_dk",
              "bskgt,bskgd->btkd": "qmatmul_attn_dv",
              # the MoE's expert products (models/moe.py): gate and up, down,
              # and their backward specs (dx / dw of gate and up, dh / dw
              # of down)
              "ecd,edf->ecf": "qmatmul_moe_up",
              "ecf,efd->ecd": "qmatmul_moe_down",
              "ecf,edf->ecd": "qmatmul_moe_up_dx",
              "ecd,ecf->edf": "qmatmul_moe_up_dw",
              "ecd,efd->ecf": "qmatmul_moe_down_dh",
              "ecf,ecd->efd": "qmatmul_moe_down_dw"}


@contextlib.contextmanager
def k1_by_contraction(counts: dict, ranges: bool = False):
    """Count K1 launches by contraction into `counts` while inside; with
    `ranges`, each contraction also runs in a profiler range "K1 <key>"."""
    import importlib
    from torch.profiler import record_function
    from repro_torch.kernels import ops
    qd = importlib.import_module("repro_torch.core.qdense")
    real = qd._int_contract

    def spy(spec, a, b):
        key = K1_BY_SPEC.get(spec, "qmatmul_other")
        before = ops.LAUNCHES["qmatmul"]
        if ranges:
            with record_function(f"K1 {key}"):
                y = real(spec, a, b)
        else:
            y = real(spec, a, b)
        counts[key] = counts.get(key, 0) + ops.LAUNCHES["qmatmul"] - before
        return y

    qd._int_contract = spy
    try:
        yield counts
    finally:
        qd._int_contract = real


def attention_operands(i8) -> dict:
    """The operands _int_contract hands K1 for a training step's attention
    chunk (q chunk 1024 of 8 KV x 4 query heads of 128, kv chunk 512) and
    for a prefill page (16 tokens over 32 gathered pages, head-major),
    captured from its calls: name -> (a, b)."""
    import importlib
    from repro_torch.kernels import ops
    qd = importlib.import_module("repro_torch.core.qdense")
    q, k, sc = i8(1, 1024, 8, 4, 128), i8(1, 512, 8, 128), \
        i8(1, 1024, 8, 4, 512)
    kh = i8(1, 8, 512, 128).permute(0, 2, 1, 3)     # K7's head-major pages
    specs = {"scores": ("bskgd,btkd->bskgt", q, k),
             "out": ("bskgt,btkd->bskgd", sc, k),
             "dk": ("bskgd,bskgt->btkd", q, sc),
             "dv": ("bskgt,bskgd->btkd", sc, q),
             "prefill_scores": ("bskgd,btkd->bskgt", i8(1, 16, 8, 4, 128),
                                kh),
             "prefill_out": ("bskgt,btkd->bskgd", i8(1, 16, 8, 4, 512), kh)}
    seen, real = [], ops.qmatmul
    ops.qmatmul = lambda x, y, *a, **kw: seen.append((x, y)) or real(
        x, y, *a, **kw)
    try:
        for spec, x, y in specs.values():
            qd._int_contract(spec, x, y)
    finally:
        ops.qmatmul = real
    return dict(zip(specs, seen))


# the MoE rows of the kernels line: (experts, capacity, d_model, d_ff),
# the spec and the moe phase's launch key (model:run:contraction)
MOE_ROWS = {
    "moe_up": ((32, 1280, 1024, 512), "ecd,edf->ecf",
               "granite:train:qmatmul_moe_up"),
    "moe_down": ((32, 1280, 1024, 512), "ecf,efd->ecd",
                 "granite:train:qmatmul_moe_down"),
    "moe_up_dw": ((32, 1280, 1024, 512), "ecd,ecf->edf",
                  "granite:train:qmatmul_moe_up_dw"),
    "moe_down_dh": ((32, 1280, 1024, 512), "ecd,efd->ecf",
                    "granite:train:qmatmul_moe_down_dh"),
    "moe_up_decode": ((32, 32, 1024, 512), "ecd,edf->ecf",
                      "granite:decode:qmatmul_moe_up"),
    "moe_down_decode": ((32, 32, 1024, 512), "ecf,efd->ecd",
                        "granite:decode:qmatmul_moe_down"),
    "moe_up_moonshot": ((64, 480, 2048, 1408), "ecd,edf->ecf",
                        "moonshot:train:qmatmul_moe_up"),
    "moe_down_moonshot": ((64, 480, 2048, 1408), "ecf,efd->ecd",
                          "moonshot:train:qmatmul_moe_down")}


def moe_operands(i8) -> dict:
    """The operands _int_contract hands K1 for the MoE_ROWS contractions,
    captured from its calls: name -> (a, b, launch key)."""
    import importlib
    from repro_torch.kernels import ops
    qd = importlib.import_module("repro_torch.core.qdense")
    seen, real = [], ops.qmatmul
    ops.qmatmul = lambda x, y, *a, **kw: seen.append((x, y)) or real(
        x, y, *a, **kw)
    try:
        for (e, c, d, f), spec, _ in MOE_ROWS.values():
            size = {"e": e, "c": c, "d": d, "f": f}
            sa, sb = spec.split("->")[0].split(",")
            qd._int_contract(spec, i8(*(size[i] for i in sa)),
                             i8(*(size[i] for i in sb)))
    finally:
        ops.qmatmul = real
    return {name: (x, y, row[2])
            for (name, row), (x, y) in zip(MOE_ROWS.items(), seen)}


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> str:
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[build] card: {card}")
    import torch
    log(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    paths = _build.build()
    log(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s "
        f"into {_build.build_dir()}")
    for name, p in paths.items():
        logf = p.with_suffix(".log")
        info = [ln.strip() for ln in logf.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if logf.exists() else []
        for ln in info:
            log(f"  ptxas {name}: {ln}")
    return card


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_fill():
    """Deterministic mode (main) fills every torch.empty with NaN or the
    type's largest value: one more kernel per output of a wrapper, which no
    kernel needs (each writes its whole output) and which the library
    calls timed beside it do not pay (they allocate inside ATen).  The
    kernels phase runs without that fill; the phases after it keep it."""
    import torch.utils.deterministic as det
    with contextlib.ExitStack() as restore:
        restore.callback(setattr, det, "fill_uninitialized_memory",
                         det.fill_uninitialized_memory)
        det.fill_uninitialized_memory = False
        yield


def phase_kernels() -> None:
    with no_fill():
        kernel_rows()


def kernel_rows() -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def f32(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # ---- K1 qmatmul: every qdense shape of the path, both routes (M <= 16
    # narrow, M > 16 wide), transposed operands, the attention contractions
    # on the views _int_contract passes, a split requantize epilogue
    log("[kernels] K1 qmatmul (bitwise)")
    inv = torch.tensor(2.0 ** -14, device=dev)
    shapes = [(m, k, n) for m in (4, 16, 17, 4096) for (k, n) in
              ((4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096),
               # falcon-mamba-7b: in_proj, x_proj (ragged N), dt_proj,
               # out_proj
               (4096, 16384), (8192, 288), (256, 8192), (8192, 4096))]
    for m, k, n in shapes:
        a, b = i8(m, k), i8(k, n)
        got, want = ops.qmatmul(a, b), ref.qmatmul(a, b)
        assert torch.equal(got, want), f"qmatmul {m}x{k}x{n} differs"
        assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv)), \
            f"qmatmul requant {m}x{k}x{n} differs"
        if m in (4, 4096) and k == 4096 and n == 4096:
            at, bt = i8(k, m).t(), i8(n, k).t()     # transposed views
            for x, y in ((at, b), (a, bt), (at, bt)):
                assert torch.equal(ops.qmatmul(x, y), ref.qmatmul(x, y)), \
                    f"qmatmul {m}x{k}x{n} on transposed operands differs"
    for bt_, m, k, n in ((8, 64, 128, 512), (8, 64, 512, 128),
                         (8, 4096, 128, 512), (8, 4096, 512, 128),
                         (8, 512, 4096, 128), (8, 128, 4096, 512)):
        a, b = i8(bt_, m, k), i8(bt_, k, n)
        assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b)), \
            f"batched qmatmul {bt_}x{m}x{k}x{n} differs"
    attn = attention_operands(i8)
    for name, (x, y) in attn.items():
        assert torch.equal(ops.qmatmul(x, y), ref.qmatmul(x, y)), \
            f"qmatmul on the {name} views differs"
    log(f"  bitwise at {len(shapes)} qdense / SSM shapes (M 4, 16, 17, 4096; "
        f"plain and requantized), transposed A and B, six batched chunk "
        f"shapes and the path's attention views ({', '.join(attn)})")
    k, n = 4096, 12800               # w_gate / w_up: the largest
    for m, name, phase in ((4, "qmatmul_decode", ("serve", "qmatmul_decode")),
                           (16, "qmatmul_prefill",
                            ("serve", "qmatmul_prefill"))):
        a, b = i8(m, k), i8(k, n)
        ap = torch.cat([a, torch.zeros((32 - m, k), dtype=torch.int8,
                                       device=dev)])
        record(name, "src/repro_torch/csrc/qmatmul.cu",
               "src/repro/kernels/qmatmul.py:107",
               time_ms(lambda: ops.qmatmul(a, b)),
               time_ms(lambda: ref.qmatmul(a, b), 5),
               m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS,
               time_ms(lambda: torch._int_mm(ap, b)),
               max_err(ops.qmatmul(a, b), ref.qmatmul(a, b)), phase,
               device_ms=device_ms(lambda: ops.qmatmul(a, b)),
               note=f"library: torch._int_mm on A zero-padded to 32 rows "
                    f"(it takes M > 16 only)")
    m = 4096                          # the training step's w_gate / w_up
    a, b = i8(m, k), i8(k, n)
    record("qmatmul", "src/repro_torch/csrc/qmatmul.cu",
           "src/repro/kernels/qmatmul.py:107",
           time_ms(lambda: ops.qmatmul(a, b)),
           time_ms(lambda: ref.qmatmul(a, b), 3),
           m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS,
           time_ms(lambda: torch._int_mm(a, b)),
           max_err(ops.qmatmul(a, b), ref.qmatmul(a, b)),
           ("train", "qmatmul_qdense"),
           device_ms=device_ms(lambda: ops.qmatmul(a, b)))
    # the attention chunks as the training step's _chunked_core passes them
    # (q chunk 1024, kv chunk 512, 8 KV heads x 4 query heads of 128)
    for name, (x, y) in attn.items():
        if name.startswith("prefill"):
            continue
        z = math.prod(torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]))
        (m, k), n = x.shape[-2:], y.shape[-1]
        record(f"qmatmul_attn_{name}", "src/repro_torch/csrc/qmatmul.cu",
               "src/repro/kernels/qmatmul.py:107",
               time_ms(lambda: ops.qmatmul(x, y)),
               time_ms(lambda: ref.qmatmul(x, y), 3),
               x.numel() + y.numel() + 4 * z * m * n, 2 * z * m * k * n,
               INT8_OPS, None, max_err(ops.qmatmul(x, y), ref.qmatmul(x, y)),
               ("train", f"qmatmul_attn_{name}"),
               device_ms=device_ms(lambda: ops.qmatmul(x, y)),
               note=f"batch {z} x {m}x{k}x{n} on views")
    # the MoE's expert contractions, batched over the experts, on the
    # views _int_contract passes (granite-moe at train_4k and a 4-lane
    # decode step, moonshot at train_4k); no PyTorch call takes a batched
    # int8 product
    for name, (x, y, key) in moe_operands(i8).items():
        z, (m, k), n = x.shape[0], x.shape[-2:], y.shape[-1]
        record(f"qmatmul_{name}", "src/repro_torch/csrc/qmatmul.cu",
               "src/repro/kernels/qmatmul.py:107",
               time_ms(lambda: ops.qmatmul(x, y)),
               time_ms(lambda: ref.qmatmul(x, y), 3),
               x.numel() + y.numel() + 4 * z * m * n, 2 * z * m * k * n,
               INT8_OPS, None, max_err(ops.qmatmul(x, y), ref.qmatmul(x, y)),
               ("moe", key), device_ms=device_ms(lambda: ops.qmatmul(x, y)),
               note=f"{z} experts x {m}x{k}x{n}; launches: {key}")

    # ---- K3 dgrad / wgrad: every qdense of the training step, M = 4096
    # tokens; the three prologue modes (full8 = flag, e2_16 = affine k=16)
    log("[kernels] K3 dgrad / wgrad (bitwise)")
    m = 4096
    modes = (("affine", 8, 2.0 ** 14), ("affine", 16, 2.0 ** 22),
             ("flag", 8, 2.0 ** 13))
    for kd, n in ((4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)):
        e = f32(m, n) * 1e-3
        b8, a8 = i8(kd, n), i8(m, kd)
        for mode, kb, inv in modes:
            sc = torch.tensor([inv, 2.0 ** -20, 2.0 ** -27], device=dev)
            assert torch.equal(ops.dgrad(e, b8, sc, mode=mode, k=kb),
                               ref.dgrad(e, b8, sc, mode=mode, k=kb)), \
                f"dgrad {mode} k={kb} {m}x{n}x{kd} differs"
            assert torch.equal(ops.wgrad(a8, e, sc, mode=mode, k=kb),
                               ref.wgrad(a8, e, sc, mode=mode, k=kb)), \
                f"wgrad {mode} k={kb} {m}x{n}x{kd} differs"
    # ragged M, N and K (not multiples of the 128-wide tiles) and a small
    # output whose contraction splits across blocks
    for mr, nr, kdr in ((4100, 1000, 4160), (4096, 256, 256)):
        e = f32(mr, nr) * 1e-3
        b8, a8 = i8(kdr, nr), i8(mr, kdr)
        for mode, kb, inv in modes:
            sc = torch.tensor([inv, 2.0 ** -20, 2.0 ** -27], device=dev)
            assert torch.equal(ops.dgrad(e, b8, sc, mode=mode, k=kb),
                               ref.dgrad(e, b8, sc, mode=mode, k=kb)), \
                f"dgrad {mode} k={kb} {mr}x{nr}x{kdr} differs"
            assert torch.equal(ops.wgrad(a8, e, sc, mode=mode, k=kb),
                               ref.wgrad(a8, e, sc, mode=mode, k=kb)), \
                f"wgrad {mode} k={kb} {mr}x{nr}x{kdr} differs"
    log("  bitwise at the four qdense shapes, 4100x1000x4160 and "
        "4096x256x256 (split), three modes each")
    kd, n = 4096, 12800               # the backward of w_gate / w_up
    e = f32(m, n) * 1e-3
    b8, a8 = i8(kd, n), i8(m, kd)
    sc = torch.tensor([2.0 ** 13, 2.0 ** -20, 2.0 ** -27], device=dev)
    for mode, kb, inv in modes:
        sck = torch.tensor([inv, 2.0 ** -20, 2.0 ** -27], device=dev)
        log(f"  {mode} k={kb}: dgrad "
            f"{time_ms(lambda: ops.dgrad(e, b8, sck, mode=mode, k=kb)):.4f}"
            f" ms, wgrad "
            f"{time_ms(lambda: ops.wgrad(a8, e, sck, mode=mode, k=kb)):.4f}"
            f" ms")
    planes = ref.bwd_error_planes(e, sc[0], mode="flag", k=8)
    bt = b8.t().contiguous()
    at = a8.t().contiguous()
    nbytes = 4 * m * n + kd * n + 4 * m * kd
    record("dgrad", "src/repro_torch/csrc/backward.cu",
           "src/repro/kernels/backward.py:109",
           time_ms(lambda: ops.dgrad(e, b8, sc, mode="flag", k=8)),
           time_ms(lambda: ref.dgrad(e, b8, sc, mode="flag", k=8), 3),
           nbytes, 2 * 2 * m * n * kd, INT8_OPS,
           time_ms(lambda: [torch._int_mm(q, bt) for q in planes]),
           max_err(ops.dgrad(e, b8, sc, mode="flag", k=8),
                   ref.dgrad(e, b8, sc, mode="flag", k=8)), "train")
    record("wgrad", "src/repro_torch/csrc/backward.cu",
           "src/repro/kernels/backward.py:109",
           time_ms(lambda: ops.wgrad(a8, e, sc, mode="flag", k=8)),
           time_ms(lambda: ref.wgrad(a8, e, sc, mode="flag", k=8), 3),
           4 * m * n + m * kd + 4 * kd * n, 2 * 2 * m * n * kd, INT8_OPS,
           time_ms(lambda: [torch._int_mm(at, q.contiguous())
                            for q in planes]),
           max_err(ops.wgrad(a8, e, sc, mode="flag", k=8),
                   ref.wgrad(a8, e, sc, mode="flag", k=8)), "train")

    # ---- K5 flash_attention: one layer's causal attention at train_4k
    log("[kernels] K5 flash_attention (bitwise)")
    s_, h, kvh, dh = 4096, 32, 8, 128
    q8, k8, v8 = i8(1, s_, h, dh), i8(1, s_, kvh, dh), i8(1, s_, kvh, dh)
    pos = torch.arange(s_, device=dev, dtype=torch.int32)
    kval = torch.ones(s_, device=dev, dtype=torch.int32)
    scs = [torch.tensor(v, device=dev) for v in (2.0 ** -6, 2.0 ** -7,
                                                  2.0 ** -7)]
    fkw = dict(causal=True, sm_scale=dh ** -0.5, q_chunk=1024, kv_chunk=512)
    fargs = (q8, k8, v8, pos, pos, kval, *scs)
    got, want = ops.flash_attention(*fargs, **fkw), \
        ref.flash_attention(*fargs, **fkw)
    assert torch.equal(got, want), "flash_attention differs"
    kval2 = (pos < s_ - 300).to(torch.int32)       # padded kv slots
    nc = dict(fkw, causal=False)
    assert torch.equal(ops.flash_attention(q8, k8, v8, pos, pos, kval2,
                                           *scs, **nc),
                       ref.flash_attention(q8, k8, v8, pos, pos, kval2,
                                           *scs, **nc)), \
        "flash_attention (padded, not causal) differs"
    # the edge cases of the tile skip and the widened k_a, at train_4k's
    # widths: queries at the end of a longer context (q_pos = T - S + i),
    # the whole first kv chunk masked (leading padding), causal rows that
    # see no valid key at all (keys from position 1000 on), k_a = 4 (the
    # a4 preset), heads of 64, and 3 query heads per KV head (128-row
    # blocks that span q chunks, the last one partial)
    def fa_case(what, sq, t, qpos, kpos, kvalid, causal, hh=32, kh=8, d=128,
                k_a=8, qch=1024):
        qx, kx, vx = i8(1, sq, hh, d), i8(1, t, kh, d), i8(1, t, kh, d)
        kw = dict(causal=causal, sm_scale=d ** -0.5, q_chunk=qch,
                  kv_chunk=512, k_a=k_a)
        ax = (qx, kx, vx, qpos, kpos, kvalid, *scs)
        assert torch.equal(ops.flash_attention(*ax, **kw),
                           ref.flash_attention(*ax, **kw)), \
            f"flash_attention ({what}) differs"
    ones = torch.ones_like(pos)
    fa_case("offset positions", 1024, s_, pos[:1024] + s_ - 1024, pos, ones,
            True)
    for causal in (True, False):
        fa_case(f"leading padding, causal={causal}", s_, s_, pos, pos,
                (pos >= 512).to(torch.int32), causal)
    fa_case("rows without keys", s_, s_, pos, pos + 1000, ones, True)
    fa_case("k_a = 4", s_, s_, pos, pos, kval2, True, k_a=4)
    fa_case("dh = 64", s_, s_, pos, pos, kval2, True, d=64)
    fa_case("3 heads per KV head", 960, s_, pos[:960] + 3000, pos, ones,
            True, hh=24, qch=320)
    log("  bitwise at train_4k causal and padded, offset positions, leading "
        "padding (causal and not), rows without keys, k_a = 4, dh = 64, "
        "3 heads per KV head")
    visits = torch.zeros(2, dtype=torch.int64, device=dev)
    ops.flash_attention(*fargs, **fkw, visits=visits)
    tiles = kvh * (s_ * (h // kvh) // 128) * (s_ // 64)
    st_v, mn_v = visits.tolist()
    log(f"  train_4k causal: tiles visited {st_v} / {tiles} (stats launch), "
        f"{mn_v} / {tiles} (main launch): {1 - st_v / tiles:.4f} and "
        f"{1 - mn_v / tiles:.4f} skipped")
    miss = ops.flash_pcode_mismatches(dev)
    log(f"  p codes from thresholds against float(exp(double(x))) over every "
        f"fp32 x <= 0, k_a 2..8: mismatches {miss}")
    assert miss == [0] * 7, "flash_attention p codes differ"
    qb = (q8.float() * scs[0]).to(torch.bfloat16).transpose(1, 2)
    kb_ = (k8.float() * scs[1]).to(torch.bfloat16).transpose(1, 2)
    vb = (v8.float() * scs[2]).to(torch.bfloat16).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = s_ * (s_ + 1) // 2          # causal: the scores this data needs
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/paged_attention.py:304",
           time_ms(lambda: ops.flash_attention(*fargs, **fkw), 5),
           time_ms(lambda: ref.flash_attention(*fargs, **fkw), 2),
           q8.numel() + 2 * k8.numel() + 4 * got.numel(),
           2 * 2 * pairs * h * dh, INT8_OPS,
           time_ms(lambda: sdpa(qb, kb_, vb, is_causal=True,
                                enable_gqa=True), 5),
           max_err(got, want), "train")

    # ---- K5 at monolithic prefill's shapes (the serve_mono phase's
    # prompts): a prompt shorter than the kv chunk is one ragged chunk
    # (kv_chunk = T, padded inside with absent keys); 1500 tokens run q
    # chunks of 1024 and kv chunks of 512, padded as _FlashFused pads them
    log("[kernels] K5 flash_attention at the prefill shapes (bitwise)")

    def prefill_args(t):
        qc, kc = min(1024, t), min(512, t)
        sp, tp = -t % qc, -t % kc
        ar = torch.arange(t, device=dev, dtype=torch.int32)
        zq = torch.zeros(sp, device=dev, dtype=torch.int32)
        zk = torch.zeros(tp, device=dev, dtype=torch.int32)
        return ((i8(1, t + sp, h, dh), i8(1, t + tp, kvh, dh),
                 i8(1, t + tp, kvh, dh), torch.cat([ar, zq]),
                 torch.cat([ar, zk]), torch.cat([torch.ones_like(ar), zk]),
                 *scs),
                dict(causal=True, sm_scale=dh ** -0.5, q_chunk=qc,
                     kv_chunk=kc))

    for t in MONO_PROMPT_LENS:
        pa, pk = prefill_args(t)
        before = ops.LAUNCHES["flash_attention"]
        assert torch.equal(ops.flash_attention(*pa, **pk),
                           ref.flash_attention(*pa, **pk)), \
            f"flash_attention (prefill of {t} tokens) differs"
        assert ops.LAUNCHES["flash_attention"] == before + 1, \
            f"flash_attention (prefill of {t} tokens) did not launch"
    log(f"  bitwise at prompts of {MONO_PROMPT_LENS} tokens (below 512 one "
        f"kv chunk of T; 100 and 37 ragged, padded inside)")
    pa, pk = prefill_args(100)
    got, want = ops.flash_attention(*pa, **pk), ref.flash_attention(*pa, **pk)
    qb, kb_, vb = ((x.float() * c).to(torch.bfloat16).transpose(1, 2)
                   for x, c in zip(pa[:3], scs))
    record("flash_attention_prefill",
           "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/paged_attention.py:304",
           time_ms(lambda: ops.flash_attention(*pa, **pk)),
           time_ms(lambda: ref.flash_attention(*pa, **pk), 5),
           pa[0].numel() + 2 * pa[1].numel() + 4 * got.numel(),
           2 * 2 * (100 * 101 // 2) * h * dh, INT8_OPS,
           time_ms(lambda: sdpa(qb, kb_, vb, is_causal=True,
                                enable_gqa=True)),
           max_err(got, want), ("serve_mono", "flash_attention"),
           device_ms=device_ms(lambda: ops.flash_attention(*pa, **pk)),
           note="monolithic prefill of 100 tokens: 1 x 100, 32/8 heads of "
                "128, kv_chunk 100; library: SDPA bf16")

    # ---- K2 quantize: the largest per-forward weight (Q_W of w_gate)
    log("[kernels] K2 quantize (bitwise)")
    w = f32(4096, 12800) * 0.02
    inv = torch.tensor(128.0, device=dev)
    assert torch.equal(ops.quantize(w, inv), ref.quantize(w, inv))
    x = f32(16, 4096) * 3
    inv2 = torch.tensor(2.0 ** 5, device=dev)
    assert torch.equal(ops.quantize(x, inv2), ref.quantize(x, inv2))
    xo = f32(1, 4097)[:, 1:]          # unaligned view: scalar path
    assert torch.equal(ops.quantize(xo, inv2), ref.quantize(xo, inv2))
    record("quantize", "src/repro_torch/csrc/quantize.cu",
           "src/repro/kernels/quantize.py:40",
           time_ms(lambda: ops.quantize(w, inv)),
           time_ms(lambda: ref.quantize(w, inv), 5),
           5 * w.numel(), 3 * w.numel(), FP32_OPS,
           time_ms(lambda: torch.quantize_per_tensor(w, 1.0 / 128.0, 0,
                                                     torch.qint8)), 0,
           note="library: torch.quantize_per_tensor to qint8, which clamps "
                "to [-128, 127] where K2 clamps to [-127, 127]")

    # ---- K4 ubn_norm (rms, layer): rows of a decode step (4), a prefill
    # page (16) and the training shape (4096), on both routes (a row over a
    # cluster of blocks below the SM count, a block a row above it), N of
    # the path, twice it and ragged, N(0, 1) and k_BN-grid values.
    # Bitwise: the row sums are float64 rounded once on both sides, and the
    # kernel's fp32 __fdiv_rn / __fsqrt_rn are the plain version's float64
    # division and sqrt rounded once (the exhaustive check below)
    log("[kernels] K4 ubn_norm rows (bitwise; rms and layer, both routes)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in ("rms", "layer"):
        for m in (1, 4, 16, 512, 4096):
            for n in (4096, 8192, 4097):
                x = f32(m, n) * 2
                gam, bet = 1.0 + 0.1 * f32(n), 0.1 * f32(n)
                for xx in (x, torch.round(x * 2.0 ** 15) / 2.0 ** 15):
                    assert torch.equal(
                        ops.ubn_norm(xx, gam, bet, kind=kind),
                        ref.ubn_norm(xx, gam, bet, kind=kind)), \
                        f"ubn_norm {kind} {m}x{n} differs"
    miss = ops.fp32_rounding_mismatches(dev)
    log(f"  fp32 __fdiv_rn and __fsqrt_rn against float64 rounded once: "
        f"mismatches {miss} (2^28 random divisions, every pair of "
        f"{2 * len(ops._FP32_EDGES)} edge values, all 2^32 sqrt inputs)")
    assert miss == [0, 0, 0], "fp32 division or sqrt differs"
    eps = 2.0 ** -8
    gam, bet = 1.0 + 0.1 * f32(4096), 0.1 * f32(4096)
    for name, m, kind, phase in (
            ("ubn_norm_decode", 4, "rms", ("serve", "ubn_norm_decode")),
            ("ubn_norm", 16, "rms", "serve"),
            ("ubn_norm_train", 4096, "rms", ("train", "ubn_norm")),
            ("ubn_norm_layer", 16, "layer", ("none", "ubn_norm"))):
        x = f32(m, 4096) * 2
        call = lambda: ops.ubn_norm(x, gam, bet, kind=kind)  # noqa: E731
        if kind == "rms":
            lib = lambda: F.rms_norm(x, (4096,), gam, eps)  # noqa: E731
        else:
            lib = lambda: F.layer_norm(x, (4096,), gam, bet, eps)  # noqa
        record(name, "src/repro_torch/csrc/ubn.cu",
               "src/repro/kernels/ubn.py:110", time_ms(call),
               time_ms(lambda: ref.ubn_norm(x, gam, bet, kind=kind)),
               8 * x.numel() + 4 * 4096 * (1 if kind == "rms" else 2),
               8 * x.numel(), FP32_OPS, time_ms(lib),
               max_err(call(), ref.ubn_norm(x, gam, bet, kind=kind)), phase,
               device_ms=device_ms(call),
               note=f"{m}x4096 {kind}, {ops.ubn_cluster(m, sms)} block(s) "
                    f"a row; library F.{kind}_norm, device "
                    f"{device_ms(lib):.4f} ms")

    encdec_kernel_rows(i8, f32, sms)
    hybrid_kernel_rows(i8)

    # ---- K4 ubn_norm (batch): ResNet-50's BNs at batch 32 flatten NHWC to
    # (N*H*W, C): every shape of a step (RESNET50_BN), on both routes (a
    # strip over a cluster, x read once, at four of them; two passes at the
    # others), N(0, 1) and grid values, ragged shapes on both routes and
    # an unaligned view.  Bitwise: float64 sums in a fixed order rounded once, and
    # __fdiv_rn / __fsqrt_rn equal to float64 rounded once (the check
    # above).  A row per step shape, with its launches in the resnet run
    log("[kernels] K4 ubn_norm batch (bitwise; every BN shape of a "
        "ResNet-50 step)")
    xu = f32(1000 * 96 + 1)[1:].view(1000, 96)     # starts 4 bytes in
    for (m, c) in list(RESNET50_BN) + [(12345, 96), (30001, 38), (1, 9),
                                       (1568, 2047)]:
        x = f32(m, c) * 2 + 0.3
        gam, bet = 1.0 + 0.1 * f32(c), 0.1 * f32(c)
        for xx in (x, torch.round(x * 64) / 64) + (
                (xu,) if (m, c) == (1000, 96) else ()):
            assert torch.equal(ops.ubn_norm(xx, gam, bet, kind="batch"),
                               ref.ubn_norm(xx, gam, bet, kind="batch")), \
                f"ubn_norm batch {m}x{c} differs"
        if (m, c) not in RESNET50_BN:
            continue
        call = lambda: ops.ubn_norm(x, gam, bet, kind="batch")  # noqa: E731
        lib = lambda: F.batch_norm(x, None, None, gam, bet,  # noqa: E731
                                   training=True, eps=2.0 ** -8)
        p = ops.ubn_batch_plan(m, c, sms)
        name = "ubn_norm_batch" if (m, c) == (100352, 256) \
            else f"ubn_norm_batch_{m}x{c}"
        record(name, "src/repro_torch/csrc/ubn.cu",
               "src/repro/kernels/ubn.py:110", time_ms(call),
               time_ms(lambda: ref.ubn_norm(x, gam, bet, kind="batch"), 3),
               8 * m * c + 8 * c, 8 * m * c, FP32_OPS, time_ms(lib),
               max_err(call(), ref.ubn_norm(x, gam, bet, kind="batch")),
               ("resnet", f"ubn_norm_batch_{m}x{c}"),
               device_ms=device_ms(call),
               note=f"{m}x{c}, {p['route']} (cw {p['cw']}, cl {p['cl']}), "
                    f"{RESNET50_BN[(m, c)]} calls a step; x read twice "
                    f"would bound it at "
                    f"{bound_ms(12 * m * c + 8 * c, 0, FP32_OPS)[0]:.4f} ms;"
                    f" library F.batch_norm(training=True), device "
                    f"{device_ms(lib):.4f} ms")
        del x

    # ---- K8 cq_stochastic: no path calls it; a ResNet-50 weight leaf's
    # shape (3x3x512 -> 512) and a ragged one, from int32 random bits
    log("[kernels] K8 cq_stochastic (bitwise)")
    inv = torch.tensor(2.0 ** 12, device=dev)
    for shape in ((4608, 512), (37, 1001)):
        x = f32(*shape) * 0.02
        bits = torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             device=dev, dtype=torch.int32)
        for dr in (128.0, 64.0):
            assert torch.equal(ops.cq_stochastic(x, bits, inv, dr),
                               ref.cq_stochastic(x, bits, inv, dr)), \
                f"cq_stochastic {shape} dr={dr} differs"
    x = f32(4608, 512) * 0.02
    bits = torch.randint(-2 ** 31, 2 ** 31, x.shape, generator=g,
                         device=dev, dtype=torch.int32)
    record("cq_stochastic", "src/repro_torch/csrc/quantize.cu",
           "src/repro/kernels/quantize.py:74",
           time_ms(lambda: ops.cq_stochastic(x, bits, inv)),
           time_ms(lambda: ref.cq_stochastic(x, bits, inv)),
           10 * x.numel(), 6 * x.numel(), FP32_OPS, None,
           max_err(ops.cq_stochastic(x, bits, inv),
                   ref.cq_stochastic(x, bits, inv)), "none")

    # ---- K7 page_gather: one lane's 32 pages of (16, 8, 128) int8, K and V
    # in one launch, head-major (the prefill page's call), and one pool in
    # the default layout (no path calls that now)
    log("[kernels] K7 page_gather (bitwise)")
    pages, vpages = i8(129, 16, 8, 128), i8(129, 16, 8, 128)
    table = torch.randint(-3, 140, (4, 32), generator=g, device=dev,
                          dtype=torch.int32)            # ids past P clamp
    for hm in (False, True):
        got = ops.page_gather(pages, table, pages2=vpages, head_major=hm)
        with ops.plain_reference():
            want = ops.page_gather(pages, table, pages2=vpages, head_major=hm)
        assert all(map(torch.equal, got, want)), "page_gather (2 pools) differs"
        assert torch.equal(ops.page_gather(pages, table, head_major=hm),
                           want[0]), "page_gather (1 pool) differs"
    t1 = torch.randperm(128, generator=g, device=dev)[:32].reshape(1, 32)
    t1 = (t1 + 1).to(torch.int32)             # one lane's 32 valid pages
    page_bytes = 16 * 8 * 128
    kv_call = lambda: ops.page_gather(pages, t1, pages2=vpages,  # noqa: E731
                                      head_major=True)
    with ops.plain_reference():
        kv_plain = lambda: ops.page_gather(  # noqa: E731
            pages, t1, pages2=vpages, head_major=True)
        plain_kv = time_ms(kv_plain)
        want = kv_plain()
    idx = t1.long()

    def kv_index():         # indexing, then each pool's head-major view
        return tuple(p[idx].permute(0, 3, 1, 2, 4).flatten(2, 3)
                     for p in (pages, vpages))

    assert all(map(torch.equal, kv_index(), want)), \
        "indexing plus permute is not K7's function"
    record("page_gather", "src/repro_torch/csrc/page_gather.cu",
           "src/repro/kernels/page_gather.py:48", time_ms(kv_call), plain_kv,
           2 * 2 * 32 * page_bytes + 4 * 32, 0, FP32_OPS,
           time_ms(kv_index),
           max(max_err(x, y) for x, y in zip(kv_call(), want)),
           device_ms=device_ms(kv_call),
           note=f"K and V of 32 pages, head-major; library: two indexings "
                f"plus permute, device {device_ms(kv_index):.4f} ms")
    # one pool at the unfused decode route's shape (serve_mono phase): 4
    # lanes' tables of 128 pages (max_ctx 2048) over a layer's 513 pages
    upages = i8(513, 16, 8, 128)
    t4 = torch.randperm(512, generator=g, device=dev).reshape(4, 128)
    t4 = (t4 + 1).to(torch.int32)
    record("page_gather_one_pool", "src/repro_torch/csrc/page_gather.cu",
           "src/repro/kernels/page_gather.py:48",
           time_ms(lambda: ops.page_gather(upages, t4)),
           time_ms(lambda: ref.page_gather(upages, t4)),
           2 * 512 * page_bytes + 4 * 512, 0, FP32_OPS,
           time_ms(lambda: upages[t4.long()]),
           max_err(ops.page_gather(upages, t4), ref.page_gather(upages, t4)),
           ("serve_mono", "page_gather_unfused_decode"),
           device_ms=device_ms(lambda: ops.page_gather(upages, t4)),
           note="one pool, 4 lanes x 128 pages (the unfused decode route's "
                "call); launches: the unfused run's decode steps")

    # ---- K6 paged_attention: 4 decode lanes of 32 heads over 8 KV heads
    # (T 512), edge cases of the sweep, and 16 lanes at long context.
    # Bitwise: m, l, the probability payload p8 and the output (l is a
    # float64 sum rounded once and exp is float64 rounded once on both
    # sides; the divisions are fp32 __fdiv_rn, checked above against the
    # float64 division rounded once, csrc/paged_attention.cu)
    log("[kernels] K6 paged_attention (bitwise: m, l, p8, out)")
    kp, vp = i8(129, 16, 8, 128), i8(129, 16, 8, 128)
    q8 = i8(4, 32, 128)
    tbl = torch.arange(1, 129, device=dev, dtype=torch.int32).reshape(4, 32)
    q_pos = torch.tensor([115, 52, 271, 79], device=dev, dtype=torch.int32)
    t_valid = q_pos.max() + 1
    sc = [torch.tensor(s, device=dev) for s in (2.0 ** -6, 2.0 ** -7,
                                                 2.0 ** -7)]
    sm = 1.0 / math.sqrt(128)
    args = (q8, kp, vp, tbl, q_pos, t_valid, *sc)

    def pa_equal(args, what, **kw):
        pk = ops.paged_attention_parts(*args, **kw)
        pp = ref.paged_attention_parts(*args, **kw)
        for part in ("m", "l", "p8", "out"):
            assert torch.equal(pk[part], pp[part]), \
                f"paged_attention {part} differs ({what})"
        return pk, pp

    pk, pp = pa_equal(args, "chip_smoke's row", sm_scale=sm)
    # the sweep's edge cases: a dead lane at position 0 (its table row is
    # the trash page 0), ends mid-page and on a page edge, t_valid below
    # q_pos + 1, rows with every position masked, q_scale * k_scale so
    # large that every lane sweeps all T; g 1, 8 and 48, dh 64, k_a 4
    dead = tbl.clone()
    dead[0] = 0
    for what, tb, qp, tv, kw, scl in (
            ("lane 0 dead, ends mid-page and on page edges", dead,
             [0, 15, 16, 511], 512, {}, sc),
            ("t_valid below q_pos + 1", tbl, [300, 52, 271, 79], 100, {}, sc),
            ("every position masked", tbl, [-1, 5, 60, -7], 128, {}, sc),
            ("t_valid 0", tbl, [5, 60, 3, 9], 0, {}, sc),
            ("k_a 4", tbl, [10, 100, 127, 3], 128, {"k_a": 4}, sc),
            ("scores past the sweep bound", tbl, [10, 60, 200, 3], 512, {},
             [torch.tensor(s, device=dev) for s in (2.0 ** 10, 2.0 ** 10,
                                                     1.0)])):
        pa_equal((q8, kp, vp, tb, torch.tensor(qp, device=dev,
                                               dtype=torch.int32), tv,
                  *scl), what, sm_scale=sm, **kw)
    for gq, kvh, dh in ((1, 8, 128), (8, 4, 128), (48, 1, 128), (4, 8, 64)):
        pools = [i8(33, 16, kvh, dh) for _ in range(2)]
        pa_equal((i8(4, gq * kvh, dh), *pools, tbl[:, :8] % 33,
                  torch.tensor([10, 100, 127, 3], device=dev,
                               dtype=torch.int32), 128, *sc),
                 f"g {gq}, dh {dh}", sm_scale=dh ** -0.5)
    call = lambda: ops.paged_attention(*args, sm_scale=sm)  # noqa: E731
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    host = [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.device_type == torch.autograd.DeviceType.CPU]
    first = min((i for i, n in enumerate(host) if "Launch" in n),
                default=len(host))
    assert first < len(host) and not any(
        n.startswith("aten::") for n in host[first:]), \
        "paged_attention: a PyTorch op between its launches"
    # the card's side over ten calls (a profile of one call can come back
    # without its device events)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    on_card = [e.name[:40] for e in sorted(prof.events(),
                                           key=lambda e: e.time_range.start)
               if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"  one call: {len(on_card) / 10:g} launches on the card "
        f"{on_card[:3]}; on the host, in order: {host}")
    assert 0 < len(on_card) <= 30, "paged_attention: more than 3 launches"

    def sdpa_case(q8, kp, vp, tbl, q_pos, *_):
        """SDPA's inputs: q and K/V gathered through the table and
        dequantized to bf16 beforehand (the gather is not timed), with a
        length mask; GQA by enable_gqa."""
        b, h, dh = q8.shape
        kv = kp.shape[2]
        idx = tbl.long()
        kf, vf = ((p[idx].flatten(1, 2).permute(0, 2, 1, 3).float() * s)
                  .to(torch.bfloat16) for p, s in ((kp, sc[1]), (vp, sc[2])))
        qf = (q8.float() * sc[0]).to(torch.bfloat16).reshape(b, h, 1, dh)
        t = kf.shape[2]
        mask = (torch.arange(t, device=dev)[None, :]
                <= q_pos[:, None].long())[:, None, None, :]
        assert kf.shape == (b, kv, t, dh)
        return lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask, enable_gqa=True)

    lib = sdpa_case(*args)
    valid = int((q_pos + 1).sum())
    record("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
           "src/repro/kernels/paged_attention.py:154", time_ms(call),
           time_ms(lambda: ref.paged_attention(*args, sm_scale=sm)),
           2 * valid * 8 * 128 + q8.numel() + 4 * tbl.numel()
           + 4 * 4 * 32 * 128, 2 * 2 * valid * 32 * 128, INT8_OPS,
           time_ms(lib), float((pk["out"] - pp["out"]).abs().max()),
           device_ms=device_ms(call),
           note=f"4 lanes at 115/52/271/79 of 512; library SDPA bf16 on "
                f"K/V gathered and dequantized beforehand (gather not "
                f"timed), device {device_ms(lib):.4f} ms")
    # 16 lanes at long context: NB * page 2048, positions 1024-2047
    kp, vp = i8(2049, 16, 8, 128), i8(2049, 16, 8, 128)
    q8 = i8(16, 32, 128)
    tbl = torch.arange(1, 2049, device=dev, dtype=torch.int32).reshape(16,
                                                                       128)
    q_pos = torch.randint(1024, 2048, (16,), generator=g, device=dev,
                          dtype=torch.int32)
    args = (q8, kp, vp, tbl, q_pos, q_pos.max() + 1, *sc)
    pk, pp = pa_equal(args, "long context", sm_scale=sm)
    call = lambda: ops.paged_attention(*args, sm_scale=sm)  # noqa: E731
    lib = sdpa_case(*args)
    valid = int((q_pos + 1).sum())
    record("paged_attention_long", "src/repro_torch/csrc/paged_attention.cu",
           "src/repro/kernels/paged_attention.py:154", time_ms(call),
           time_ms(lambda: ref.paged_attention(*args, sm_scale=sm), 5),
           2 * valid * 8 * 128 + q8.numel() + 4 * tbl.numel()
           + 4 * 16 * 32 * 128, 2 * 2 * valid * 32 * 128, INT8_OPS,
           time_ms(lib), float((pk["out"] - pp["out"]).abs().max()),
           ("none", "paged_attention"), device_ms=device_ms(call),
           note=f"16 lanes, {valid} live positions of 16 x 2048 (no path "
                f"runs it); library SDPA bf16 as above, device "
                f"{device_ms(lib):.4f} ms")
    del kp, vp, pk, pp

    # ---- K9 selective_scan: falcon-mamba-7b's d_inner 8192 x N 16 at a
    # prefill page and a decode step (carried state, the ssm phase's
    # shapes), the train_4k length from zero state (exactly the TPU
    # kernel's function, and the ssm_train phase's forward) and a ragged
    # shape.  Bitwise: h rounds twice per step and y is the n-ordered
    # float64 sum rounded once on both sides
    log("[kernels] K9 selective_scan (bitwise: y and h_last)")

    def scan_inputs(b, s_, d, n):
        dt = torch.empty((b, s_, d), device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=g).exp()
        a_ = torch.exp(dt[..., None] * -torch.arange(
            1, n + 1, device=dev, dtype=torch.float32))
        return (a_, f32(b, s_, d, n) * 0.1, f32(b, s_, n), f32(b, d, n))

    for name, shape, with_h0, phase in (
            ("selective_scan", (1, 16, 8192, 16), True, "ssm"),
            ("selective_scan_decode", (4, 1, 8192, 16), True, "ssm"),
            ("selective_scan_train_4k", (1, 4096, 8192, 16), False,
             ("ssm_train", "selective_scan")),
            (None, (2, 37, 1000, 4), True, None),
            (None, (1, 17, 8192, 16), True, None),
            (None, (2, 33, 300, 4), False, None)):
        a_, b_, c_, h0 = scan_inputs(*shape)
        h0 = h0 if with_h0 else None
        y, hl = ops.selective_scan(a_, b_, c_, h0)
        yp, hp = ref.selective_scan(a_, b_, c_, h0)
        assert torch.equal(y, yp) and torch.equal(hl, hp), \
            f"selective_scan {shape} differs"
        if name is None:
            continue
        nbytes = 4 * (2 * a_.numel() + c_.numel() + y.numel()
                      + (2 if with_h0 else 1) * hl.numel())
        call = lambda: ops.selective_scan(a_, b_, c_, h0)  # noqa: E731
        p = ops.sscan_plan(*shape, sms)
        record(name, "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan.py:60", time_ms(call),
               time_ms(lambda: ref.selective_scan(a_, b_, c_, h0),
                       2 if shape[1] > 16 else 5),
               nbytes, 4 * a_.numel(), FP32_OPS, None,
               max(max_err(y, yp), max_err(hl, hp)), phase,
               device_ms=device_ms(call),
               note=f"{'x'.join(map(str, shape))}, {p['route']} route "
                    f"(tile {p['tile']}, stages {p['stages']})")
        del a_, b_, c_, h0, y, hl, yp, hp

    # ---- K9b selective_scan_bwd: the scan's gradient at the ssm_train
    # step's shape (train mode: no h0, no dh_last) and ragged shapes (S
    # across its 8-step chunks, D across its dc tiles).  Bitwise: h
    # recomputed with the forward's roundings, the carry and products
    # rounded once, dc's float64 sum in one stated order on both sides
    log("[kernels] K9b selective_scan_bwd (bitwise: da, db, dc, dh0)")
    for name, shape, with_h0 in (
            ("selective_scan_bwd", (1, TRAIN_SEQ, 8192, 16), False),
            (None, (2, 37, 1000, 4), True),
            (None, (3, 9, 65, 16), True),
            (None, (1, 17, 8192, 16), False)):
        a_, b_, c_, h0 = scan_inputs(*shape)
        h0 = h0 if with_h0 else None
        dy = f32(*shape[:3])
        dh = None if h0 is None else f32(*h0.shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = ops.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = ref.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        err = max(max_err(x, w) for x, w in zip(got, want) if x is not None)
        assert all((x is None and w is None) or torch.equal(x, w)
                   for x, w in zip(got, want)), \
            f"selective_scan_bwd {shape} differs"
        if name is None:
            continue
        del want
        # bytes: a and b read once, c, dy (and h0, dh_last) read, da and db
        # written, dc (and dh0) written; operations: the recomputed step
        # (2), the reverse step (4: dy*c, the add, g*h, a*g) and dc's
        # product and sum (2) per element
        nbytes = 4 * (4 * a_.numel() + c_.numel() + dy.numel()
                      + c_.numel() + (3 if with_h0 else 0) * a_[:, 0].numel())
        def call():
            return ops.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        record(name, "src/repro_torch/csrc/selective_scan_bwd.cu",
               "none (port-only K9b: the reference differentiates its XLA "
               "scan, src/repro/models/ssm.py:85)", time_ms(call, 5),
               time_ms(lambda: ref.selective_scan_bwd(a_, b_, c_, dy, h0,
                                                      dh), 1),
               nbytes, 8 * a_.numel(), FP32_OPS, None, err, "ssm_train",
               device_ms=device_ms(call, 10),
               note=f"{'x'.join(map(str, shape))}, a and b read twice, "
                    f"peak memory of a call {peak / 1e9:.3f} GB beside "
                    f"{4 * a_.numel() / 1e9:.3f} GB for each of a, b, da "
                    f"and db; no PyTorch call computes it")
        del a_, b_, c_, h0, dy, dh, got
    scan_bf16_rows(scan_inputs, f32, sms)


def scan_bf16_rows(scan_inputs, f32, sms: int) -> None:
    """K9 and K9b on bf16 carriers (QConfig.scan_dtype "bf16"): bitwise
    against their plain versions (the fp32 route on the exact fp32 values,
    each output rounded once to bf16) at a prefill page, train_4k and
    ragged shapes across the staged tiles and K9b's chunks (N 4 runs the
    direct route); rows at the prefill page (no path serves with bf16
    carriers: 0 launches) and at train_4k, whose launches come from
    ssm_train's bf16 run."""
    import torch
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    log("[kernels] K9 selective_scan on bf16 carriers (bitwise: y and "
        "h_last)")
    for name, shape, with_h0, phase in (
            ("selective_scan_bf16", (1, 16, 8192, 16), True, "none"),
            ("selective_scan_bf16_train_4k", (1, TRAIN_SEQ, 8192, 16),
             False, ("ssm_train", "bf16:selective_scan")),
            (None, (1, 17, 8192, 16), True, None),
            (None, (2, 33, 300, 16), False, None),
            (None, (2, 37, 1000, 4), True, None)):
        a_, b_, c_, h0 = (t.to(bf) for t in scan_inputs(*shape))
        h0 = h0 if with_h0 else None
        y, hl = ops.selective_scan(a_, b_, c_, h0)
        yp, hp = ref.selective_scan(a_, b_, c_, h0)
        assert y.dtype == bf and torch.equal(y, yp) and torch.equal(hl, hp), \
            f"selective_scan bf16 {shape} differs"
        if name is None:
            continue
        nbytes = 2 * (2 * a_.numel() + c_.numel() + y.numel()
                      + (2 if with_h0 else 1) * hl.numel())
        call = lambda: ops.selective_scan(a_, b_, c_, h0)  # noqa: E731
        p = ops.sscan_plan(*shape, sms, 2)
        record(name, "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan.py:60", time_ms(call),
               time_ms(lambda: ref.selective_scan(a_, b_, c_, h0),
                       2 if shape[1] > 16 else 5),
               nbytes, 4 * a_.numel(), FP32_OPS, None,
               max(max_err(y, yp), max_err(hl, hp)), phase,
               device_ms=device_ms(call),
               note=f"{'x'.join(map(str, shape))} bf16, {p['route']} route "
                    f"(tile {p['tile']}, stages {p['stages']}, "
                    f"{p['smem']} B shared)")
        del a_, b_, c_, h0, y, hl, yp, hp

    log("[kernels] K9b selective_scan_bwd on bf16 carriers (bitwise: da, "
        "db, dc, dh0)")
    for name, shape, with_h0 in (
            ("selective_scan_bwd_bf16", (1, TRAIN_SEQ, 8192, 16), False),
            (None, (2, 37, 1000, 4), True),
            (None, (3, 9, 65, 16), True),
            (None, (1, 17, 8192, 16), False)):
        a_, b_, c_, h0 = (t.to(bf) for t in scan_inputs(*shape))
        h0 = h0 if with_h0 else None
        dy = f32(*shape[:3]).to(bf)
        dh = None if h0 is None else f32(*h0.shape).to(bf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = ops.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = ref.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        err = max(max_err(x, w) for x, w in zip(got, want) if x is not None)
        assert all((x is None and w is None) or torch.equal(x, w)
                   for x, w in zip(got, want)), \
            f"selective_scan_bwd bf16 {shape} differs"
        if name is None:
            continue
        del want
        # the fp32 row's count at 2 bytes an element; the checkpoint buffer
        # is scratch and not counted
        nbytes = 2 * (4 * a_.numel() + c_.numel() + dy.numel()
                      + c_.numel() + (3 if with_h0 else 0) * a_[:, 0].numel())

        def call():
            return ops.selective_scan_bwd(a_, b_, c_, dy, h0, dh)
        record(name, "src/repro_torch/csrc/selective_scan_bwd.cu",
               "none (port-only K9b: the reference differentiates its XLA "
               "scan, src/repro/models/ssm.py:85)", time_ms(call, 5),
               time_ms(lambda: ref.selective_scan_bwd(a_, b_, c_, dy, h0,
                                                      dh), 1),
               nbytes, 8 * a_.numel(), FP32_OPS, None, err,
               ("ssm_train", "bf16:selective_scan_bwd"),
               device_ms=device_ms(call, 10),
               note=f"{'x'.join(map(str, shape))} bf16, a and b read "
                    f"twice, fp32 checkpoints in their own "
                    f"{4 * a_.numel() // 8 / 1e9:.3f} GB buffer; peak "
                    f"memory of a call {peak / 1e9:.3f} GB beside "
                    f"{2 * a_.numel() / 1e9:.3f} GB for each of a, b, da "
                    f"and db")
        del a_, b_, c_, h0, dy, dh, got


def encdec_kernel_rows(i8, f32, sms: int) -> None:
    """The enc-dec phase's K4 and K5 shapes (seamless-m4t-large-v2: d
    1024, 16 heads of 64 on 16 KV heads): K4 kind "layer" at the training
    step's 4096 rows and a 4-lane decode step's 4 rows, F.layer_norm
    beside; K5 non-causal at the encoder's 1 x 4096 over 4096 and the
    cross-attention's 1024 queries over 4096 frames, SDPA bf16 beside,
    each with the tiles it visits (all of them: no tile is masked)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    log("[kernels] enc-dec shapes: K4 layer at N 1024, K5 non-causal with "
        "16/16 heads of 64 (bitwise)")
    n = 1024
    gam, bet = 1.0 + 0.1 * f32(n), 0.1 * f32(n)
    for name, m, key in (("ubn_norm_layer_train", 4096,
                          "ubn_norm_layer_4096x1024"),
                         ("ubn_norm_layer_decode", 4,
                          "ubn_norm_layer_4x1024")):
        x = f32(m, n) * 2
        call = lambda: ops.ubn_norm(x, gam, bet, kind="layer")  # noqa: E731
        plain = lambda: ref.ubn_norm(x, gam, bet, kind="layer")  # noqa: E731
        lib = lambda: F.layer_norm(x, (n,), gam, bet, 2.0 ** -8)  # noqa
        assert torch.equal(call(), plain()), f"ubn_norm layer {m}x{n} differs"
        record(name, "src/repro_torch/csrc/ubn.cu",
               "src/repro/kernels/ubn.py:110", time_ms(call), time_ms(plain),
               8 * x.numel() + 8 * n, 8 * x.numel(), FP32_OPS, time_ms(lib),
               max_err(call(), plain()), ("encdec", key),
               device_ms=device_ms(call),
               note=f"{m}x{n} layer, {ops.ubn_cluster(m, sms)} block(s) a "
                    f"row; library F.layer_norm, device "
                    f"{device_ms(lib):.4f} ms")
    h, dh = 16, 64
    scs = [torch.tensor(v, device=dev) for v in (2.0 ** -6, 2.0 ** -7,
                                                  2.0 ** -7)]
    sdpa = F.scaled_dot_product_attention
    for name, s_, t in (("flash_attention_encoder", 4096, 4096),
                        ("flash_attention_cross", 1024, 4096)):
        q8, k8, v8 = i8(1, s_, h, dh), i8(1, t, h, dh), i8(1, t, h, dh)
        qp = torch.arange(s_, device=dev, dtype=torch.int32)
        kp = torch.arange(t, device=dev, dtype=torch.int32)
        args = (q8, k8, v8, qp, kp, torch.ones_like(kp), *scs)
        kw = dict(causal=False, sm_scale=dh ** -0.5, q_chunk=1024,
                  kv_chunk=512)
        got, want = ops.flash_attention(*args, **kw), \
            ref.flash_attention(*args, **kw)
        assert torch.equal(got, want), f"{name} differs"
        visits = torch.zeros(2, dtype=torch.int64, device=dev)
        ops.flash_attention(*args, **kw, visits=visits)
        tiles = h * (s_ // 128) * (t // 64)
        st_v, mn_v = visits.tolist()
        log(f"  {name} (1 x {s_} over {t}, non-causal): tiles visited "
            f"{st_v} / {tiles} (stats launch), {mn_v} / {tiles} (main)")
        assert st_v == mn_v == tiles, f"{name}: a non-causal tile skipped"
        qb, kb_, vb = ((x.float() * c).to(torch.bfloat16).transpose(1, 2)
                       for x, c in zip((q8, k8, v8), scs))
        record(name, "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/paged_attention.py:304",
               time_ms(lambda: ops.flash_attention(*args, **kw), 5),
               time_ms(lambda: ref.flash_attention(*args, **kw), 2),
               q8.numel() + k8.numel() + v8.numel() + 4 * got.numel(),
               2 * 2 * s_ * t * h * dh, INT8_OPS,
               time_ms(lambda: sdpa(qb, kb_, vb), 5), max_err(got, want),
               ("encdec", name),
               device_ms=device_ms(lambda: ops.flash_attention(*args, **kw),
                                   20),
               note=f"1 x {s_} over {t}, non-causal, 16/16 heads of 64, "
                    f"every tile visited; library SDPA bf16 non-causal")
        del q8, k8, v8, got, want


def hybrid_kernel_rows(i8) -> None:
    """K5 at zamba2-7b's head width 112 (dh padded to 128 bytes for q.k,
    p.v at 128 with the columns past 112 dropped): bitwise against the
    plain version at every dh from 16 to 128 on a small shape, then the
    rows at the hybrid phase's training shape (1 x 4096, causal, 32/32
    heads of 112) and its monolithic prefill of 100 tokens (one ragged kv
    chunk), SDPA bf16 beside each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    log("[kernels] K5 flash_attention at head widths 16 .. 128 and at "
        "zamba2-7b's 32/32 heads of 112 (bitwise)")
    scs = [torch.tensor(v, device=dev) for v in (2.0 ** -6, 2.0 ** -7,
                                                  2.0 ** -7)]
    pos = torch.arange(4096, device=dev, dtype=torch.int32)
    for dh in range(16, 129, 16):
        for causal in (True, False):
            ax = (i8(1, 256, 4, dh), i8(1, 256, 2, dh), i8(1, 256, 2, dh),
                  pos[:256], pos[:256], (pos[:256] < 230).to(torch.int32),
                  *scs)
            kw = dict(causal=causal, sm_scale=dh ** -0.5, q_chunk=128,
                      kv_chunk=64)
            assert torch.equal(ops.flash_attention(*ax, **kw),
                               ref.flash_attention(*ax, **kw)), \
                f"flash_attention dh {dh} causal={causal} differs"
    log("  bitwise at dh 16, 32, ..., 128, causal and not, 4 query on 2 KV "
        "heads, 26 padded keys")
    h, dh = 32, 112
    sdpa = F.scaled_dot_product_attention
    for name, t, key in (("flash_attention_dh112_train", 4096,
                          "flash_attention_train"),
                         ("flash_attention_dh112_prefill", 100,
                          "flash_attention_prefill")):
        qc, kc = min(1024, t), min(512, t)
        q8, k8, v8 = i8(1, t, h, dh), i8(1, t, h, dh), i8(1, t, h, dh)
        args = (q8, k8, v8, pos[:t], pos[:t], torch.ones_like(pos[:t]),
                *scs)
        kw = dict(causal=True, sm_scale=dh ** -0.5, q_chunk=qc, kv_chunk=kc)
        before = ops.LAUNCHES["flash_attention"]
        got = ops.flash_attention(*args, **kw)
        assert ops.LAUNCHES["flash_attention"] == before + 1, \
            f"{name}: K5 did not launch at dh 112"
        want = ref.flash_attention(*args, **kw)
        assert torch.equal(got, want), f"{name} differs"
        qb, kb_, vb = ((x.float() * c).to(torch.bfloat16).transpose(1, 2)
                       for x, c in zip((q8, k8, v8), scs))
        record(name, "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/paged_attention.py:304",
               time_ms(lambda: ops.flash_attention(*args, **kw), 5),
               time_ms(lambda: ref.flash_attention(*args, **kw), 2),
               3 * q8.numel() + 4 * got.numel(),
               2 * 2 * (t * (t + 1) // 2) * h * dh, INT8_OPS,
               time_ms(lambda: sdpa(qb, kb_, vb, is_causal=True), 5),
               max_err(got, want), ("hybrid", key),
               device_ms=device_ms(lambda: ops.flash_attention(*args, **kw),
                                   20),
               note=f"1 x {t}, causal, 32/32 heads of 112 (zamba2-7b's "
                    f"shared attention), kv_chunk {kc}; library SDPA bf16 "
                    f"causal")
        del q8, k8, v8, got, want


# ---------------------------------------------------------------------------
# phases 3 and 7: serve granite-3-8b and falcon-mamba-7b at full width,
# 4 layers
# ---------------------------------------------------------------------------

PROMPT_LENS = (100, 37, 256, 64)
SERVE_KERNELS = ("qmatmul", "quantize", "ubn_norm", "page_gather",
                 "paged_attention")
SSM_KERNELS = ("qmatmul", "quantize", "ubn_norm", "selective_scan")
NEW_TOKENS = 16
ENGINE_KW = dict(max_lanes=4, page_size=16, max_ctx=512,
                 prefill_mode="chunked")
# serve_mono: monolithic prefill (the engine's default), one more prompt of
# 1500 tokens, so the context grows to 2048
MONO_PROMPT_LENS = PROMPT_LENS + (1500,)
MONO_KW = dict(max_lanes=4, page_size=16, max_ctx=2048)
MONO_KERNELS = ("qmatmul", "quantize", "ubn_norm", "flash_attention",
                "paged_attention")


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p, NEW_TOKENS)
    out = engine.drain()
    return [out[i] for i in range(len(prompts))]


def describe(model, depth: int) -> str:
    a = model.a
    if a.family == "ssm":
        widths = (f"d_model {a.d_model}, d_inner {a.d_inner}, ssm_state "
                  f"{a.ssm_state}, d_conv {a.d_conv}, dt rank "
                  f"{max(a.d_model // 16, 1)}")
    elif a.family == "hybrid":
        widths = (f"d_model {a.d_model}, d_inner {a.d_inner} "
                  f"({a.d_inner // a.headdim} SSD heads of {a.headdim}), "
                  f"ssm_state {a.ssm_state}, d_conv {a.d_conv}; a shared "
                  f"block after every {a.attn_every} layers: heads "
                  f"{a.n_heads}/{a.n_kv} x {a.dh}, ffn {a.d_ff}")
    else:
        widths = (f"d={a.d_model}, heads {a.n_heads}/{a.n_kv} x {a.dh}, "
                  f"ffn {a.d_ff}")
    return (f"{a.name} at full width ({widths}, vocab {a.vocab} -> "
            f"{a.vocab_padded}), depth cut to {a.n_layers} of {depth} "
            f"layers, {model.n_params() / 1e9:.3f} G fp32 params, random "
            f"weights (seed 0)")


def first_logits(model, prompt):
    """The last-token logits of one prefill page of `prompt` from an empty
    cache (a fresh pool, or the zero dense slot)."""
    import torch
    from repro_torch.serving.pool import PagePool
    a = model.a
    tok = torch.as_tensor(prompt[:16], device="cuda")
    spec, view = model.decode_state_spec(), None
    if spec["kv_layers"]:
        pool = PagePool(40, 16, spec["kv_layers"], a.n_kv, a.dh,
                        device="cuda")
        view = pool.view(torch.arange(1, 33, device="cuda",
                                      dtype=torch.int32)[None])
    return model.prefill_page(model.init_slots(1), view, tok,
                              0)[0][0, :a.vocab]


def count_decode(eng) -> dict:
    """Launch counts inside `eng`'s decode steps: counted around its decode
    call, into the returned dict."""
    from repro_torch.kernels import ops
    counts = dict.fromkeys(ops.LAUNCHES, 0)
    inner = eng._decode

    def counted():
        before = dict(ops.LAUNCHES)
        res = inner()
        for k in counts:
            counts[k] += ops.LAUNCHES[k] - before[k]
        return res

    eng._decode = counted
    return counts


def kernels_vs_plain(tag: str, what: str, model, kw: dict, prompts,
                     kernels=(), toks=None) -> list:
    """The same requests through `Engine(model, **kw)` on the kernels
    (unless their tokens `toks` are given, from a run whose launches were
    checked) and through the plain versions on the card: every kernel of
    `kernels` launched in the kernels' run, none in the plain run, and
    equal tokens.  Returns the kernels' tokens."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    if toks is None:
        before = dict(ops.LAUNCHES)
        toks = _serve(Engine(model, **kw), prompts)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in ops.LAUNCHES.items()
               if v > before[k]}
        log(f"[{tag}] {what}: kernel launches in the kernels' run {ran}")
        for k in kernels:
            assert ran.get(k, 0) > 0, f"{what}: kernel {k} was never " \
                f"launched in the kernels' run"
    before = dict(ops.LAUNCHES)
    t0 = time.time()
    with ops.plain_reference():
        ptoks = _serve(Engine(model, **kw), prompts)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before, "the plain run launched a kernel"
    eq = np.mean([x == y for t, u in zip(toks, ptoks) for x, y in zip(t, u)])
    log(f"[{tag}] {what}: plain versions on the card {time.time() - t0:.1f} "
        f"s; equal tokens {eq:.3f}")
    assert eq == 1.0, f"{what}: the kernels' tokens differ from the plain " \
        f"versions'"
    return toks


def phase_engine(tag: str, arch: str, depth: int, kernels) -> dict:
    """Serve PROMPT_LENS through `make_engine(arch, reduced=False,
    n_layers=4)`, check the kernels' launches, then the same requests and
    the first-step logits through the plain versions; profile the decode
    step.  Returns the run's launches per op ("<op>_decode" for the
    launches inside decode steps)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, make_engine
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine(arch, reduced=False, n_layers=4, device="cuda", seed=0,
                      **ENGINE_KW)
    model = eng.model
    a = model.a
    log(f"[{tag}] {describe(model, depth)}; engine {ENGINE_KW}; built in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]

    decode_counts = count_decode(eng)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    toks = _serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    met = eng.metrics()
    log(f"[{tag}] {len(prompts)} requests, prompts {PROMPT_LENS}, "
        f"{NEW_TOKENS} new tokens each: wall {wall:.3f} s, prefill "
        f"{met['prefill_wall_s']:.3f} s ({met['prefill_tokens']} tokens), "
        f"decode {met['decode_wall_s']:.3f} s over {met['decode_steps']} "
        f"steps ({1e3 * met['decode_wall_s'] / max(met['decode_steps'], 1):.2f}"
        f" ms/step, {met['decode_tok_s']:.1f} tok/s), TTFT mean "
        f"{1e3 * met['ttft_mean_s']:.1f} ms, TPOT mean "
        f"{1e3 * met['tpot_mean_s']:.2f} ms, preemptions "
        f"{met['preemptions']}")
    log(f"[{tag}] kernel launches in the run: {launches}")
    per_step = {k: v / max(met["decode_steps"], 1)
                for k, v in decode_counts.items()}
    log(f"[{tag}] kernel launches per decode step: {per_step}")
    # the decode step's weight traffic as ported: every hidden weight is
    # re-quantized each forward (fp32 master read, int8 payload written by
    # K2 and read by K1: 6 bytes); the norm gains and the SSM's per-channel
    # vectors are read in fp32, and so is the exempt lm_head
    labels = model.labels()["layers"]
    step_bytes = 4 * model.lm_head.numel() + sum(
        (6 if labels[k] == "w" else 4) * p.numel()
        for k, p in model.layers.items())
    log(f"[{tag}] decode-step weight traffic {step_bytes / 1e9:.3f} GB -> "
        f"bound {1e3 * step_bytes / HBM_BPS:.3f} ms/step at 3.35 TB/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    for k in kernels:
        assert launches[k] > 0, f"kernel {k} was never launched on the " \
            f"{tag} path"
    for t in toks:
        assert len(t) == NEW_TOKENS and all(0 <= x < a.vocab for x in t)

    # the same requests through the plain versions on the card
    t0 = time.time()
    with ops.plain_reference():
        plain = Engine(model, **ENGINE_KW)
        ptoks = _serve(plain, prompts)
    torch.cuda.synchronize()
    assert all(v == launches[k] for k, v in ops.LAUNCHES.items()), \
        "the plain run launched a kernel"
    eq = np.mean([x == y for t, u in zip(toks, ptoks) for x, y in zip(t, u)])
    first = np.mean([t[0] == u[0] for t, u in zip(toks, ptoks)])
    log(f"[{tag}] plain versions on the card: {time.time() - t0:.1f} s; "
        f"equal tokens {eq:.3f}, equal first tokens {first:.2f}")
    for t, u in zip(toks, ptoks):
        log(f"  kernels {t}\n  plain   {u}")

    lk = first_logits(model, prompts[0])
    with ops.plain_reference():
        lp = first_logits(model, prompts[0])
    dist = float((lk - lp).abs().max())
    rel = dist / float(lp.abs().max())
    log(f"[{tag}] first-step logits: max |kernel - plain| {dist:.3e} "
        f"({rel:.3e} of max |logit|), argmax {int(lk.argmax())} vs "
        f"{int(lp.argmax())}")
    assert bool(torch.isfinite(lk).all()), "non-finite logits"
    # every kernel equals its plain version bit for bit (phase 2), and the
    # rest of the path is the same PyTorch code in both runs, so the two
    # runs agree exactly: the same tokens and the same logits
    assert eq == 1.0, "the kernels' tokens differ from the plain versions'"
    assert dist == 0.0, "the kernels' logits differ from the plain versions'"
    profile_decode(eng)
    if eng.paged:
        profile_prefill(model, prompts[2])
    else:       # one 16-token page of a lane from the zero dense slot
        tok = torch.as_tensor(prompts[2][:16], device="cuda")
        slots = model.init_slots(1)
        model.prefill_page(slots, None, tok, 0)
        with_profile(lambda: model.prefill_page(slots, None, tok, 0),
                     "prefill page (16 tokens, zero slot)",
                     {"K9 (sscan_*)": "sscan_"})
    if not eng.paged:   # the dense family's monolithic admission (K9 over
        # each whole prompt in train mode) against the plain versions
        kernels_vs_plain(tag, "monolithic prefill", model,
                         dict(ENGINE_KW, prefill_mode="monolithic"), prompts,
                         kernels)
    for k, v in decode_counts.items():
        launches[f"{k}_decode"] = v
    return launches


def phase_serve() -> dict:
    """The serve run's K1 launches split into decode steps and prefill
    (pages and prompt tails), then a profiled prefill page."""
    launches = phase_engine("serve", "granite-3-8b", 40, SERVE_KERNELS)
    launches["qmatmul_prefill"] = launches["qmatmul"] \
        - launches["qmatmul_decode"]
    return launches


def phase_serve_mono() -> dict:
    """granite-3-8b at full width, 4 layers, on the engine's default
    monolithic prefill: greedy, sampled, chunked with the radix cache, the
    unfused decode route and a defrag, each held against the plain
    versions or against the run it must equal.  Returns the greedy run's
    launches, plus "page_gather_unfused_decode" (K7 one-pool launches in
    the unfused run's decode steps)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, make_engine, shared_prefix_traffic
    tag = "serve_mono"
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine("granite-3-8b", reduced=False, n_layers=4,
                      device="cuda", seed=0, **MONO_KW)
    model, a = eng.model, eng.model.a
    log(f"[{tag}] {describe(model, 40)}; engine {MONO_KW} (monolithic "
        f"prefill, the default), pool {eng.pool.report()['pool_bytes_int8']}"
        f" B; built in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
               for n in MONO_PROMPT_LENS]

    # (1) greedy: the main path's run, counted
    decode_counts = count_decode(eng)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    toks = _serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    met = eng.metrics()
    log(f"[{tag}] greedy: {len(prompts)} requests, prompts "
        f"{MONO_PROMPT_LENS}, {NEW_TOKENS} new tokens each: wall {wall:.3f}"
        f" s, prefill {met['prefill_wall_s']:.3f} s ({met['prefill_tokens']}"
        f" tokens), decode {met['decode_wall_s']:.3f} s over "
        f"{met['decode_steps']} steps, TTFT mean "
        f"{1e3 * met['ttft_mean_s']:.1f} ms (max "
        f"{1e3 * met['ttft_max_s']:.1f}), TPOT mean "
        f"{1e3 * met['tpot_mean_s']:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[{tag}] kernel launches in the run: {launches}")
    log(f"[{tag}] kernel launches in decode steps: {decode_counts}")
    for k in MONO_KERNELS:
        assert launches[k] > 0, f"kernel {k} was never launched on the " \
            f"{tag} path"
    assert decode_counts["page_gather"] == 0, "fused decode gathered pages"
    for t in toks:
        assert len(t) == NEW_TOKENS and all(0 <= x < a.vocab for x in t)
    kernels_vs_plain(tag, "greedy", model, MONO_KW, prompts, toks=toks)
    for p in (prompts[0], prompts[4]):     # a ragged chunk; 2 x 3 chunks
        tok = torch.as_tensor(p[None], device="cuda")
        lk = model.prefill(tok, len(p) + 16)[1][0, :a.vocab]
        with ops.plain_reference():
            lp = model.prefill(tok, len(p) + 16)[1][0, :a.vocab]
        dist = float((lk - lp).abs().max())
        log(f"[{tag}] first logits of a {len(p)}-token prompt: max |kernel "
            f"- plain| {dist:.3e}, argmax {int(lk.argmax())} vs "
            f"{int(lp.argmax())}")
        assert bool(torch.isfinite(lk).all()), "non-finite logits"
        assert dist == 0.0, "monolithic prefill logits differ"

    # (2) temperature 0.7, top-k 50
    skw = dict(MONO_KW, temperature=0.7, top_k=50)
    stoks = kernels_vs_plain(tag, "sampled (temperature 0.7, top-k 50)",
                             model, skw, prompts, MONO_KERNELS)
    log(f"[{tag}] sampled tokens differing from greedy: "
        f"{np.mean([x != y for t, u in zip(stoks, toks) for x, y in zip(t, u)]):.3f}")

    # (3) chunked prefill with the radix cache on shared-prefix traffic,
    # one lane, one request at a time (the same batches with and without
    # the cache), against the same requests without it
    rkw = dict(max_lanes=1, page_size=16, max_ctx=2048,
               prefill_mode="chunked")
    traffic = shared_prefix_traffic(rate=1.0, n_requests=6, sharing=0.75,
                                    prefix_len=64, n_prefixes=2,
                                    tail_lens=(7, 20), gen_lens=(8,),
                                    vocab=a.vocab, seed=0)

    def sequential(e):
        out = []
        for r in traffic:
            rid = e.submit(r["prompt"], r["max_new"])
            out.append(e.drain()[rid])
        return out

    on = Engine(model, radix_cache=True, **rkw)
    t0 = time.time()
    r_on = sequential(on)
    rm = on.metrics()
    r_off = sequential(Engine(model, **rkw))
    eq = np.mean([x == y for t, u in zip(r_on, r_off) for x, y in zip(t, u)])
    log(f"[{tag}] radix cache, {len(traffic)} shared-prefix requests "
        f"(prefix 64 of {[len(r['prompt']) for r in traffic]} tokens): hit "
        f"rate {rm['prefix_hit_rate']:.3f} ({rm['radix']}); equal tokens to "
        f"the run without the cache {eq:.3f} ({time.time() - t0:.1f} s)")
    assert rm["prefix_hit_rate"] > 0, "the radix cache served no page"
    assert eq == 1.0, "the radix cache changed the tokens"

    # (4) the unfused decode route (K7 gather + decode_attention on K1)
    fused_q = model.q
    model.q = fused_q.replace(fuse_kernels=False)
    try:
        ue = Engine(model, **MONO_KW)
        udec = count_decode(ue)
        utoks = _serve(ue, prompts)
    finally:
        model.q = fused_q
    log(f"[{tag}] fuse_kernels=False: decode-step launches page_gather "
        f"{udec['page_gather']}, paged_attention {udec['paged_attention']},"
        f" qmatmul {udec['qmatmul']}; equal tokens to the fused run "
        f"{float(utoks == toks):.3f}")
    assert udec["page_gather"] > 0 and udec["paged_attention"] == 0, \
        "the unfused decode route did not gather or ran the fused kernel"
    assert utoks == toks, "the unfused decode route changed the tokens"
    launches["page_gather_unfused_decode"] = udec["page_gather"]

    # (5) defrag between steps: the 37-token request stops after 4 tokens,
    # leaving its low pages free under the others', then the pool compacts
    news = [NEW_TOKENS, 4, NEW_TOKENS, NEW_TOKENS, NEW_TOKENS]
    outs, moves = [], 0
    for with_defrag in (True, False):
        de = Engine(model, **MONO_KW)
        rids = [de.submit(p, n) for p, n in zip(prompts, news)]
        for _ in range(3):
            de.step()
        if with_defrag:
            moves = de.defrag()
        res = de.drain()
        outs.append([res[r] for r in rids])
    log(f"[{tag}] defrag after step 3: {moves} pages moved; equal tokens to "
        f"the run without it {float(outs[0] == outs[1]):.3f}")
    assert moves > 0, "defrag moved no page"
    assert outs[0] == outs[1], "defrag changed the tokens"
    for k, v in decode_counts.items():
        launches[f"{k}_decode"] = v
    return launches


def phase_ssm() -> dict:
    """The SSM run's selective_scan row counts the launches outside decode
    steps (prefill pages and prompt-tail tokens), the _decode row those
    inside them."""
    launches = phase_engine("ssm", "falcon-mamba-7b", 64, SSM_KERNELS)
    launches["selective_scan"] -= launches["selective_scan_decode"]
    return launches


def profile_decode(eng, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over `steps` decode
    steps of all lanes (dead: a paged family's tables point at the trash
    page, so the attention is short and the weight traffic is the full
    step's; a dense family's slots are zero).  Prints device time by
    kernel name and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lanes = eng.max_lanes
    z = torch.zeros((lanes,), dtype=torch.int32, device="cuda")
    view = eng.pool.view(torch.zeros((lanes, eng.n_blocks), dtype=torch.int32,
                                     device="cuda")) if eng.paged else None
    slots = dict(eng.model.init_slots(lanes), pos=z)

    def step():
        eng.model.paged_decode_step(slots, view, z)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    groups = {"K4 rows (ubn_rows)": "ubn_rows"}
    if eng.paged:
        groups["K6 (pa_scores, pa_exp, pa_out)"] = "pa_"
    if eng.dense and eng.model.a.ssm_kind == "mamba1":
        groups["K9 (sscan_*)"] = "sscan_"
    report_profile(prof, wall_us, steps, "decode step", groups)


def profile_prefill(model, prompt) -> None:
    """One 16-token prefill page of one lane whose table holds 32 pages,
    under the profiler: K7 launches (one a layer: K and V in one call),
    aten::copy_ events inside the page's integer contractions (none: their
    operands reach K1 as views), and the page's device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serving.pool import PagePool
    a, kvl = model.a, model.decode_state_spec()["kv_layers"]
    pool = PagePool(40, 16, kvl, a.n_kv, a.dh, device="cuda")
    view = pool.view(torch.arange(1, 33, device="cuda",
                                  dtype=torch.int32)[None])
    tok = torch.as_tensor(prompt[:16], device="cuda")
    dense = model.init_slots(1)
    model.prefill_page(dense, view, tok, 0)
    torch.cuda.synchronize()
    before, counts = dict(ops.LAUNCHES), {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            k1_by_contraction(counts, ranges=True):
        t0 = time.time()
        model.prefill_page(dense, view, tok, 0)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    gathers = ops.LAUNCHES["page_gather"] - before["page_gather"]
    copies = inside = 0
    for e in prof.events():
        if e.name != "aten::copy_":
            continue
        copies += 1
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("K1 "):
            parent = parent.cpu_parent
        inside += parent is not None
    log(f"[profile] prefill page (16 tokens, 32 pages a lane): page_gather "
        f"launches {gathers} ({kvl} attention layers), K1 launches by "
        f"contraction {counts}; aten::copy_ inside the contractions "
        f"{inside} (of {copies} in the page)")
    report_profile(prof, wall_us, 1, "prefill page",
                   {"K1 (qmm_*)": "qmm_", "K7 (page_gather*)": "page_gather"})
    assert gathers == kvl, "prefill page: not one K7 launch a layer"
    assert inside == 0, "prefill page: an operand of a contraction was copied"


# ---------------------------------------------------------------------------
# phase 4: train granite-3-8b at full width, 4 layers
# ---------------------------------------------------------------------------

TRAIN_SEQ = 4096          # the reference's train_4k sequence length
TRAIN_STEPS = 3
TRAIN_KERNELS = ("qmatmul", "quantize", "ubn_norm", "dgrad", "wgrad",
                 "flash_attention")


def _host_copy(tree) -> list:
    from repro_torch.optim import flatten
    return [t.detach().to("cpu", copy=True) for t in flatten(tree)]


def plain_step_equal(tag: str, model, step, batch, init_params, after1,
                     loss1: float) -> None:
    """Step 1 again from `init_params` (None: the model as built, from the
    kernel run's seed) and a fresh optimizer state through the plain
    versions on the card: its loss, every parameter leaf and every
    accumulator leaf must equal the kernel run's (`loss1`, `after1`) bit
    for bit."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim import flatten, init_momentum
    with torch.no_grad():
        for p, h in zip(flatten(model.params()), init_params or []):
            p.copy_(h)
    opt = init_momentum(model.params())
    before = dict(ops.LAUNCHES)
    t0 = time.time()
    with ops.plain_reference():
        ploss = float(step(opt, batch, 0)["loss"])
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == before, "the plain run launched a kernel"
    same_p = [torch.equal(p.detach().cpu(), h)
              for p, h in zip(flatten(model.params()), after1[0])]
    same_a = [torch.equal(x.cpu(), h)
              for x, h in zip(flatten(opt.acc), after1[1])]
    log(f"[{tag}] step 1 through the plain versions: {time.time() - t0:.1f}"
        f" s, loss {ploss:.6f} vs {loss1:.6f}; parameters equal "
        f"{sum(same_p)}/{len(same_p)}, accumulator equal "
        f"{sum(same_a)}/{len(same_a)}")
    assert ploss == loss1, f"{tag}: plain step-1 loss differs"
    assert all(same_p), f"{tag}: plain step-1 parameters differ"
    assert all(same_a), f"{tag}: plain step-1 accumulator differs"


def phase_train() -> dict:
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    t0 = time.time()
    cfg = preset("full8")
    model = build_model(get("granite-3-8b").replace(n_layers=4), cfg,
                        device="cuda").init(0)
    a = model.a
    task = TokenTask(a.vocab, TRAIN_SEQ, 1, kind="arith")
    log(f"[train] granite-3-8b at full width, {a.n_layers} of 40 layers, "
        f"{model.n_params() / 1e9:.2f} G fp32 params, full8 native, batch "
        f"1 x {TRAIN_SEQ} tokens (TokenTask arith), q_chunk {a.q_chunk}, "
        f"kv_chunk {a.kv_chunk}; built in {time.time() - t0:.1f} s")

    def profiled(run):
        # where a training step's time goes: device time by kernel name
        # and the busy share of the wall; K1's split by contraction
        with k1_by_contraction({}, ranges=True):
            prof = with_profile(run, "train step",
                                {"K1 (qmm_*)": "qmm_", "K3 (bwd_*)": "bwd_",
                                 "K5 (fa_*)": "fa_"})
        k1_split(prof, "train step")

    total = train_steps("train", model, cfg,
                        [task.batch(i) for i in range(TRAIN_STEPS + 1)],
                        TRAIN_KERNELS, k1_by_contraction, profiled,
                        keep=True)
    log(f"[train] K1 launches in {TRAIN_STEPS} steps by contraction: "
        f"{ {k: v for k, v in total.items() if k.startswith('qmatmul_')} }")
    del model
    torch.cuda.empty_cache()
    remat_check(cfg, task.batch(0))
    return total


def remat_check(cfg, batch) -> None:
    """Step 1 of the train phase's model again with remat "none" (every
    layer's activations kept for the backward): its loss, weights and
    accumulator must equal the remat "full" run's bit for bit; both
    peaks printed."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import build_model
    tag = "train_remat_none"
    model = build_model(get("granite-3-8b").replace(n_layers=4,
                                                    remat="none"),
                        cfg, device="cuda").init(0)
    train_steps(tag, model, cfg, [batch], TRAIN_KERNELS, plain=False,
                keep=True)
    full, none = RUNS["train"], RUNS[tag]
    same_p = [torch.equal(x, y) for x, y in zip(full["after1"],
                                                 none["after1"])]
    same_a = [torch.equal(x, y) for x, y in zip(full["after1_acc"],
                                                 none["after1_acc"])]
    log(f"[train] remat: step 1 with remat none, loss "
        f"{none['losses'][0]:.6f} vs {full['losses'][0]:.6f}; parameters "
        f"equal {sum(same_p)}/{len(same_p)}, accumulator equal "
        f"{sum(same_a)}/{len(same_a)}; peak device memory "
        f"{none['peak'] / 1e9:.2f} GB (none) vs {full['peak'] / 1e9:.2f} GB "
        f"(full) over {none['base'] / 1e9:.2f} and "
        f"{full['base'] / 1e9:.2f} GB resident before the runs (the model "
        f"included), step {none['walls'][0]:.3f} s vs "
        f"{min(full['walls']):.3f}-{max(full['walls']):.3f} s")
    assert none["losses"][0] == full["losses"][0], "remat: loss differs"
    assert all(same_p) and all(same_a), "remat: step 1 differs"
    for run in (full, none):
        del run["after1"], run["after1_acc"]
    del model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def step_parts(model, parts: list):
    """Time a make_train_step call by its parts while inside: the forward
    (model.loss), the backward (up to momentum_update) and the optimizer
    (momentum_update: CQ noise, gradient quantization and the Momentum
    update), each ended by a synchronise, appended to `parts` as
    (forward, backward, optimizer) seconds once the step returns."""
    import torch
    from repro_torch.launch import train as ttrain
    real_loss, real_update = model.loss, ttrain.momentum_update
    marks = []

    def loss(batch):
        torch.cuda.synchronize()
        marks[:] = [time.time()]
        out = real_loss(batch)
        torch.cuda.synchronize()
        marks.append(time.time())
        return out

    def update(*args, **kw):
        torch.cuda.synchronize()
        marks.append(time.time())
        real_update(*args, **kw)
        torch.cuda.synchronize()
        marks.append(time.time())
        parts.append(tuple(b - a for a, b in zip(marks, marks[1:])))

    model.loss, ttrain.momentum_update = loss, update
    try:
        yield parts
    finally:
        del model.loss
        ttrain.momentum_update = real_update


def train_steps(tag: str, model, cfg, batches, kernels, count=None,
                profiled=None, plain: bool = True,
                keep: bool = False) -> dict:
    """make_train_step over `batches` (step i on batches[i]): per step its
    metrics, wall, peak memory, forward / backward / optimizer split and
    launches, every kernel of `kernels` launched in every step; then step
    1 through the plain versions (plain_step_equal) unless `plain` is
    False.  `count(counts)`, a context manager, counts further launches
    into the dict it is given in each step (k1_by_contraction,
    bn_by_shape).  With `profiled`, the last batch is not a timed step:
    `profiled(run)` is handed one more step on it.  Returns the launches
    summed over the timed steps; RUNS[tag] keeps the losses, walls and
    peak memory, and with `keep` the parameters ("after1") and the
    accumulator ("after1_acc") after step 1 on the host, for a comparison
    across runs whose caller then drops them (the host holds 96 GiB)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    import gc

    from repro_torch.optim import init_momentum
    gc.collect()            # earlier phases' garbage off the card's peak
    torch.cuda.empty_cache()
    init_params = _host_copy(model.params()) if plain else None
    opt = init_momentum(model.params())
    step = make_train_step(model, cfg, lr=0.05)
    timed = batches[:-1] if profiled else batches
    total = dict.fromkeys(ops.LAUNCHES, 0)
    after1, loss1, parts, peak = None, None, [], 0
    run = RUNS[tag] = {"losses": [], "walls": [],
                       "base": torch.cuda.memory_allocated()}
    first = next(iter(batches[0].values()))
    unit = ("tokens", first.size) if "tokens" in batches[0] \
        else ("images", first.shape[0])
    for i, batch in enumerate(timed):
        more: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.time()
        with step_parts(model, parts), \
                (count(more) if count else contextlib.nullcontext()):
            met = step(opt, batch, i)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(ops.LAUNCHES, **more)
        for k in counts:
            total[k] = total.get(k, 0) + counts[k]
        met = {k: float(v) for k, v in met.items()}
        run["losses"].append(met["loss"])
        run["walls"].append(wall)
        fwd, bwd, upd = parts[-1]
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"[{tag}] step {i + 1}: "
            + ", ".join(f"{k} {v:.6f}" for k, v in met.items())
            + f", wall {wall:.3f} s (forward {fwd:.3f}, backward {bwd:.3f}, "
            f"optimizer {upd:.3f}), {unit[1] / wall:.1f} {unit[0]}/s, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB; launches { {k: v for k, v in counts.items() if v} }")
        assert math.isfinite(met["loss"]), f"{tag}: non-finite loss"
        for k in kernels:
            assert counts[k] > 0, f"{tag}: kernel {k} not launched in step " \
                f"{i + 1}"
        if i == 0:
            after1 = (_host_copy(model.params()), _host_copy(opt.acc))
            loss1 = met["loss"]
    PEAK[tag] = run["peak"] = peak
    if keep:
        run["after1"], run["after1_acc"] = after1
    if profiled:
        profiled(lambda: step(opt, batches[-1], len(timed)))
    if plain:
        plain_step_equal(tag, model, step, batches[0], init_params, after1,
                         loss1)
    return total


# ---------------------------------------------------------------------------
# phases 8 and 9: train falcon-mamba-7b at full width, 4 layers; the four
# other dense LMs at full width, 2 layers
# ---------------------------------------------------------------------------

SSM_TRAIN_STEPS = 3
SSM_TRAIN_KERNELS = ("qmatmul", "quantize", "ubn_norm", "dgrad", "wgrad",
                     "selective_scan", "selective_scan_bwd")
DENSE = (("granite-34b", 88), ("phi4-mini-3.8b", 32), ("minitron-4b", 32),
         ("chameleon-34b", 48))
DENSE_PROMPT_LENS = (37, 100)
DENSE_NEW = 8
DENSE_KW = dict(max_lanes=2, page_size=16, max_ctx=128)
DENSE_KERNELS = ("qmatmul", "quantize", "ubn_norm", "flash_attention",
                 "paged_attention")


def phase_ssm_train() -> dict:
    """falcon-mamba-7b at full width, 4 of 64 layers: 3 steps of
    make_train_step on one 1 x 4096 sequence, a profiled step, then step 1
    through the plain versions.  Returns the launches of the 3 steps."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    tag = "ssm_train"
    t0 = time.time()
    cfg = preset("full8")
    model = build_model(get("falcon-mamba-7b").replace(n_layers=4), cfg,
                        device="cuda").init(0)
    task = TokenTask(model.a.vocab, TRAIN_SEQ, 1, kind="arith")
    log(f"[{tag}] {describe(model, 64)}, full8 native, batch 1 x "
        f"{TRAIN_SEQ} tokens (TokenTask arith); built in "
        f"{time.time() - t0:.1f} s")
    # where a step's time goes: device time by kernel name, K9's and K9b's
    batches = [task.batch(i) for i in range(SSM_TRAIN_STEPS + 1)]
    total = train_steps(
        tag, model, cfg, batches,
        SSM_TRAIN_KERNELS, profiled=lambda run: with_profile(
            run, "ssm train step",
            {"K9 (sscan_staged)": "sscan_staged",
             "K9b (sscan_bwd*)": "sscan_bwd",
             "K1 (qmm_*)": "qmm_", "K3 (bwd_*)": "bwd_"}))
    del model
    torch.cuda.empty_cache()
    # the same model and batches on bf16 scan carriers (scan_dtype "bf16":
    # K9 and K9b on bf16 a, b, c), step 1 against the plain replay
    t0 = time.time()
    bcfg = cfg.replace(scan_dtype="bf16")
    model = build_model(get("falcon-mamba-7b").replace(n_layers=4), bcfg,
                        device="cuda").init(0)
    log(f"[{tag}_bf16] the same model with scan_dtype bf16; built in "
        f"{time.time() - t0:.1f} s")
    bf16 = train_steps(f"{tag}_bf16", model, bcfg,
                       batches[:SSM_TRAIN_STEPS], SSM_TRAIN_KERNELS)
    f32r, bfr = RUNS[tag], RUNS[f"{tag}_bf16"]
    log(f"[{tag}_bf16] steps {[round(w, 3) for w in bfr['walls']]} s, peak "
        f"{bfr['peak'] / 1e9:.2f} GB; fp32 carriers: steps "
        f"{[round(w, 3) for w in f32r['walls']]} s, peak "
        f"{f32r['peak'] / 1e9:.2f} GB; losses "
        f"{[round(x, 6) for x in bfr['losses']]} vs "
        f"{[round(x, 6) for x in f32r['losses']]}")
    del model
    torch.cuda.empty_cache()
    total.update({f"bf16:{k}": v for k, v in bf16.items()})
    return total


def phase_dense() -> dict:
    """The four dense LMs the reference registers beside granite-3-8b, at
    full width and 2 layers: greedy serving on monolithic prefill against
    the plain versions, then one granite-34b training step against the
    plain run's.  Returns the launches of the serving runs and the step,
    summed."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import make_engine
    tag = "dense"
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for name, depth in DENSE:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        eng = make_engine(name, reduced=False, n_layers=2, device="cuda",
                          seed=0, **DENSE_KW)
        model, a = eng.model, eng.model.a
        log(f"[{tag}] {describe(model, depth)}; engine {DENSE_KW} "
            f"(monolithic prefill); built in {time.time() - t0:.1f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
                   for n in DENSE_PROMPT_LENS]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.time()
        for p in prompts:
            eng.submit(p, DENSE_NEW)
        out = eng.drain()
        toks = [out[i] for i in range(len(prompts))]
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(ops.LAUNCHES)
        for k in counts:
            total[k] += counts[k]
        met = eng.metrics()
        log(f"[{tag}] {name}: 2 requests, prompts {DENSE_PROMPT_LENS}, "
            f"{DENSE_NEW} new tokens each: wall {wall:.3f} s, TTFT mean "
            f"{1e3 * met['ttft_mean_s']:.1f} ms, decode "
            f"{1e3 * met['decode_wall_s'] / max(met['decode_steps'], 1):.2f}"
            f" ms/step; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        for k in DENSE_KERNELS:
            assert counts[k] > 0, f"{name}: kernel {k} was never launched"
        for t in toks:
            assert len(t) == DENSE_NEW and all(0 <= x < a.vocab for x in t)
        kernels_vs_plain(tag, f"{name} greedy",
                         model, DENSE_KW, prompts, toks=toks)
        for p in prompts:
            tok = torch.as_tensor(p[None], device="cuda")
            lk = model.prefill(tok, len(p) + DENSE_NEW)[1][0, :a.vocab]
            with ops.plain_reference():
                lp = model.prefill(tok, len(p) + DENSE_NEW)[1][0, :a.vocab]
            dist = float((lk - lp).abs().max())
            log(f"[{tag}] {name}: first logits of a {len(p)}-token prompt: "
                f"max |kernel - plain| {dist:.3e}, argmax {int(lk.argmax())}"
                f" vs {int(lp.argmax())}")
            assert bool(torch.isfinite(lk).all()), "non-finite logits"
            assert dist == 0.0, f"{name}: first logits differ"
        del eng, model
        torch.cuda.empty_cache()

    # one training step of granite-34b: MQA (48 query heads on 1 KV head)
    # through K5 and the attention's backward, K3 at 6144 <-> 24576
    t0 = time.time()
    cfg = preset("full8")
    model = build_model(get("granite-34b").replace(n_layers=2), cfg,
                        device="cuda").init(0)
    log(f"[{tag}] train: {describe(model, 88)}, full8 native, batch 1 x "
        f"{TRAIN_SEQ} tokens (TokenTask arith); built in "
        f"{time.time() - t0:.1f} s")
    batch = TokenTask(model.a.vocab, TRAIN_SEQ, 1, kind="arith").batch(0)
    counts = train_steps(f"{tag} granite-34b train", model, cfg, [batch],
                         TRAIN_KERNELS)
    for k in counts:
        total[k] += counts[k]
    del model
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 10: the MoE LMs at full width
# ---------------------------------------------------------------------------

# (name, short name, published depth, the depth served and trained):
# granite-moe at 6 of 24 layers (its full depth took some 180 s of the
# whole run on a slow host; 12 layers until the full_depth phase came);
# moonshot at 2 of 48 layers (0.57 G parameters a layer: its 28 G at full
# depth do not fit one card in fp32, let alone with the step's gradient
# and accumulator)
MOE = (("granite-moe-1b-a400m", "granite", 24, 6),
       ("moonshot-v1-16b-a3b", "moonshot", 48, 2))
MOE_PROMPT_LENS = (37, 100)
MOE_NEW = 8
MOE_KW = dict(max_lanes=4, page_size=16, max_ctx=128)
MOE_CHUNK_KERNELS = ("qmatmul", "quantize", "ubn_norm", "page_gather",
                     "paged_attention")
# the MoE glue's profiler ranges: the router (its product, sort and
# softmax), the routing (slots, inverse map) and the two autograd
# Functions, forward and backward
MOE_RANGES = {"router": "MoE router", "route": "MoE route",
              "_Dispatch": "MoE dispatch", "_Combine": "MoE combine"}


@contextlib.contextmanager
def moe_ranges():
    """Run the MoE glue in profiler ranges (MOE_RANGES) while inside."""
    from torch.profiler import record_function
    from repro_torch.models import moe as M
    undo = []

    def ranged(fn, label):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    for name, label in MOE_RANGES.items():
        obj = getattr(M, name)
        if isinstance(obj, type):           # forward and backward
            for meth in ("forward", "backward"):
                real = obj.__dict__[meth]
                setattr(obj, meth, staticmethod(ranged(real.__func__,
                                                       label)))
                undo.append((obj, meth, real))
        else:
            setattr(M, name, ranged(obj, label))
            undo.append((M, name, obj))
    try:
        yield
    finally:
        for owner, name, real in reversed(undo):
            setattr(owner, name, real)


def moe_profile(run, what: str) -> None:
    """torch.profiler over one call of `run` (a step) with K1's
    contractions and the MoE glue in ranges: the card's busy share, the
    kernels that took the most time, K1's, K3's and K5's time, and the
    device ms by range."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with k1_by_contraction({}, ranges=True), moe_ranges(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = device_events(prof)
    kernels = [e for e in events if not e[0].startswith(SPANS)]
    busy = sum(d for _, _, d in kernels) / 1e6
    if not kernels:
        log(f"[profile] {what}: the profiler saw no device time: not "
            f"measured")
        return
    log(f"[profile] {what} (profiler on): wall {1e3 * wall:.3f} ms, device "
        f"busy {busy:.3f} ms, busy share {busy / 1e3 / wall:.3f}")
    by_name: dict = {}
    for name, _, d in kernels:
        n, ns = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, ns + d)
    for name, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {ns / 1e6:9.3f} ms  {n:5d} calls  {name[:70]}")
    for label, prefix in (("K1 (qmm_*)", "qmm_"), ("K3 (bwd_*)", "bwd_"),
                          ("K5 (fa_*)", "fa_")):
        sel = [(n, ns) for name, (n, ns) in by_name.items()
               if name.removeprefix("void ").startswith(prefix)]
        log(f"[profile] {what}: {label} {sum(ns for _, ns in sel) / 1e6:.3f}"
            f" ms in {sum(n for n, _ in sel)} launches")
    k1_split(prof, what)
    split = span_split(events, "MoE ")
    if not split:
        log(f"[profile] {what}: MoE ranges: not measured (no range on the "
            f"card's timeline)")
        return
    log(f"[profile] {what}: device ms by range (remat runs each layer's "
        f"forward ranges twice) "
        + ", ".join(f"{name.removeprefix('MoE ')} {ns / 1e6:.3f} ({k} "
                    f"kernels in {n} calls)"
                    for name, (n, k, ns) in sorted(split.items())))


@contextlib.contextmanager
def moe_drops(stats: dict):
    """Count the (token, choice) pairs routing keeps and drops while
    inside, into stats["pairs"] and stats["dropped"] (tensors)."""
    from repro_torch.models import moe as M
    real = M.route

    def spy(idx, gates, n_experts, cap):
        r = real(idx, gates, n_experts, cap)
        stats["pairs"] = stats.get("pairs", 0) + idx.numel()
        stats["dropped"] = stats.get("dropped", 0) \
            + (r["slot"] == n_experts * cap).sum()
        return r

    M.route = spy
    try:
        yield stats
    finally:
        M.route = real


def count_decode_k1(eng, counts: dict) -> None:
    """K1's launches inside `eng`'s decode steps by contraction, into
    `counts`."""
    inner = eng._decode

    def counted():
        with k1_by_contraction(counts):
            return inner()

    eng._decode = counted


def moe_serve(tag: str, name: str, short: str, full: int, depth: int,
              launches: dict) -> None:
    """Greedy requests through the MoE engine on monolithic prefill and on
    chunked prefill, each against the plain versions' run; launches into
    `launches` (model:run:contraction for K1's expert products)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import make_engine
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine(name, reduced=False, n_layers=depth, device="cuda",
                      seed=0, **MOE_KW)
    model, a = eng.model, eng.model.a
    log(f"[{tag}] {describe(model, full)}; {a.moe_experts} "
        f"experts top-{a.moe_topk}, capacity factor {a.capacity_factor}; "
        f"engine {MOE_KW} (monolithic prefill); built in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
               for n in MOE_PROMPT_LENS]
    decode = count_decode(eng)
    k1_dec: dict = {}
    count_decode_k1(eng, k1_dec)
    k1_all: dict = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    with k1_by_contraction(k1_all):
        for p in prompts:
            eng.submit(p, MOE_NEW)
        out = eng.drain()
    toks = [out[i] for i in range(len(prompts))]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ops.LAUNCHES)
    met = eng.metrics()
    steps = max(met["decode_steps"], 1)
    log(f"[{tag}] {name}: {len(prompts)} requests, prompts "
        f"{MOE_PROMPT_LENS}, {MOE_NEW} new tokens each: wall {wall:.3f} s, "
        f"TTFT mean {1e3 * met['ttft_mean_s']:.1f} ms, decode "
        f"{1e3 * met['decode_wall_s'] / steps:.2f} ms/step over "
        f"{met['decode_steps']} steps; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"[{tag}] {name}: launches per decode step "
        f"{ {k: v / steps for k, v in decode.items() if v} }; K1 by "
        f"contraction in decode steps {k1_dec}, in the run {k1_all}")
    for k in DENSE_KERNELS:
        assert counts[k] > 0, f"{name}: kernel {k} was never launched"
    assert k1_all.get("qmatmul_moe_up", 0) > 0 \
        and k1_dec.get("qmatmul_moe_down", 0) > 0, \
        f"{name}: the batched expert K1 was never launched"
    for t in toks:
        assert len(t) == MOE_NEW and all(0 <= x < a.vocab for x in t)
    for k, v in k1_dec.items():
        launches[f"{short}:decode:{k}"] = v
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    kernels_vs_plain(tag, f"{name} greedy (monolithic)", model, MOE_KW,
                     prompts, toks=toks)
    for p in prompts:
        tok = torch.as_tensor(p[None], device="cuda")
        lk = model.prefill(tok, len(p) + MOE_NEW)[1][0, :a.vocab]
        with ops.plain_reference():
            lp = model.prefill(tok, len(p) + MOE_NEW)[1][0, :a.vocab]
        dist = float((lk - lp).abs().max())
        log(f"[{tag}] {name}: first logits of a {len(p)}-token prompt "
            f"(monolithic): max |kernel - plain| {dist:.3e}, argmax "
            f"{int(lk.argmax())} vs {int(lp.argmax())}")
        assert bool(torch.isfinite(lk).all()), "non-finite logits"
        assert dist == 0.0, f"{name}: first logits differ"
    # chunked prefill: a 16-token page routes with capacity
    # ceil(16 * k / E * 1.25) (5 on granite: K1's narrow route)
    kw = dict(MOE_KW, prefill_mode="chunked")
    before = dict(ops.LAUNCHES)
    k1_chunk: dict = {}
    with k1_by_contraction(k1_chunk):
        ctoks = kernels_vs_plain(tag, f"{name} greedy (chunked)", model, kw,
                                 prompts, MOE_CHUNK_KERNELS)
    same = np.mean([x == y for t, u in zip(toks, ctoks)
                    for x, y in zip(t, u)])
    log(f"[{tag}] {name}: chunked prefill tokens equal to monolithic "
        f"prefill's {same:.3f} (not required: each page's amax spans the "
        f"page); K1 by "
        f"contraction over the kernels' and plain runs {k1_chunk}")
    for k, v in ops.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v - before[k]
    lk = first_logits(model, prompts[1])
    with ops.plain_reference():
        lp = first_logits(model, prompts[1])
    dist = float((lk - lp).abs().max())
    log(f"[{tag}] {name}: first logits of a prefill page (chunked): max "
        f"|kernel - plain| {dist:.3e}")
    assert bool(torch.isfinite(lk).all()), "non-finite logits"
    assert dist == 0.0, f"{name}: chunked first logits differ"
    del eng, model
    torch.cuda.empty_cache()


def moe_train(tag: str, name: str, short: str, full: int, depth: int,
              launches: dict) -> None:
    """One make_train_step on a 1 x TRAIN_SEQ sequence, its dropped pairs,
    a profiled step and step 1 through the plain versions."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    t0 = time.time()
    cfg = preset("full8")
    model = build_model(get(name).replace(n_layers=depth), cfg,
                        device="cuda").init(0)
    a = model.a
    task = TokenTask(a.vocab, TRAIN_SEQ, 1, kind="arith")
    batches = [task.batch(0), task.batch(1)]
    cap = math.ceil(TRAIN_SEQ * a.moe_topk / a.moe_experts
                    * a.capacity_factor)
    log(f"[{tag}] train: {describe(model, full)}, full8 native, "
        f"batch 1 x {TRAIN_SEQ} tokens (TokenTask arith), expert capacity "
        f"{cap}; built in {time.time() - t0:.1f} s")

    total = train_steps(
        f"{tag} {short} train", model, cfg, batches, TRAIN_KERNELS,
        k1_by_contraction,
        lambda run: moe_profile(run, f"{short} MoE train step"))
    assert total.get("qmatmul_moe_up", 0) > 0 \
        and total.get("qmatmul_moe_down_dw", 0) > 0, \
        f"{name}: the batched expert K1 was never launched in training"
    stats: dict = {}
    with torch.no_grad(), moe_drops(stats):
        model.loss(batches[0])
    dropped = int(stats["dropped"])
    log(f"[{tag}] {short} train: dropped (token, choice) pairs at "
        f"train_4k {dropped} of {stats['pairs']} "
        f"({dropped / stats['pairs']:.4f}) over {depth} layers, capacity "
        f"{cap} a expert")
    for k, v in total.items():
        if k.startswith("qmatmul_"):
            launches[f"{short}:train:{k}"] = v
        else:
            launches[k] = launches.get(k, 0) + v
    del model
    torch.cuda.empty_cache()


def phase_moe() -> dict:
    """granite-moe-1b-a400m (6 of 24 layers) and moonshot-v1-16b-a3b (2
    layers) at full width: served and trained against the plain versions.
    Returns the launches: per op summed, and K1's expert contractions by
    model:run:contraction."""
    launches: dict = {}
    for spec in MOE:
        moe_serve("moe", *spec, launches)
        moe_train("moe", *spec, launches)
    return launches


# ---------------------------------------------------------------------------
# phase 5: train the paper's ResNet-50 at full size
# ---------------------------------------------------------------------------

RESNET_BATCH = 32         # the reference's input_specs batch of 128, cut
RESNET_STEPS = 3
RESNET_KERNELS = ("ubn_norm", "quantize")
# ResNet-50 at batch 32, 224 px: (M, C) of each quantized BN -> K4 "batch"
# calls a training step (the resnet phase checks it against its own calls)
RESNET50_BN = {(100352, 64): 6, (100352, 256): 4, (100352, 128): 1,
               (25088, 128): 7, (25088, 512): 5, (25088, 256): 1,
               (6272, 256): 11, (6272, 1024): 7, (6272, 512): 1,
               (1568, 512): 5, (1568, 2048): 4}


@contextlib.contextmanager
def bn_by_shape(counts: dict):
    """Count K4 "batch" launches by the (M, C) of x into `counts`, under
    the key "ubn_norm_batch_<M>x<C>"."""
    from repro_torch.kernels import ops
    real = ops.ubn_norm

    def spy(x, *args, kind="rms", **kw):
        before = ops.LAUNCHES["ubn_norm"]
        y = real(x, *args, kind=kind, **kw)
        if kind == "batch":
            key = "ubn_norm_batch_{}x{}".format(*x.shape)
            counts[key] = counts.get(key, 0) + ops.LAUNCHES["ubn_norm"] \
                - before
        return y

    ops.ubn_norm = spy
    try:
        yield counts
    finally:
        ops.ubn_norm = real


def phase_resnet() -> dict:
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import ImageTask
    from repro_torch.models import build_model
    from repro_torch.optim import flatten
    t0 = time.time()
    cfg = preset("full8")
    model = build_model(get("resnet50"), cfg, device="cuda").init(0)
    a = model.a
    task = ImageTask(a.img_size, a.num_classes, RESNET_BATCH, seed=0)
    batches = [task.batch(i) for i in range(RESNET_STEPS + 1)]
    n_leaves = len(flatten(model.params()))
    log(f"[resnet] resnet50 at full size ({a.block} stages "
        f"{a.stage_sizes}, {a.img_size}x{a.img_size}x3 images, "
        f"{a.num_classes} classes), {n_leaves} parameter leaves, "
        f"{model.n_params() / 1e6:.2f} M params, seed 0, full8 native, lr "
        f"0.05; ImageTask batch {RESNET_BATCH} (the reference's input_specs "
        f"batch of 128 cut to {RESNET_BATCH} to keep the phase short); "
        f"built with its batches in {time.time() - t0:.1f} s")
    assert n_leaves == 161, n_leaves
    total = train_steps(
        "resnet", model, cfg, batches, RESNET_KERNELS, bn_by_shape,
        lambda run: with_profile(run, "resnet50 train step",
                                 {"K4 batch (ubn_batch_*, its 52 calls)":
                                  "ubn_batch_"}))
    log(f"[resnet] peak device memory {PEAK['resnet'] / 1e9:.2f} GB")
    shapes = {k: v for k, v in total.items()
              if k.startswith("ubn_norm_batch_")}
    want = {"ubn_norm_batch_{}x{}".format(*mc): RESNET_STEPS * n
            for mc, n in RESNET50_BN.items()}
    log(f"[resnet] K4 batch launches in {RESNET_STEPS} steps by (M, C): "
        f"{shapes}")
    assert shapes == want, "K4 batch shapes of the steps differ from " \
        "RESNET50_BN"
    return total


# ---------------------------------------------------------------------------
# phase 6: checkpoints and resume, microbatching, the bit-width presets
# ---------------------------------------------------------------------------

CKPT_STEPS = 4            # unbroken; the resumed run saves after 2
MICRO_BATCH = 128         # the reference's input_specs batch ...
N_MICRO = 4               # ... as 4 microbatches of RESNET_BATCH


def _resnet(cfg, seed: int = 0):
    from repro_torch.configs import get
    from repro_torch.models import build_model
    from repro_torch.optim import init_momentum
    model = build_model(get("resnet50"), cfg, device="cuda").init(seed)
    return model, init_momentum(model.params())


def _counted(fn, kernels, what: str) -> dict:
    """fn() with the launch counts set to 0 just before and read just
    after; every kernel in `kernels` must have launched."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    for k in kernels:
        assert counts[k] > 0, f"kernel {k} not launched in {what}"
    return counts


def phase_ckpt() -> None:
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import preset
    from repro_torch.data import ImageTask
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import flatten
    cfg = preset("full8")
    task = ImageTask(224, 1000, RESNET_BATCH, seed=0)
    batches = [task.batch(i) for i in range(CKPT_STEPS)]

    # resume: 4 unbroken steps against 2, a save, a fresh model and
    # optimizer state, a restore and 2 more
    model, opt = _resnet(cfg)
    step = make_train_step(model, cfg, lr=0.05)
    losses = []
    counts = _counted(lambda: losses.extend(
        float(step(opt, batches[i], i)["loss"]) for i in range(CKPT_STEPS)),
        RESNET_KERNELS, "the unbroken ckpt run")
    log(f"[ckpt] resnet50 full8, {CKPT_STEPS} unbroken steps: losses "
        f"{[round(x, 6) for x in losses]}; launches {counts}")
    first, fopt = _resnet(cfg)
    fstep = make_train_step(first, cfg, lr=0.05)
    for i in range(2):
        fstep(fopt, batches[i], i)
    directory = os.path.join(ROOT, "build", "ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    cm = CheckpointManager(directory)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        cm.save(2, (first.params(), fopt))
        held = time.time() - t0
        cm.wait()
        written = time.time() - t0
        rep = cm.size_report(2)
        del first, fopt, fstep
        model2, opt2 = _resnet(cfg, seed=1)
        t0 = time.time()
        _, at, _ = cm.restore((model2.params(), opt2))
        torch.cuda.synchronize()
        restored = time.time() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log(f"[ckpt] save of step 2 held the caller {held * 1e3:.1f} ms (host "
        f"copy of {len(flatten(model2.params())) * 2 + 1} leaves), written "
        f"in {written:.2f} s; {rep['ckpt_bytes_q']} B packed vs "
        f"{rep['ckpt_bytes_f32_dense']} B dense-f32 (ratio "
        f"{rep['ratio']:.3f}, encodings {rep['leaf_encodings']}), "
        f"{rep['disk_bytes']} B on disk; restore {restored:.2f} s")
    assert at == 2 and opt2.step == 2, (at, opt2.step)
    step2 = make_train_step(model2, cfg, lr=0.05)
    resumed = [float(step2(opt2, batches[i], i)["loss"])
               for i in range(2, CKPT_STEPS)]
    same_p = [torch.equal(a, b) for a, b in zip(flatten(model2.params()),
                                                flatten(model.params()))]
    same_a = [torch.equal(a, b) for a, b in zip(flatten(opt2.acc),
                                                flatten(opt.acc))]
    log(f"[ckpt] resumed at step 2, steps 3-4: losses "
        f"{[round(x, 6) for x in resumed]} vs {[round(x, 6) for x in losses[2:]]}"
        f"; parameters equal {sum(same_p)}/{len(same_p)}, accumulator "
        f"equal {sum(same_a)}/{len(same_a)}")
    assert resumed == losses[2:], "resumed losses differ from unbroken"
    assert all(same_p), "resumed parameters differ from the unbroken run's"
    assert all(same_a), "resumed accumulator differs from the unbroken run's"
    del model, opt, step, model2, opt2, step2

    # microbatching: the reference's batch of 128 as 4 microbatches of 32
    big = ImageTask(224, 1000, MICRO_BATCH, seed=0)
    model, opt = _resnet(cfg)
    step = make_train_step(model, cfg, lr=0.05, n_micro=N_MICRO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        batch = big.batch(i)
        t0 = time.time()
        out = {}
        counts = _counted(lambda: out.update(step(opt, batch, i)),
                          RESNET_KERNELS, "the microbatched step")
        wall = time.time() - t0
        loss = float(out["loss"])
        log(f"[ckpt] n_micro {N_MICRO} x {RESNET_BATCH} step {i + 1}: loss "
            f"{loss:.6f}, wall {wall:.3f} s, {MICRO_BATCH / wall:.1f} "
            f"images/s; K4 batch launches {counts['ubn_norm']} "
            f"(52 x {N_MICRO}); launches {counts}")
        assert math.isfinite(loss), "non-finite microbatched loss"
        assert counts["ubn_norm"] == 52 * N_MICRO, counts["ubn_norm"]
    log(f"[ckpt] peak device memory at batch {MICRO_BATCH} in {N_MICRO} "
        f"microbatches {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"beside the resnet phase's at batch {RESNET_BATCH} "
        f"{PEAK['resnet'] / 1e9:.2f} GB")
    del model, opt, step

    # the bit-width presets: w4a8 and g16 on ResNet-50, a4 on the train
    # phase's granite shape (K5 at k_a = 4)
    for name in ("w4a8", "g16"):
        pcfg = preset(name)
        model, opt = _resnet(pcfg)
        step = make_train_step(model, pcfg, lr=0.05)
        out, seen = {}, []
        with weight_payloads(seen):
            counts = _counted(lambda: out.update(step(opt, batches[0], 0)),
                              RESNET_KERNELS, f"the {name} step")
        loss = float(out["loss"])
        wmax = max(seen)
        log(f"[ckpt] {name} resnet50 step: loss {loss:.6f}, largest weight "
            f"payload {wmax} over {len(seen)} Q_W calls; launches {counts}")
        assert math.isfinite(loss), f"non-finite {name} loss"
        assert wmax <= (7 if name == "w4a8" else 127), wmax
        del model, opt, step
    a4_step()


@contextlib.contextmanager
def weight_payloads(seen: list):
    """Record the largest |payload| of every Q_W the ResNet calls."""
    from repro_torch.models import resnet
    real = resnet.qweight

    def spy(q, w):
        qt = real(q, w)
        seen.append(int(qt.data.abs().max()))
        return qt

    resnet.qweight = spy
    try:
        yield seen
    finally:
        resnet.qweight = real


def a4_step() -> None:
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import init_momentum
    cfg = preset("a4")
    model = build_model(get("granite-3-8b").replace(n_layers=4), cfg,
                        device="cuda").init(0)
    opt = init_momentum(model.params())
    step = make_train_step(model, cfg, lr=0.05)
    batch = TokenTask(model.a.vocab, TRAIN_SEQ, 1, kind="arith").batch(0)
    out = {}
    counts = _counted(lambda: out.update(step(opt, batch, 0)),
                      TRAIN_KERNELS, "the a4 step")
    loss = float(out["loss"])
    log(f"[ckpt] a4 granite-3-8b step (4 of 40 layers, 1 x {TRAIN_SEQ} "
        f"tokens, K5 at k_a = {cfg.k_a}): loss {loss:.6f}; launches {counts}")
    assert math.isfinite(loss), "non-finite a4 loss"
    del model, opt, step
    torch.cuda.empty_cache()


def with_profile(fn, what: str, groups: dict | None = None):
    """torch.profiler over one call of `fn` (a synchronised step); `groups`
    maps a label to a kernel-name prefix whose device time is summed.
    Returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    report_profile(prof, wall_us, 1, what, groups)
    return prof


def device_events(prof) -> list:
    """(name, start ns, duration ns) of every event on the card's timeline
    (kernels, copies, fills and the profiler ranges' spans), from the
    profiler's raw results: over the 10^5 and more events of a 24-layer
    step this takes seconds, where building its FunctionEvents (what
    key_averages and events() read) takes minutes."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


SPANS = ("K1 ", "MoE ")


def span_split(events: list, prefix: str, match: str = "") -> dict:
    """Device time of the kernels (whose name holds `match`) that start
    inside each range named `prefix`...: range -> (calls, kernels, ns).  A
    kernel belongs to the range whose span on the card's timeline holds
    its start."""
    import bisect
    spans = sorted((t0, t0 + d, name) for name, t0, d in events
                   if name.startswith(prefix))
    starts = [sp[0] for sp in spans]
    out = {}
    for _, _, name in spans:
        n, k, ns = out.get(name, (0, 0, 0))
        out[name] = (n + 1, k, ns)
    for name, t0, d in events:
        if name.startswith(SPANS) or match not in name:
            continue
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t0 < spans[i][1]:
            n, k, ns = out[spans[i][2]]
            out[spans[i][2]] = (n, k + 1, ns + d)
    return out


def k1_split(prof, what: str) -> None:
    """K1's device time (its qmm_* kernels) by the "K1 <key>" range of
    k1_by_contraction that each ran in (span_split)."""
    events = device_events(prof)
    split = span_split(events, "K1 ", "qmm_")
    if not split:
        log(f"[profile] {what}: K1 by contraction: not measured (no range "
            f"on the card's timeline)")
        return
    sums = {name.removeprefix("K1 "): (n, ns / 1e6)
            for name, (n, _, ns) in split.items()}
    inside = sum(ms for _, ms in sums.values())
    outside = sum(d for name, _, d in events
                  if "qmm_" in name and not name.startswith(SPANS)) / 1e6 \
        - inside
    attn = sum(ms for k, (_, ms) in sums.items() if "attn" in k)
    log(f"[profile] {what}: K1 device ms by contraction "
        + ", ".join(f"{k} {ms:.3f} in {n} calls"
                    for k, (n, ms) in sorted(sums.items()))
        + f"; qdense {sums.get('qmatmul_qdense', (0, 0.0))[1]:.3f} ms, "
        f"attention chunks {attn:.3f} ms, outside the ranges "
        f"{outside:.3f} ms")


def report_profile(prof, wall_us: float, steps: int, what: str,
                   groups: dict | None = None) -> None:
    import torch

    # device-side events only (kernels, copies): a host op's device time
    # is its kernels' time again, and so is a "K1 ..." range's span
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("K1 ")),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    if busy <= 0:
        log(f"[profile] {what}: the profiler saw no device time: not "
            f"measured")
        return
    log(f"[profile] {steps} {what}(s) (profiler on): wall "
        f"{wall_us / 1e3 / steps:.3f} ms each, device busy "
        f"{busy / 1e3 / steps:.3f} ms each, busy share {busy / wall_us:.3f}")
    for e in rows[:14]:
        log(f"  {dev_us(e) / 1e3 / steps:9.3f} ms  "
            f"{e.count // steps:5d} calls  {e.key[:70]}")
    for label, prefix in (groups or {}).items():
        sel = [e for e in rows
               if e.key.removeprefix("void ").startswith(prefix)]
        ms = sum(map(dev_us, sel)) / 1e3 / steps
        log(f"[profile] {what}: {label} {ms:.3f} ms in "
            f"{sum(e.count for e in sel) // steps} launches each")


# ---------------------------------------------------------------------------
# phase 11: the sim and fp32 numeric modes
# ---------------------------------------------------------------------------

MODES_DEPTH = 2           # granite-3-8b layers of the quickstart table
MODES_STEPS = 3
# the rows of the reference's examples/quickstart.py table: (label, preset,
# mode); the fp32 preset is fp32 whatever the mode
QUICKSTART = (("fp32", "fp32", None), ("e2_16 native", "e2_16", "native"),
              ("full8 sim", "full8", "sim"),
              ("full8 native", "full8", "native"))
# the kernels that only native mode runs
NATIVE_ONLY = ("qmatmul", "dgrad", "wgrad", "ubn_norm", "flash_attention",
               "paged_attention")
MODES_RESNET_STEPS = 2


def _load(model, host: list) -> None:
    import torch
    from repro_torch.optim import flatten
    with torch.no_grad():
        for p, h in zip(flatten(model.params()), host):
            p.copy_(h)


def off_native(tag: str, launches: dict, sim: bool) -> None:
    """A sim or fp32 run launched none of K1, K3, K4, K5 and K6; a sim run
    launched K2."""
    ran = {k: v for k, v in launches.items() if v}
    log(f"[modes] {tag}: kernels launched {ran}")
    for k in NATIVE_ONLY:
        assert not launches.get(k), f"{tag}: the native kernel {k} launched"
    if sim:
        assert launches.get("quantize", 0) > 0, f"{tag}: K2 never launched"


def hidden_codes(labels: list, leaves: list) -> np.ndarray:
    """The hidden ("w") leaves' k_WU-grid codes (2^-23 units)."""
    return np.concatenate([
        h.numpy().astype(np.float64).ravel() * 2 ** 23
        for h, lab in zip(leaves, labels) if lab == "w"])


def modes_quickstart(out: dict) -> None:
    """granite-3-8b at full width, MODES_DEPTH layers, from one init: 3 steps
    of each QUICKSTART row on one 1 x 4096 arith sequence; the sim and fp32
    rows against the plain versions."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    from repro_torch.optim import flatten
    t0 = time.time()
    acfg = get("granite-3-8b").replace(n_layers=MODES_DEPTH)
    model = build_model(acfg, preset("full8"), device="cuda").init(0)
    weights = _host_copy(model.params())
    log(f"[modes] quickstart: {describe(model, 40)}, batch 1 x {TRAIN_SEQ} "
        f"tokens (TokenTask arith), {MODES_STEPS} steps a row from the "
        f"same initial weights (full8's init); built in "
        f"{time.time() - t0:.1f} s")
    del model
    task = TokenTask(acfg.vocab, TRAIN_SEQ, 1, kind="arith")
    batches = [task.batch(i) for i in range(MODES_STEPS)]
    for label, name, mode in QUICKSTART:
        cfg = preset(name, mode)
        model = build_model(acfg, cfg, device="cuda")
        _load(model, weights)
        tag = f"modes {label}"
        total = train_steps(tag, model, cfg, batches,
                            ("quantize",) if cfg.mode == "sim" else (),
                            plain=not cfg.native, keep=name == "full8")
        if not cfg.native:
            off_native(tag, total, cfg.mode == "sim")
        out[f"quickstart {label}"] = total
        del model
        torch.cuda.empty_cache()
    rows = [RUNS[f"modes {label}"] for label, _, _ in QUICKSTART]
    log("[modes] quickstart table (loss by step; the reference's "
        "examples/quickstart.py rows):")
    log("  step  " + "".join(f"{label:>16}" for label, _, _ in QUICKSTART))
    for i in range(MODES_STEPS):
        log(f"  {i + 1:4d}  " + "".join(f"{r['losses'][i]:16.6f}"
                                        for r in rows))
    log("  wall  " + "".join(
        f"{min(r['walls']):8.3f}-{max(r['walls']):.3f} s" for r in rows))
    log("  peak  " + "".join(f"{r['peak'] / 1e9:13.2f} GB" for r in rows))
    # sim against native after step 1 (reported, not held)
    labels = flatten(build_model(acfg, preset("full8"),
                                 device="meta").labels())
    d = np.abs(hidden_codes(labels, RUNS["modes full8 sim"]["after1"])
               - hidden_codes(labels, RUNS["modes full8 native"]["after1"]))
    log(f"[modes] full8 sim against full8 native after step 1: hidden codes "
        f"differing {np.mean(d > 0):.6f}, max distance {d.max():.0f} codes; "
        f"step-1 loss {rows[2]['losses'][0]:.6f} vs "
        f"{rows[3]['losses'][0]:.6f}")
    for label in ("full8 sim", "full8 native"):
        del RUNS[f"modes {label}"]["after1"], \
            RUNS[f"modes {label}"]["after1_acc"]


def modes_serve(out: dict) -> None:
    """granite-3-8b at full width, 4 layers, in sim mode: the serve phase's
    requests on monolithic and chunked prefill against the plain versions,
    first logits against the plain versions and against native mode."""
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, make_engine
    t0 = time.time()
    model = make_engine("granite-3-8b", mode="sim", reduced=False,
                        n_layers=4, device="cuda", seed=0).model
    a = model.a
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    log(f"[modes] serve: {describe(model, 40)}, full8 sim; built in "
        f"{time.time() - t0:.1f} s")
    for prefill in ("monolithic", "chunked"):
        kw = dict(ENGINE_KW, prefill_mode=prefill)
        eng = Engine(model, **kw)
        decode = count_decode(eng)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.time()
        toks = _serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = dict(ops.LAUNCHES)
        met = eng.metrics()
        steps = max(met["decode_steps"], 1)
        per_step = {k: v / steps for k, v in decode.items() if v}
        log(f"[modes] sim serve {prefill}: wall {wall:.3f} s, decode "
            f"{1e3 * met['decode_wall_s'] / steps:.2f} ms a step over "
            f"{met['decode_steps']} steps, TTFT mean "
            f"{1e3 * met['ttft_mean_s']:.1f} ms; launches per decode step "
            f"{per_step}")
        off_native(f"sim serve {prefill}", ran, True)
        assert decode["page_gather"] > 0 and decode["quantize"] > 0, \
            "sim decode steps must gather pages (K7) and write KV (K2)"
        out[f"serve {prefill}"] = dict(ran, **{
            f"{k}_decode": v for k, v in decode.items()})
        kernels_vs_plain("modes", f"sim serve {prefill}", model, kw, prompts,
                         toks=toks)
    lk = first_logits(model, prompts[0])
    with ops.plain_reference():
        lp = first_logits(model, prompts[0])
    dist = float((lk - lp).abs().max())
    log(f"[modes] sim first logits: max |kernels - plain| {dist:.3e}")
    assert bool(torch.isfinite(lk).all()), "non-finite sim logits"
    assert dist == 0.0, "the sim logits differ from the plain versions'"
    native = build_model(a, preset("full8"), device="cuda")
    native.load_state_dict(model.state_dict())
    ln = first_logits(native, prompts[0])
    d = float((lk - ln).abs().max())
    log(f"[modes] sim against native first logits (reported, not held): "
        f"max |sim - native| {d:.3e} ({d / float(ln.abs().max()):.3e} of "
        f"max |logit|), argmax {int(lk.argmax())} vs {int(ln.argmax())}")
    del model, native
    torch.cuda.empty_cache()


def modes_others(out: dict) -> None:
    """ResNet-50 2 steps of batch 32 in sim and in fp32; falcon-mamba-7b
    (4 of 64 layers) 3 fp32 steps on ssm_train's sequence; one
    granite-moe-1b-a400m sim step (2 of 24 layers); each against the
    plain versions."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import ImageTask, TokenTask
    from repro_torch.models import build_model
    for mode in ("sim", "fp32"):
        cfg = preset("full8", mode)
        model, _ = _resnet(cfg)
        a = model.a
        task = ImageTask(a.img_size, a.num_classes, RESNET_BATCH, seed=0)
        tag = f"modes resnet50 {mode}"
        log(f"[{tag}] resnet50 at full size, batch {RESNET_BATCH}, "
            f"{MODES_RESNET_STEPS} steps")
        total = train_steps(tag, model, cfg, [
            task.batch(i) for i in range(MODES_RESNET_STEPS)],
            ("quantize",) if mode == "sim" else ())
        off_native(tag, total, mode == "sim")
        out[f"resnet50 {mode}"] = total
        del model
        torch.cuda.empty_cache()

    cfg = preset("fp32")
    model = build_model(get("falcon-mamba-7b").replace(n_layers=4), cfg,
                        device="cuda").init(0)
    tag = "modes ssm fp32"
    log(f"[{tag}] {describe(model, 64)}, fp32 (init(0) off the k_WU grid), "
        f"ssm_train's 1 x {TRAIN_SEQ} arith sequence")
    task = TokenTask(model.a.vocab, TRAIN_SEQ, 1, kind="arith")
    total = train_steps(tag, model, cfg,
                        [task.batch(i) for i in range(SSM_TRAIN_STEPS)],
                        ("selective_scan", "selective_scan_bwd"))
    off_native(tag, total, False)
    out["ssm fp32"] = total
    native = RUNS.get("ssm_train", {}).get("losses", [])
    log(f"[modes] ssm_train losses, full8 native {native} against the fp32 "
        f"baseline {RUNS[tag]['losses']}")
    del model
    torch.cuda.empty_cache()

    cfg = preset("full8", "sim")
    model = build_model(get("granite-moe-1b-a400m").replace(n_layers=2), cfg,
                        device="cuda").init(0)
    tag = "modes moe sim"
    log(f"[{tag}] {describe(model, 24)}, full8 sim, 1 x {TRAIN_SEQ} tokens")
    task = TokenTask(model.a.vocab, TRAIN_SEQ, 1, kind="arith")
    total = train_steps(tag, model, cfg, [task.batch(0)], ("quantize",))
    off_native(tag, total, True)
    out["moe sim"] = total
    del model
    torch.cuda.empty_cache()


def phase_modes() -> dict:
    """The reference's other numeric modes on the card.  Returns the
    launches by run."""
    out: dict = {}
    t0 = time.time()
    modes_quickstart(out)
    modes_serve(out)
    modes_others(out)
    log(f"[modes] phase {time.time() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the enc-dec (seamless-m4t-large-v2) at full width and depth
# ---------------------------------------------------------------------------

ENCDEC = "seamless-m4t-large-v2"
ENCDEC_LANES = 4
ENCDEC_SRC = TRAIN_SEQ    # frames a request (train_4k); t_self = S // 4
ENCDEC_NEW = 32           # greedy tokens a request
ENCDEC_START = 0          # the fixed start token of every request
ENCDEC_TRAIN_STEPS = 3
# encoder and decoder layers each, of the published 24 + 24: cut from full
# depth to 12 + 12 with the full_depth phase and to 6 + 6 with the dp
# phase (the whole run's time limit)
ENCDEC_DEPTH = 6
ENCDEC_KERNELS = ("qmatmul", "quantize", "ubn_norm", "flash_attention")
# device time by kernel family: the substring of its kernels' names
KERNEL_NAMES = {"K1": "qmm_", "K2": "quantize_kernel", "K3": "bwd_",
                "K4": "ubn_", "K5": "fa_"}


def device_split(fn, what: str) -> None:
    """One call of `fn` under a CUDA-only torch.profiler: its wall, the
    card's busy time and share, and the device ms of K1-K5 (KERNEL_NAMES)
    and of the rest, from the profiler's raw events (device_events: a
    48-layer step makes too many for FunctionEvents)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    events = device_events(prof)
    if not events:
        log(f"[profile] {what}: the profiler saw no device time: not "
            f"measured")
        return
    by = dict.fromkeys(list(KERNEL_NAMES) + ["other"], 0.0)
    for name, _, d in events:
        key = next((k for k, m in KERNEL_NAMES.items() if m in name),
                   "other")
        by[key] += d / 1e6
    busy = sum(by.values())
    log(f"[profile] {what} (profiler on): wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, busy share {busy / wall:.3f}; device ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in by.items())
        + f" over {len(events)} device events")


@contextlib.contextmanager
def norm_attn_counts(counts: dict, visits: dict | None = None):
    """While inside, count K4's launches by (kind, rows x width) into
    `counts` ("ubn_norm_layer_4096x1024", ...) and K5's by call ("..._
    encoder": non-causal over its own positions, "..._cross": non-causal
    over other positions, "..._decoder": causal) and by head width
    ("flash_attention_dh112", ...).  With `visits`, each K5
    call also gathers its visited tiles: kind -> [stats launch, main
    launch, tiles in all], read once at the end (no sync per call)."""
    import torch
    from repro_torch.kernels import ops
    real_fa, real_ubn = ops.flash_attention, ops.ubn_norm
    dev_visits: dict = {}

    def add(key):
        counts[key] = counts.get(key, 0) + 1

    def fa(q8, k8, v8, *args, causal, **kw):
        b, s_, h, _ = q8.shape
        t, kv = k8.shape[1], k8.shape[2]
        kind = "decoder" if causal else ("encoder" if s_ == t else "cross")
        before = ops.LAUNCHES["flash_attention"]
        if visits is not None:
            kw["visits"] = torch.zeros(2, dtype=torch.int64,
                                       device=q8.device)
        out = real_fa(q8, k8, v8, *args, causal=causal, **kw)
        if ops.LAUNCHES["flash_attention"] > before:
            add(f"flash_attention_{kind}")
            add(f"flash_attention_dh{q8.shape[3]}")
            if visits is not None:
                acc = dev_visits.setdefault(kind, [0, 0])
                acc[0] = acc[0] + kw["visits"]
                acc[1] += b * kv * -(-s_ * (h // kv) // 128) * -(-t // 64)
        return out

    def ubn(x, *args, kind="rms", **kw):
        before = ops.LAUNCHES["ubn_norm"]
        out = real_ubn(x, *args, kind=kind, **kw)
        if ops.LAUNCHES["ubn_norm"] > before:
            add(f"ubn_norm_{kind}_{x.shape[0]}x{x.shape[1]}")
        return out

    ops.flash_attention, ops.ubn_norm = fa, ubn
    try:
        yield counts
    finally:
        ops.flash_attention, ops.ubn_norm = real_fa, real_ubn
        for kind, (v, tiles) in dev_visits.items():
            visits[kind] = v.tolist() + [tiles]


def encdec_serve(model, launches: dict) -> None:
    """ENCDEC_LANES requests of ENCDEC_SRC seeded N(0, 1) frames: prefill,
    then ENCDEC_NEW greedy serve_steps from ENCDEC_START; launches a
    decode step; the same through the plain versions, whose tokens and
    first logits must be equal bit for bit."""
    import torch
    from repro_torch.kernels import ops
    a = model.a
    t_self = ENCDEC_SRC // a.tgt_ratio
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn((ENCDEC_LANES, ENCDEC_SRC, a.d_model), generator=g,
                         device="cuda")

    def run(count: dict | None = None):
        torch.cuda.synchronize()
        t0 = time.time()
        cache = model.prefill(frames, t_self)
        torch.cuda.synchronize()
        t1 = time.time()
        before = dict(ops.LAUNCHES)
        tok = torch.full((ENCDEC_LANES,), ENCDEC_START, dtype=torch.int32,
                         device="cuda")
        toks, first = [], None
        with norm_attn_counts(count) if count is not None \
                else contextlib.nullcontext():
            for _ in range(ENCDEC_NEW):
                cache, lg = model.serve_step(cache, tok)
                first = lg[:, :a.vocab].cpu() if first is None else first
                tok = lg[:, :a.vocab].argmax(-1).to(torch.int32)
                toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.time()
        decode = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        return (torch.stack(toks, 1).cpu(), first, t1 - t0, t2 - t1,
                decode, cache)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    pre: dict = {}
    with norm_attn_counts(pre):
        model.prefill(frames, t_self)          # warm: K5's scratch, cuBLAS
    prefill_launches = dict(ops.LAUNCHES)
    dec: dict = {}
    toks, first, pre_wall, dec_wall, decode, cache = run(dec)
    assert [int(p) for p in cache["pos"]] == [ENCDEC_NEW] * ENCDEC_LANES
    last = toks[:, -1].to(device="cuda", dtype=torch.int32)
    device_split(lambda: model.serve_step(cache, last),
                 "enc-dec decode step")
    del cache
    device_split(lambda: model.prefill(frames, t_self), "enc-dec prefill")
    steps = ENCDEC_NEW
    log(f"[encdec] serve: {ENCDEC_LANES} requests of {ENCDEC_SRC} frames "
        f"(seeded N(0, 1)), t_self {t_self}, {ENCDEC_NEW} greedy tokens "
        f"each from token {ENCDEC_START}: prefill {pre_wall:.3f} s, decode "
        f"{1e3 * dec_wall / steps:.2f} ms a step, "
        f"{ENCDEC_LANES * steps / dec_wall:.1f} tokens/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[encdec] serve: launches in a prefill "
        f"{ {k: v for k, v in prefill_launches.items() if v} }, by shape "
        f"{pre}")
    log(f"[encdec] serve: launches per decode step "
        f"{ {k: v / steps for k, v in decode.items() if v} }, K4 by shape "
        f"{ {k: v / steps for k, v in dec.items()} }")
    assert decode["paged_attention"] == 0 and decode["page_gather"] == 0, \
        "enc-dec decode launched K6 or K7"
    for k in ("qmatmul", "quantize", "ubn_norm"):
        assert decode[k] > 0, f"enc-dec decode: {k} not launched"
    for k in ENCDEC_KERNELS:
        assert prefill_launches[k] > 0, f"enc-dec prefill: {k} not launched"
    assert bool(torch.isfinite(first).all()), "non-finite logits"
    assert toks.shape == (ENCDEC_LANES, ENCDEC_NEW) \
        and int(toks.min()) >= 0 and int(toks.max()) < a.vocab
    log(f"[encdec] serve: tokens of request 0 {toks[0, :12].tolist()} ...")
    for k, v in pre.items():
        launches[f"serve:prefill:{k}"] = v
    for k, v in dec.items():
        launches[k] = launches.get(k, 0) + v
    before = dict(ops.LAUNCHES)
    t0 = time.time()
    with ops.plain_reference():
        ptoks, pfirst, *_ = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before, "the plain run launched a kernel"
    dist = float((first - pfirst).abs().max())
    eq = float((toks == ptoks).float().mean())
    log(f"[encdec] serve: plain versions on the card {time.time() - t0:.1f} "
        f"s; equal tokens {eq:.3f}, first logits max |kernel - plain| "
        f"{dist:.3e}")
    assert eq == 1.0, "enc-dec: the kernels' tokens differ from the plain's"
    assert dist == 0.0, "enc-dec: first logits differ"


def phase_encdec() -> dict:
    """seamless-m4t-large-v2 at full width, ENCDEC_DEPTH + ENCDEC_DEPTH of
    its 24 + 24 layers: served, then trained ENCDEC_TRAIN_STEPS steps,
    each against the plain versions.  Returns the launches: per op summed, and K4's and K5's by
    shape or call."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    t_phase = time.time()
    cfg = preset("full8")
    full = get(ENCDEC)
    model = build_model(full.replace(enc_layers=ENCDEC_DEPTH,
                                     dec_layers=ENCDEC_DEPTH), cfg,
                        device="cuda").init(0)
    a = model.a
    log(f"[encdec] {a.name} at full width (d={a.d_model}, heads "
        f"{a.n_heads}/{a.n_kv} x {a.dh}, ffn {a.d_ff}, {a.act}, "
        f"{a.norm}, vocab {a.vocab} -> {a.vocab_padded}), depth cut to "
        f"{a.enc_layers} + {a.dec_layers} of {full.enc_layers} + "
        f"{full.dec_layers} layers, "
        f"{model.n_params() / 1e9:.3f} G fp32 params, random weights (seed "
        f"0), full8 native; built in {time.time() - t_phase:.1f} s")
    launches: dict = {}
    encdec_serve(model, launches)
    t_tgt = TRAIN_SEQ // a.tgt_ratio
    task = TokenTask(a.vocab, t_tgt, 1, kind="arith")
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for i in range(ENCDEC_TRAIN_STEPS + 1):     # the last one is profiled
        batch = task.batch(i)
        batch["frames"] = torch.randn((1, TRAIN_SEQ, a.d_model),
                                      generator=g, device="cuda")
        batches.append(batch)
    log(f"[encdec] train: the same model ({a.enc_layers} + "
        f"{a.dec_layers} layers), batch 1 x "
        f"{TRAIN_SEQ} frames (seeded N(0, 1)) and {t_tgt} target tokens "
        f"(TokenTask arith), lr 0.05")
    total = train_steps("encdec train", model, cfg, batches,
                        ENCDEC_KERNELS + ("dgrad", "wgrad"), norm_attn_counts,
                        lambda run: device_split(run, "enc-dec train step"))
    log(f"[encdec] train: K4 and K5 launches in {ENCDEC_TRAIN_STEPS} steps "
        f"by shape or call "
        f"{ {k: v for k, v in total.items() if k.startswith(('ubn_norm_', 'flash_attention_'))} }")
    assert total.get(f"ubn_norm_layer_{TRAIN_SEQ}x{a.d_model}", 0) > 0, \
        f"enc-dec train: K4 layer at {TRAIN_SEQ} rows never launched"
    for kind in ("encoder", "cross", "decoder"):
        assert total.get(f"flash_attention_{kind}", 0) > 0, \
            f"enc-dec train: K5 {kind} never launched"
    seen: dict = {}
    with torch.no_grad(), norm_attn_counts({}, seen):
        model.loss(batches[0])
    for kind, (st_v, mn_v, tiles) in sorted(seen.items()):
        log(f"[encdec] train: K5 {kind} calls of one forward: tiles visited "
            f"{st_v} / {tiles} (stats launch), {mn_v} / {tiles} (main)")
    for kind in ("encoder", "cross"):
        st_v, mn_v, tiles = seen[kind]
        assert st_v == mn_v == tiles, f"enc-dec: K5 {kind} skipped a tile"
    for k, v in total.items():
        launches[k] = launches.get(k, 0) + v
    del model
    torch.cuda.empty_cache()
    log(f"[encdec] phase {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the hybrid zamba2-7b at full width, 13 of 81 layers
# ---------------------------------------------------------------------------

HYBRID = "zamba2-7b"
HYBRID_FULL = 81
HYBRID_DEPTH = 13         # two groups of 6 Mamba2 layers + a 1-layer tail
HYBRID_NEW = 16
HYBRID_KW = dict(max_lanes=4, page_size=16, max_ctx=512)
HYBRID_TRAIN_STEPS = 3
HYBRID_KERNELS = ("qmatmul", "quantize", "ubn_norm", "flash_attention",
                  "paged_attention")
HYBRID_CHUNK_KERNELS = ("qmatmul", "quantize", "ubn_norm", "page_gather",
                        "paged_attention")


def hybrid_serve(model, prompts, launches: dict) -> None:
    """PROMPT_LENS greedy through the engine on monolithic prefill (K5 at
    dh 112, K6 in decode) against the plain versions' run, and the first
    logits of each prompt; then chunked prefill with the radix cache: the
    first two requests and one more that shares the first prompt's first
    4 pages, which must hit the cache, against the run without the cache
    (tokens and every lane's dense slot equal) and the plain versions'
    run with it (tokens equal)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    a = model.a
    eng = Engine(model, **HYBRID_KW)
    decode = count_decode(eng)
    k45: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    with norm_attn_counts(k45):
        for p in prompts:
            eng.submit(p, HYBRID_NEW)
        out = eng.drain()
    toks = [out[i] for i in range(len(prompts))]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ops.LAUNCHES)
    met = eng.metrics()
    steps = max(met["decode_steps"], 1)
    log(f"[hybrid] serve (monolithic): {len(prompts)} requests, prompts "
        f"{PROMPT_LENS}, {HYBRID_NEW} new tokens each: wall {wall:.3f} s, "
        f"TTFT mean {1e3 * met['ttft_mean_s']:.1f} ms, decode "
        f"{1e3 * met['decode_wall_s'] / steps:.2f} ms/step over "
        f"{met['decode_steps']} steps, {met['decode_tok_s']:.1f} tokens/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    ran = {k: v for k, v in counts.items() if v}
    log(f"[hybrid] serve: launches {ran}; per decode step "
        f"{ {k: v / steps for k, v in decode.items() if v} }; K4 and K5 by "
        f"shape {k45}")
    for k in HYBRID_KERNELS:
        assert counts[k] > 0, f"hybrid serve: kernel {k} never launched"
    assert decode["paged_attention"] > 0 and decode["flash_attention"] == 0
    assert k45.get("flash_attention_dh112", 0) == counts["flash_attention"],\
        "hybrid serve: a K5 launch not at dh 112"
    for t in toks:
        assert len(t) == HYBRID_NEW and all(0 <= x < a.vocab for x in t)
    launches["flash_attention_prefill"] = counts["flash_attention"]
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    kernels_vs_plain("hybrid", "greedy (monolithic)", model, HYBRID_KW,
                     prompts, toks=toks)
    for p in prompts:
        tok = torch.as_tensor(p[None], device="cuda")
        lk = model.prefill(tok, len(p) + HYBRID_NEW)[1][0, :a.vocab]
        with ops.plain_reference():
            lp = model.prefill(tok, len(p) + HYBRID_NEW)[1][0, :a.vocab]
        dist = float((lk - lp).abs().max())
        log(f"[hybrid] first logits of a {len(p)}-token prompt "
            f"(monolithic): max |kernel - plain| {dist:.3e}, argmax "
            f"{int(lk.argmax())} vs {int(lp.argmax())}")
        assert bool(torch.isfinite(lk).all()), "non-finite logits"
        assert dist == 0.0, "hybrid: first logits differ"
    last = torch.as_tensor([t[-1] for t in toks], device="cuda")
    device_split(lambda: model.paged_decode_step(
        dict(eng.slots, pos=torch.zeros_like(eng.slots["pos"])),
        eng.pool.view(torch.zeros_like(torch.as_tensor(eng.table,
                                                       device="cuda"))),
        last), "hybrid decode step (all lanes on the trash page)")
    del eng

    # chunked prefill and the radix cache: the first two requests
    # together, then a prompt sharing the first prompt's first 4 pages (64
    # tokens)
    page = HYBRID_KW["page_size"]
    extra = np.concatenate([prompts[0][:4 * page], prompts[1]])

    def run(radix: bool):
        e = Engine(model, prefill_mode="chunked", radix_cache=radix,
                   **HYBRID_KW)
        got = _serve(e, prompts[:2])
        rid = e.submit(extra, HYBRID_NEW)
        got.append(e.drain()[rid])
        torch.cuda.synchronize()
        return got, e

    before = dict(ops.LAUNCHES)
    t0 = time.time()
    ctoks, ceng = run(True)
    ran = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v > before[k]}
    m = ceng.metrics()
    log(f"[hybrid] serve (chunked, radix cache on): wall "
        f"{time.time() - t0:.3f} s, TTFT mean {1e3 * m['ttft_mean_s']:.1f} "
        f"ms, decode {1e3 * m['decode_wall_s'] / max(m['decode_steps'], 1):.2f}"
        f" ms/step; radix {m['radix']}; launches {ran}")
    for k in HYBRID_CHUNK_KERNELS:
        assert ran.get(k, 0) > 0, f"hybrid chunked: kernel {k} never launched"
    assert m["radix"]["hit_pages"] >= 4, "hybrid: the shared prefix missed"
    for k, v in ran.items():
        launches[k] = launches.get(k, 0) + v
    otoks, oeng = run(False)
    same_slots = all(torch.equal(ceng.slots[k], oeng.slots[k])
                     for k in ("m_conv", "m_h"))
    log(f"[hybrid] radix cache off: tokens equal {otoks == ctoks}, the "
        f"request served through the hit {ctoks[-1][:8]} ...; every lane's "
        f"Mamba2 slot equal {same_slots}")
    assert otoks == ctoks, "hybrid: radix hit tokens differ from recompute"
    assert same_slots, "hybrid: radix hit dense state differs"
    del ceng, oeng
    before = dict(ops.LAUNCHES)
    with ops.plain_reference():
        ptoks, _ = run(True)
    assert ops.LAUNCHES == before, "the plain run launched a kernel"
    log(f"[hybrid] chunked + radix through the plain versions: tokens equal "
        f"{ptoks == ctoks}")
    assert ptoks == ctoks, "hybrid chunked: kernels' tokens differ"
    lk = first_logits(model, prompts[1])
    with ops.plain_reference():
        lp = first_logits(model, prompts[1])
    dist = float((lk - lp).abs().max())
    log(f"[hybrid] first logits of a prefill page (chunked): max |kernel - "
        f"plain| {dist:.3e}")
    assert bool(torch.isfinite(lk).all()) and dist == 0.0, \
        "hybrid: chunked first logits differ"


def phase_hybrid() -> dict:
    """zamba2-7b at full width, HYBRID_DEPTH of 81 layers: served, then
    trained HYBRID_TRAIN_STEPS steps, each against the plain versions.
    Returns the launches: per op summed, K5's by call and head width and
    K4's by shape, and "flash_attention_train" / "..._prefill"."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.models import build_model
    t_phase = time.time()
    cfg = preset("full8")
    model = build_model(get(HYBRID).replace(n_layers=HYBRID_DEPTH), cfg,
                        device="cuda").init(0)
    a = model.a
    log(f"[hybrid] {describe(model, HYBRID_FULL)} ({model.n_groups} "
        f"applications of the shared block, a tail of {model.tail}), full8 "
        f"native; engine {HYBRID_KW}; built in {time.time() - t_phase:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, a.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    launches: dict = {}
    hybrid_serve(model, prompts, launches)
    task = TokenTask(a.vocab, TRAIN_SEQ, 1, kind="arith")
    log(f"[hybrid] train: the same model, batch 1 x {TRAIN_SEQ} tokens "
        f"(TokenTask arith), lr 0.05")
    total = train_steps("hybrid train", model, cfg,
                        [task.batch(i) for i in range(HYBRID_TRAIN_STEPS + 1)],
                        TRAIN_KERNELS, norm_attn_counts,
                        lambda run: device_split(run, "hybrid train step"))
    log(f"[hybrid] train: K4 and K5 launches in {HYBRID_TRAIN_STEPS} steps by "
        f"shape or call "
        f"{ {k: v for k, v in total.items() if k.startswith(('ubn_norm_', 'flash_attention_'))} }")
    assert total.get("flash_attention_dh112", 0) == total["flash_attention"] \
        > 0, "hybrid train: K5 not launched at dh 112"
    launches["flash_attention_train"] = total["flash_attention"]
    for k, v in total.items():
        if k != "flash_attention":
            launches[k] = launches.get(k, 0) + v
    del model
    torch.cuda.empty_cache()
    log(f"[hybrid] phase {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: phi4-mini-3.8b trained at full depth on one card (remat "full")
# ---------------------------------------------------------------------------

FULL_DEPTH_STEPS = 2
FULL_DEPTH_KERNELS = ("qmatmul", "quantize", "ubn_norm", "dgrad", "wgrad",
                      "flash_attention")


def phase_full_depth() -> dict:
    """phi4-mini-3.8b at full width and all 32 layers, full8 native, remat
    "full" (each layer's activations recomputed in the backward): 2
    make_train_step steps on one 1 x 4096 sequence with the split, peak
    memory and launches, then step 1 through the plain versions on a
    model rebuilt from the same seed, whose loss, parameters and
    accumulator must equal the kernel run's.  Returns the launches of the
    2 steps."""
    import gc

    import torch
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    tag = "full_depth"
    cfg = preset("full8")
    acfg = get("phi4-mini-3.8b")

    def build():
        return build_model(acfg, cfg, device="cuda").init(0)

    t0 = time.time()
    model = build()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    log(f"[{tag}] {describe(model, acfg.n_layers)}, remat "
        f"{model.a.remat}, full8 native, batch 1 x {TRAIN_SEQ} tokens "
        f"(TokenTask arith); masters, gradients and accumulators "
        f"{12 * model.n_params() / 1e9:.1f} GB of the card's "
        f"{total_mem / 1e9:.1f} GB; built in {time.time() - t0:.1f} s")
    task = TokenTask(acfg.vocab, TRAIN_SEQ, 1, kind="arith")
    batches = [task.batch(i) for i in range(FULL_DEPTH_STEPS)]
    total = train_steps(tag, model, cfg, batches, FULL_DEPTH_KERNELS,
                        plain=False, keep=True)
    run = RUNS[tag]
    log(f"[{tag}] peak device memory {run['peak'] / 1e9:.2f} GB of "
        f"{total_mem / 1e9:.1f} GB; launches a step "
        f"{ {k: v // FULL_DEPTH_STEPS for k, v in total.items() if v} }")
    assert run["peak"] < total_mem
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    model = build()
    log(f"[{tag}] rebuilt from seed 0 for the plain replay in "
        f"{time.time() - t0:.1f} s")
    plain_step_equal(tag, model, make_train_step(model, cfg, lr=0.05),
                     batches[0], None, (run["after1"], run["after1_acc"]),
                     run["losses"][0])
    del run["after1"], run["after1_acc"], model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 15: the data-parallel sharded step, two ranks sharing the card
# ---------------------------------------------------------------------------

DP_ARCH = "granite-3-8b"
DP_DEPTH = 2
DP_SEQ = 2048
DP_BATCH = 2              # global rows: one virtual shard each
DP_SHARDS = 2
DP_STEPS = 2
DP_RANKS = 2
DP_TIMEOUT = 600          # seconds for both ranks' runs
DP_KERNELS = TRAIN_KERNELS


def _digests(leaves, flat_dp: int = 0) -> list:
    """sha256 of each leaf's bytes on the host; with flat_dp, of the leaf
    flattened and zero-padded to the ZeRO-1 layout under that dp."""
    import hashlib

    from repro_torch.launch import shard as S
    out = []
    for t in leaves:
        if flat_dp:
            t = S.pad_flat(t, flat_dp * S.zero_chunk_len(t.numel(), flat_dp))
        out.append(hashlib.sha256(
            t.detach().contiguous().cpu().numpy()).hexdigest())
    return out


def dp_run(mesh, opt_shard: str, tag: str) -> dict:
    """DP_STEPS sharded steps of DP_ARCH built from seed 0 on this rank
    (mesh: launch/mesh.py, dp 1 or DP_RANKS) on the packed int16 wire: per
    step the loss, wall and its split, the sync's bytes by (message,
    dtype), launches and peak memory; then digests of the parameters and
    of the accumulator (ZeRO-1's gathered into the flat layout)."""
    import gc

    import torch
    from repro_torch.checkpoint.manager import tree_keys
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.kernels import ops
    from repro_torch.launch import shard as S
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import flatten, init_momentum
    from repro_torch.runtime import compress as C
    gc.collect()
    torch.cuda.empty_cache()
    cfg = preset("full8")
    model = build_model(get(DP_ARCH).replace(n_layers=DP_DEPTH), cfg,
                        device="cuda").init(0)
    params = model.params()
    zero1 = opt_shard == "zero1"
    opt = (S.zero_init_momentum(params, mesh.dp) if zero1
           else init_momentum(params))
    specs = (S.zero_opt_specs(params) if zero1
             else S.opt_specs(S.param_specs(params)))
    opt = S.shard_arrays(mesh, opt, specs)
    stats: dict = {}
    step = make_sharded_train_step(model, cfg, mesh=mesh, lr=0.05,
                                   n_shards=DP_SHARDS, wire_codec="packed",
                                   opt_shard=opt_shard, stats=stats)
    task = TokenTask(model.a.vocab, DP_SEQ, DP_BATCH, kind="arith")
    out = {"steps": [], "n_params": model.n_params()}
    for i in range(DP_STEPS):
        batch = S.put_batch(mesh, task.batch(i))
        stats.clear()
        C.TRACE = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.time()
        loss = float(step(opt, batch, i)["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        wire: dict = {}
        for what, dtype, shape in C.TRACE:
            key = f"{what}:{str(dtype).removeprefix('torch.')}"
            wire[key] = wire.get(key, 0) + math.prod(shape) * (
                torch.finfo(dtype).bits if dtype.is_floating_point
                else torch.iinfo(dtype).bits) // 8
        C.TRACE = None
        out["steps"].append(dict(
            loss=loss, wall=wall, split=dict(stats), wire=wire,
            launches={k: v for k, v in ops.LAUNCHES.items() if v},
            peak=torch.cuda.max_memory_allocated()))
        assert math.isfinite(loss), f"{tag}: non-finite loss"
        for k in DP_KERNELS:
            assert ops.LAUNCHES[k] > 0, f"{tag}: {k} not launched in step " \
                f"{i + 1}"
    whole = S.gather_arrays(mesh, opt, specs)
    out["names"] = [k for k, _ in tree_keys(params)]
    out["params"] = _digests(flatten(params))
    out["acc"] = _digests(flatten(whole.acc))
    if not zero1 and mesh.dp == 1:          # (a)'s acc in (c)'s layout
        out["acc_flat"] = _digests(flatten(whole.acc), DP_RANKS)
    del model, opt, whole, params, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_worker() -> None:
    """One rank of the dp phase (chip_smoke.py run with CHIP_SMOKE_DP_OUT
    and a torchrun-like environment): runs (b) and (c) in a gloo group on
    the card and writes its results as JSON."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        mesh = make_mesh(DP_RANKS)
        res = {"b": dp_run(mesh, "replicated", f"dp rank {rank} (b)"),
               "c": dp_run(mesh, "zero1", f"dp rank {rank} (c)"),
               "device": torch.cuda.get_device_name(0)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(os.environ["CHIP_SMOKE_DP_OUT"],
                           f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _dp_lines(who: str, run: dict) -> None:
    for i, st in enumerate(run["steps"]):
        sp = st["split"]
        ints = {k: v for k, v in st["wire"].items()
                if not k.endswith(("float32",))}
        floats = {k: v for k, v in st["wire"].items() if k not in ints}
        log(f"[dp] {who} step {i + 1}: loss {st['loss']:.6f}, wall "
            f"{st['wall']:.3f} s (forward+backward {sp['fwd_bwd']:.3f}, "
            f"sync {sp['sync']:.3f}, optimizer {sp['opt']:.3f}), "
            f"{DP_BATCH * DP_SEQ / st['wall']:.1f} tokens/s, peak device "
            f"memory {st['peak'] / 1e9:.2f} GB; integer bytes sent by "
            f"(message, dtype) {ints}, fp32 {floats}; launches "
            f"{st['launches']}")


def phase_dp() -> dict:
    """(a) in this process, then (b) and (c) in DP_RANKS spawned ranks;
    the digests compared.  Returns (a)'s launches summed over its steps."""
    import shutil
    import socket

    from repro_torch.launch.mesh import make_mesh
    t_phase = time.time()
    log(f"[dp] {DP_ARCH} at full width, {DP_DEPTH} of 40 layers, full8 "
        f"native, global batch {DP_BATCH} x {DP_SEQ} tokens (TokenTask "
        f"arith), n_shards {DP_SHARDS}, {DP_STEPS} steps, packed int16 wire")
    a = dp_run(make_mesh(1), "replicated", "dp (a)")
    log(f"[dp] (a) dp=1 in this process ({DP_SHARDS} virtual shards one "
        f"after another, {a['n_params'] / 1e9:.2f} G fp32 params):")
    _dp_lines("(a) dp=1", a)
    out = os.path.join(ROOT, "build", "dp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(DP_RANKS), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), CHIP_SMOKE_DP_OUT=out,
               PYTHONUNBUFFERED="1")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_RANKS)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, DP_TIMEOUT - (time.time() - t0))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0 or r >= len(logs):
            print(logs[r][-6000:] if r < len(logs) else "", flush=True)
            raise AssertionError(f"dp: rank {r} exited with {p.returncode}")
    log(f"[dp] {DP_RANKS} ranks ran (b) and (c) in {time.time() - t0:.1f} "
        f"s (process start and model builds included): their compute on "
        f"the one card, their wire a gloo group over 127.0.0.1 staged "
        f"through host memory (the sync times below are gloo over "
        f"loopback, not an NCCL figure)")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    for r, res in enumerate(ranks):
        for run in ("b", "c"):
            _dp_lines(f"({run}) dp=2 rank {r}" + (
                " zero1" if run == "c" else ""), res[run])
        b, c = res["b"], res["c"]
        same = (sum(x == y for x, y in zip(b["params"], a["params"])),
                sum(x == y for x, y in zip(b["acc"], a["acc"])),
                sum(x == y for x, y in zip(c["params"], a["params"])),
                sum(x == y for x, y in zip(c["acc"], a["acc_flat"])))
        n = len(a["params"])
        log(f"[dp] rank {r} against (a): (b) parameters equal {same[0]}/{n}, "
            f"accumulator equal {same[1]}/{n}; (c) zero1 parameters equal "
            f"{same[2]}/{n}, accumulator (gathered, flat layout) equal "
            f"{same[3]}/{n}")
        if same != (n, n, n, n):
            for run, key in (("b", "params"), ("b", "acc"), ("c", "params"),
                             ("c", "acc")):
                want = a["acc_flat"] if (run, key) == ("c", "acc") else a[key]
                log(f"[dp] rank {r} ({run}) {key} differing: "
                    f"{[nm for nm, x, y in zip(a['names'], res[run][key], want) if x != y]}")
        assert same == (n, n, n, n), f"dp: rank {r} differs from dp=1"
    log(f"[dp] phase {time.time() - t_phase:.1f} s")
    total: dict = {}
    for st in a["steps"]:
        for k, v in st["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # deterministic cuBLAS (read when the first handle is made)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if os.environ.get("CHIP_SMOKE_DP_OUT"):      # a rank of the dp phase
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        dp_worker()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernel run and the plain run of a training step must agree bit
    # for bit: deterministic PyTorch algorithms (the embedding gradient's
    # scatter-add among them) on both
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.time()
    card = phase_build()
    if sys.argv[1:]:    # named phases alone (a short check); no result
        for name in sys.argv[1:]:
            globals()[f"phase_{name}"]()
        log(f"[done] {time.time() - t0:.1f} s (phases {sys.argv[1:]} only)")
        return 0
    phase_kernels()
    runs = {"serve": phase_serve(), "serve_mono": phase_serve_mono(),
            "train": phase_train(), "resnet": phase_resnet()}
    phase_ckpt()
    runs.update(ssm=phase_ssm(), ssm_train=phase_ssm_train(),
                dense=phase_dense(), moe=phase_moe(), modes=phase_modes(),
                encdec=phase_encdec(), hybrid=phase_hybrid(),
                full_depth=phase_full_depth(), dp=phase_dp(), none={})
    for r in RESULTS:
        phase, key = PHASE_OF[r["name"]]
        r["launches"] = runs[phase].get(key, 0)
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": RESULTS}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
