"""Mamba1 (falcon-mamba-7b) and Mamba2 (SSD, the hybrid zamba2-7b's mixer):
the blocks, their init, labels and decode state.

Port of `repro.models.ssm`.  Every projection is a WAGEUBN int8 matmul
(`qdense`: K1 and K2 in native mode; fp32 products of the grid values in
sim, of the values in fp32), the norm is `qrmsnorm` (K4 in native mode),
and the recurrence runs in fp32 over 16-bit-gridded dt, B and C
(`qbn_param` with k_BN; ungridded in fp32), as in the reference.

One op defines the recurrence on every path: `ops.selective_scan` (K9 on
the card) in all three modes, from zero state in "train" and from the
carried state in "chunk" (one prefill page) and "decode" (S = 1).  The
reference runs "train" and "chunk" through a chunked associative scan
(`_sscan_chunked`) and "decode" through one explicit step; both compute
the same function associated differently, so the port's y differs from
the reference's by fp32 reassociation (tests/test_torch_ssm.py states the
normwise bound).  In exchange the port's chunk and decode modes agree
with each other bit for bit: a scan continued from its h_last equals one
longer scan.  Train mode differentiates end to end: the scan's gradient is
K9b (`ops.selective_scan`'s autograd Function), and the quantizers (qdense,
qact, qrmsnorm, qbn_param, qweight's STE) are autograd Functions too.

The depthwise causal convolution is an explicit fp32 sum over the d_conv
taps in tap order (the reference's is an XLA convolution in chunk mode and
an einsum over the window in decode mode): not a kernel, and the same sum
in both modes.  Tensor parallelism (tp_size > 1) is not ported (ROADMAP
Queue 1 item 5).

Mamba2 follows the reference's SSD chunk scan and its order of operations
exactly: per chunk of `scan_chunk` steps (the sequence padded with zeros
to a multiple of it) the intra-chunk scores C.B^T and their product with
the inputs are int8 contractions through `qeinsum` with cfg.e_attn (K1 on
the card; the reference's are XLA integer einsums, and integer dots are
exact), the decay mask m = scores * ldec * dt * causal is put on the Q_A
grid in between, and the inter-chunk term, the carried state's update
and the decays are fp32 `torch.einsum` / `exp` (TF32 refused on the
card), as XLA's are in the reference.  "decode" is one recurrence step on
the dense (B, heads, N, headdim) state.  Mamba2 needs no K9: its
recurrence is the chunk sums above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qact, qdense, qrmsnorm, qweight
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qdense import fp32_matmul, qbn_param, qeinsum
from repro_torch.core.qtensor import qt_carrier
from repro_torch.kernels import ops

from . import layers as L

Tensor = torch.Tensor

LAYER_KEYS = ("ln", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
              "dt_bias", "A_log", "D_skip", "out_proj")


def dt_rank(acfg: ArchConfig) -> int:
    return max(acfg.d_model // 16, 1)


def layer_shapes(acfg: ArchConfig) -> dict:
    """One Mamba1 layer's parameter shapes, in the reference's layouts."""
    d, di, n, r = acfg.d_model, acfg.d_inner, acfg.ssm_state, dt_rank(acfg)
    return {"ln": (d,), "in_proj": (d, 2 * di), "conv_w": (acfg.d_conv, di),
            "conv_b": (di,), "x_proj": (di, r + 2 * n), "dt_proj": (r, di),
            "dt_bias": (di,), "A_log": (di, n), "D_skip": (di,),
            "out_proj": (di, d)}


def causal_conv1d(cfg: QConfig, x: Tensor, w: Tensor, b: Tensor,
                  init: Tensor | None = None) -> Tensor:
    """Depthwise causal conv over seq.  x: (B, S, C), w: (K, C), b: (C,).

    `init` is the K-1 inputs PRECEDING x (the carried window of a chunked
    prefill, or the decode window's first K-1 inputs when S == 1); None
    means zero history (sequence start).  The sum runs over the taps in
    order, in fp32; the weight is its Q_W grid carrier, as the
    reference's."""
    k, s = w.shape[0], x.shape[1]
    wq = qt_carrier(qweight(cfg, w))
    if init is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([init, x], dim=1)
    y = xp[:, 0:s] * wq[0]
    for j in range(1, k):
        y = y + xp[:, j:j + s] * wq[j]
    return y + b


def conv_window_tail(xi: Tensor, prev: Tensor, kc: int) -> Tensor:
    """Next conv window: the last kc inputs of (carried window ++ chunk)."""
    return torch.cat([prev, xi], dim=1)[:, -kc:]


@torch.no_grad()
def mamba1_init_(cfg: QConfig, acfg: ArchConfig, p: dict,
                 gen: torch.Generator) -> dict:
    """In place, one layer's parameters by the reference's `mamba1_init`
    formulas (winit for the projections and the conv, dt log-uniform in
    [1e-3, 1e-1] behind an inverse softplus, A = 1..N, D = 1), drawn from
    `gen`: the same distributions, not the same bits."""
    for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        L.winit_(cfg, p[k], p[k].shape[0], gen)
    p["ln"].fill_(1.0)
    p["conv_b"].zero_()
    u = torch.empty_like(p["dt_bias"]).uniform_(math.log(1e-3),
                                                math.log(1e-1),
                                                generator=gen)
    dt = torch.exp(u)
    p["dt_bias"].copy_(torch.log(torch.expm1(dt)))
    n = p["A_log"].shape[1]
    p["A_log"].copy_(torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=dt.device)).expand_as(
            p["A_log"]))
    p["D_skip"].fill_(1.0)
    return p


def mamba1_labels() -> dict:
    return {"ln": "gamma", "in_proj": "w", "conv_w": "w", "conv_b": "beta",
            "x_proj": "w", "dt_proj": "w", "dt_bias": "exempt",
            "A_log": "exempt", "D_skip": "exempt", "out_proj": "w"}


def mamba1_state_init(acfg: ArchConfig, bsz: int, device="cpu") -> dict:
    di, n = acfg.d_inner, acfg.ssm_state
    return {"conv": torch.zeros((bsz, acfg.d_conv - 1, di), device=device),
            "h": torch.zeros((bsz, di, n), device=device)}


def softplus(x: Tensor) -> Tensor:
    """jax.nn.softplus's formula, logaddexp(x, 0) (F.softplus switches to
    x above a threshold and rounds differently)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba1_block(cfg: QConfig, acfg: ArchConfig, p: dict, x: Tensor,
                 mode: str, state: dict | None = None,
                 tp_size: int = 1) -> tuple[Tensor, dict]:
    """x: (B, S, D).  mode "train" (zero state; returns the conv tail and
    h_last), "chunk" (one chunked-prefill page, seeded from `state`) or
    "decode" (S == 1, state carried per token).  Returns (x + out,
    new state {"conv": (B, K-1, d_inner), "h": (B, d_inner, N)})."""
    if tp_size != 1:
        raise NotImplementedError(
            "tensor-parallel Mamba1 is not ported yet: ROADMAP Queue 1 "
            "item 5")
    if mode not in ("train", "chunk", "decode"):
        raise ValueError(f"unknown Mamba1 mode {mode!r}")
    s = x.shape[1]
    di, n, r = acfg.d_inner, acfg.ssm_state, dt_rank(acfg)
    kc = acfg.d_conv - 1
    h = qact(cfg, "none", qrmsnorm(cfg, x, p["ln"]))
    xz = qdense(cfg, h, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]

    if mode == "train":
        xc = causal_conv1d(cfg, xi, p["conv_w"], p["conv_b"])
        conv_next = F.pad(xi, (0, 0, kc - s, 0)) if s < kc else xi[:, s - kc:]
    else:       # chunk and decode: one sum over the carried window ++ xi
        xc = causal_conv1d(cfg, xi, p["conv_w"], p["conv_b"],
                           init=state["conv"])
        conv_next = conv_window_tail(xi, state["conv"], kc)
    xq = qact(cfg, "silu", xc)                        # int8 payload
    xc = qt_carrier(xq)

    meta = qdense(cfg, xq, p["x_proj"])
    dtr, bs, cs = meta[..., :r], meta[..., r:r + n], meta[..., r + n:]
    dtr = qact(cfg, "none", dtr)
    dt = softplus(qdense(cfg, dtr, p["dt_proj"]) + p["dt_bias"])
    dt = qbn_param(cfg, dt, cfg.k_bn)                 # 16-bit grid
    bs = qbn_param(cfg, bs, cfg.k_bn)
    cs = qbn_param(cfg, cs, cfg.k_bn)
    a_mat = -torch.exp(p["A_log"])                    # (di, N)
    a = torch.exp(dt[..., None] * a_mat)              # (B, S, di, N)
    b = (dt * xc)[..., None] * bs[:, :, None, :]
    h0 = None if mode == "train" else state["h"]
    if mode != "decode" and cfg.scan_dtype == "bf16":
        # the reference's bf16 carriers: a, b, c and h0 cast after the fp32
        # discretisation, y back to fp32, and in chunk mode h_last too (the
        # slot store stays fp32); decode stays fp32
        bf = torch.bfloat16
        y, h_last = ops.selective_scan(
            a.to(bf), b.to(bf), cs.to(bf), None if h0 is None else h0.to(bf))
        y = y.float()
        if mode == "chunk":
            h_last = h_last.float()
    else:       # a bf16 state from a bf16 prefill decodes in fp32
        y, h_last = ops.selective_scan(a, b, cs,
                                       None if h0 is None else h0.float())

    y = y + p["D_skip"] * xc
    y = y * qt_carrier(qact(cfg, "silu", z))
    out = qdense(cfg, qact(cfg, "none", y), p["out_proj"])
    return x + out, {"conv": conv_next, "h": h_last}


# ==========================================================================
# Mamba2 (SSD)
# ==========================================================================

MAMBA2_KEYS = ("ln", "in_proj", "conv_w", "conv_b", "bc_proj", "dt_proj",
               "dt_bias", "A_log", "D_skip", "ssm_norm", "out_proj")


def mamba2_shapes(acfg: ArchConfig) -> dict:
    """One Mamba2 layer's parameter shapes, in the reference's layouts."""
    d, di, n = acfg.d_model, acfg.d_inner, acfg.ssm_state
    hm = di // acfg.headdim
    return {"ln": (d,), "in_proj": (d, 2 * di), "conv_w": (acfg.d_conv, di),
            "conv_b": (di,), "bc_proj": (d, 2 * n), "dt_proj": (d, hm),
            "dt_bias": (hm,), "A_log": (hm,), "D_skip": (hm,),
            "ssm_norm": (di,), "out_proj": (di, d)}


@torch.no_grad()
def mamba2_init_(cfg: QConfig, acfg: ArchConfig, p: dict,
                 gen: torch.Generator) -> dict:
    """In place, one layer's parameters by the reference's `mamba2_init`
    formulas (winit for the projections and the conv, dt log-uniform in
    [1e-3, 1e-1] per head behind an inverse softplus, A_log = 0, D = 1,
    unit norm gains), drawn from `gen`: the same distributions, not the
    same bits."""
    for k in ("in_proj", "conv_w", "bc_proj", "dt_proj", "out_proj"):
        L.winit_(cfg, p[k], p[k].shape[0], gen)
    p["ln"].fill_(1.0)
    p["ssm_norm"].fill_(1.0)
    p["conv_b"].zero_()
    u = torch.empty_like(p["dt_bias"]).uniform_(math.log(1e-3),
                                                math.log(1e-1),
                                                generator=gen)
    p["dt_bias"].copy_(torch.log(torch.expm1(torch.exp(u))))
    p["A_log"].zero_()
    p["D_skip"].fill_(1.0)
    return p


def mamba2_labels() -> dict:
    return {"ln": "gamma", "in_proj": "w", "conv_w": "w", "conv_b": "beta",
            "bc_proj": "w", "dt_proj": "w", "dt_bias": "exempt",
            "A_log": "exempt", "D_skip": "exempt", "ssm_norm": "gamma",
            "out_proj": "w"}


def mamba2_state_init(acfg: ArchConfig, bsz: int, device="cpu") -> dict:
    di, n = acfg.d_inner, acfg.ssm_state
    hm = di // acfg.headdim
    return {"conv": torch.zeros((bsz, acfg.d_conv - 1, di), device=device),
            "h": torch.zeros((bsz, hm, n, acfg.headdim), device=device)}


def _ssd_chunk(cfg: QConfig, s0: Tensor, xcb: Tensor, dtb: Tensor,
               alb: Tensor, bsb: Tensor, csb: Tensor):
    """One chunk of the SSD scan (the reference's scan body): xcb (B, c,
    H, P), dtb and alb (B, c, H), bsb and csb (B, c, N), carried state s0
    (B, H, N, P).  Returns (the state after the chunk, y (B, c, H, P))."""
    cum = torch.cumsum(alb, dim=1)                         # (B, c, H)
    # intra-chunk: the quantized score matmul (the reference's INT8 SSD)
    scores = qeinsum(cfg, "btn,bsn->bts", cfg.e_attn, False, csb, bsb)
    ldec = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                 -60.0, 0.0))
    tt = torch.arange(xcb.shape[1], device=xcb.device)
    causal = (tt[:, None] >= tt[None, :])[None, :, :, None]
    m = scores[:, :, :, None] * ldec * dtb[:, None, :, :] * causal
    m = qact(cfg, "none", m)
    y_in = qeinsum(cfg, "btsh,bshp->bthp", cfg.e_attn, False, m, xcb)
    # inter-chunk
    dec0 = torch.exp(cum)
    y_x = torch.einsum("btn,bhnp->bthp", csb, s0) * dec0[..., None]
    # state update
    dec_end = torch.exp(torch.clamp(cum[:, -1:, :] - cum, -60.0, 0.0))
    wx = xcb * (dtb * dec_end)[..., None]
    s_new = (torch.exp(cum[:, -1])[:, :, None, None] * s0
             + torch.einsum("bsn,bshp->bhnp", bsb, wx))
    return s_new, y_in + y_x


def mamba2_block(cfg: QConfig, acfg: ArchConfig, p: dict, x: Tensor,
                 mode: str, state: dict | None = None,
                 tp_size: int = 1) -> tuple[Tensor, dict]:
    """x: (B, S, D).  mode "train" (zero state; returns the conv tail and
    the last state), "chunk" (one chunked-prefill page, seeded from
    `state`) or "decode" (S == 1); "train" and "chunk" scan chunks of
    acfg.scan_chunk steps.  Returns (x + out, new state {"conv": (B, K-1, d_inner), "h": (B,
    heads, N, headdim)})."""
    if tp_size != 1:
        raise NotImplementedError(
            "tensor-parallel Mamba2 is not ported yet: ROADMAP Queue 1 "
            "item 5")
    if mode not in ("train", "chunk", "decode"):
        raise ValueError(f"unknown Mamba2 mode {mode!r}")
    bsz, s, _ = x.shape
    di, n, pdim = acfg.d_inner, acfg.ssm_state, acfg.headdim
    hm = di // pdim
    kc = acfg.d_conv - 1
    fp32_matmul(x, "Mamba2's SSD einsums")
    h = qact(cfg, "none", qrmsnorm(cfg, x, p["ln"]))
    xz = qdense(cfg, h, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    bc = qdense(cfg, h, p["bc_proj"])
    bs = qbn_param(cfg, bc[..., :n], cfg.k_bn)              # (B, S, N)
    cs = qbn_param(cfg, bc[..., n:], cfg.k_bn)
    dt = softplus(qdense(cfg, h, p["dt_proj"]) + p["dt_bias"])
    dt = qbn_param(cfg, dt, cfg.k_bn)                       # (B, S, H)
    a_neg = -torch.exp(p["A_log"])                          # (H,)

    if mode == "decode":
        xc = causal_conv1d(cfg, xi, p["conv_w"], p["conv_b"],
                           init=state["conv"])
        xh = qt_carrier(qact(cfg, "silu", xc)).reshape(bsz, 1, hm, pdim)
        dt1 = dt[:, 0]                                      # (B, H)
        dec = torch.exp(dt1 * a_neg)[:, :, None, None]
        upd = torch.einsum("bn,bhp->bhnp", bs[:, 0],
                           xh[:, 0] * dt1[..., None])
        ss = dec * state["h"] + upd
        y = torch.einsum("bn,bhnp->bhp", cs[:, 0], ss)[:, None]
        new_state = {"conv": conv_window_tail(xi, state["conv"], kc),
                     "h": ss}
    else:
        init = state["conv"] if mode == "chunk" else None
        xc = causal_conv1d(cfg, xi, p["conv_w"], p["conv_b"], init=init)
        xh = qt_carrier(qact(cfg, "silu", xc)).reshape(bsz, s, hm, pdim)
        alog = dt * a_neg                                   # log decays
        chunk = min(acfg.scan_chunk, s)
        pad = -s % chunk
        xp, dtp, alp, bsp, csp = (F.pad(t, (0, 0) * (t.dim() - 2)
                                        + (0, pad))
                                  for t in (xh, dt, alog, bs, cs))
        ss = (state["h"] if mode == "chunk"
              else x.new_zeros((bsz, hm, n, pdim)))
        ys = []
        for c0 in range(0, s + pad, chunk):
            sl = slice(c0, c0 + chunk)
            ss, yc = _ssd_chunk(cfg, ss, xp[:, sl], dtp[:, sl], alp[:, sl],
                                bsp[:, sl], csp[:, sl])
            ys.append(yc)
        y = torch.cat(ys, 1)[:, :s]
        conv_next = (conv_window_tail(xi, state["conv"], kc)
                     if mode == "chunk" else
                     F.pad(xi, (0, 0, kc - s, 0)) if s < kc
                     else xi[:, s - kc:])
        new_state = {"conv": conv_next, "h": ss}

    y = y + p["D_skip"][:, None] * xh
    y = y.reshape(bsz, -1, di)
    y = qrmsnorm(cfg, y, p["ssm_norm"]) * qt_carrier(qact(cfg, "silu", z))
    out = qdense(cfg, qact(cfg, "none", y), p["out_proj"])
    return x + out, new_state
