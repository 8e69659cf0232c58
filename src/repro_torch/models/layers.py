"""Model building blocks of the serving slice: RoPE, paged int8 attention
(chunked prefill and decode), the int8 KV page writes, SwiGLU and the norm.

Port of the serving half of `repro.models.layers`, with the reference's
layouts at every public function: activations (B, S, H, dh), KV pages
(P, page, KV, dh) int8, page tables (B, NB).  Attention follows the
paper's scheme as the reference adapts it: q.k and p.v are int8 x int8
integer dots, softmax runs in fp32, probabilities go onto the k_A grid.

Page writes update the arena IN PLACE (the reference returns new arrays;
eager PyTorch saves the copy per step).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qact, qdense, qlayernorm, qprobs, qrmsnorm
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qdense import _fwd_quantize, _qt_contract
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops

Tensor = torch.Tensor

NEG_INF = -1e9


# --------------------------------------------------------------------------
# init (paper Eq. 9: MSRA + k_WU-grid discretization)
# --------------------------------------------------------------------------


def winit_(cfg: QConfig, w: Tensor, fan_in: int,
           generator: torch.Generator) -> Tensor:
    """In place: w <- clip(Q(normal / sqrt(fan_in), k_WU), +-(1 - d(k_WU))).

    The reference's `winit` formula, drawn from a torch.Generator: the same
    distribution as the reference's jax.random weights, not the same bits."""
    w.normal_(generator=generator).div_(math.sqrt(fan_in))
    s = 2.0 ** (cfg.k_wu - 1)
    lim = 1.0 - 2.0 ** (1 - cfg.k_wu)
    return w.mul_(s).round_().div_(s).clamp_(-lim, lim)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope(x: Tensor, pos: Tensor, theta: float = 1e4) -> Tensor:
    """x: (..., S, H, dh); pos: (S,) int, or any shape that broadcasts
    against x's leading dims once a head axis is added ((B, 1) for one
    decode token per lane)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = pos.float()[..., None] * freqs                   # pos.shape+(half,)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _heads_contract(a8: Tensor, b8: Tensor) -> Tensor:
    """Integer dot batched over (B, KV): a8 (B, KV, M, K) x b8 (B, KV, K, N)
    -> int32 (B, KV, M, N) through one batched qmatmul launch."""
    b, kv = a8.shape[:2]
    out = ops.qmatmul(a8.reshape(b * kv, *a8.shape[2:]),
                      b8.reshape(b * kv, *b8.shape[2:]))
    return out.reshape(b, kv, *out.shape[1:])


def _scores(q: QTensor, k: QTensor) -> Tensor:
    """'bskgd,btkd->bskgt' on payloads: q (B,S,KV,G,dh), k (B,T,KV,dh)."""
    b, s, kv, g, dh = q.shape

    def contract(q8, k8):
        a = q8.permute(0, 2, 1, 3, 4).reshape(b, kv, s * g, dh)
        acc = _heads_contract(a, k8.permute(0, 2, 3, 1))   # (B,KV,S*G,T)
        return acc.reshape(b, kv, s, g, -1).permute(0, 2, 1, 3, 4)

    return _qt_contract(contract, q, k)


def _attn_out(p: QTensor, v: QTensor) -> Tensor:
    """'bskgt,btkd->bskgd' on payloads: p (B,S,KV,G,T), v (B,T,KV,dh)."""
    b, s, kv, g, t = p.shape

    def contract(p8, v8):
        a = p8.permute(0, 2, 1, 3, 4).reshape(b, kv, s * g, t)
        acc = _heads_contract(a, v8.permute(0, 2, 1, 3))   # (B,KV,S*G,dh)
        return acc.reshape(b, kv, s, g, -1).permute(0, 2, 1, 3, 4)

    return _qt_contract(contract, p, v)


def paged_decode_attention(cfg: QConfig, q: QTensor, k_pages: Tensor,
                           v_pages: Tensor, table: Tensor, k_scale, v_scale,
                           *, q_pos: Tensor, t_valid) -> QTensor:
    """Single-step attention against the PAGED int8 KV cache (one layer):
    the fused two-pass paged_attention kernel (K6) streams the lanes'
    pages, so the gathered KV never exists.  q: (B, 1, H, dh) QTensor;
    k_pages/v_pages: (P, page, KV, dh) int8; table: (B, NB)."""
    b, s, h, dh = q.shape
    if s != 1:
        raise ValueError(f"decode attention takes one token per lane, got {s}")
    out = ops.paged_attention(
        q.data.reshape(b, h, dh), k_pages, v_pages, table, q_pos, t_valid,
        q.scale, k_scale, v_scale, sm_scale=1.0 / math.sqrt(dh), k_a=cfg.k_a)
    return qact(cfg, "none", out.reshape(b, s, h, dh))


def paged_prefill_attention(cfg: QConfig, q: QTensor, k_pages: Tensor,
                            v_pages: Tensor, table: Tensor, k_scale, v_scale,
                            *, q_pos: Tensor) -> QTensor:
    """One PAGE of prefill attention against the paged int8 cache (one
    layer, one lane): the chunked-prefill data path.

    q: (1, S, H, dh) QTensor, S = page_size tokens whose KV page was just
    written; q_pos: (S,) their positions.  The lane's pages are gathered
    (page_gather, K7) and every position past q_pos is masked, so stale
    arena contents never leak in.  Every amax spans this lane's page only.
    """
    b, s, h, dh = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    nb = table.shape[1]
    g = h // kv
    k8 = ops.page_gather(k_pages, table).reshape(b, nb * page, kv, dh)
    v8 = ops.page_gather(v_pages, table).reshape(b, nb * page, kv, dh)
    qr = q.reshape(b, s, kv, g, dh)
    sc = _scores(qr, QTensor(k8, k_scale, 8)) * (1.0 / math.sqrt(dh))
    kp = torch.arange(nb * page, device=sc.device)
    mask = q_pos[:, None] >= kp[None, :]                 # (S, T) causal+valid
    sc = torch.where(mask[None, :, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = qprobs(cfg, p / torch.sum(p, dim=-1, keepdim=True))
    pq = _fwd_quantize(cfg, p, cfg.k_a)                  # one amax, grid
    out = _attn_out(pq, QTensor(v8, v_scale, 8)).reshape(b, s, h, dh)
    return qact(cfg, "none", out)


# --------------------------------------------------------------------------
# int8 KV pages
# --------------------------------------------------------------------------


def kv_quantize(x: QTensor, step) -> Tensor:
    """Payload on the int8 cache grid: a pow2 requantize of the QTensor's
    payload saturating to int8 (no amax pass)."""
    return x.requantize(step, k=8)


def page_scatter_token(pages: Tensor, table: Tensor, pos: Tensor,
                       tok: Tensor) -> None:
    """In place: write one decode step's KV token of each lane into its page
    slot, pages[table[b, pos//page], pos % page] <- tok[b].

    pages: (P, page, KV, dh) int8; table: (B, NB); pos: (B,); tok:
    (B, KV, dh) int8.  Dead lanes all point at the trash page 0, so several
    lanes may name one slot; the LAST lane naming a slot wins, as in the
    reference's scatter, and every lane writing that slot writes the
    winner's token, so the result does not depend on write order."""
    page = pages.shape[1]
    pos = pos.long()
    blk, off = pos // page, pos % page
    pid = torch.gather(table.long(), 1, blk[:, None])[:, 0]
    slot = pid * page + off
    same = slot[:, None] == slot[None, :]                  # (B, B)
    lanes = torch.arange(slot.shape[0], device=slot.device)
    last = torch.amax(torch.where(same, lanes[None, :], -1), dim=1)
    pages.index_put_((pid, off), tok[last])


def page_write(pages: Tensor, pid: Tensor, block: Tensor) -> None:
    """In place: whole-page KV write pages[pid] <- block (page, KV, dh);
    pid 0 (the trash page) absorbs masked-out chunk pages."""
    pages.index_copy_(0, pid.reshape(1).long(), block[None])


# --------------------------------------------------------------------------
# MLP / norm
# --------------------------------------------------------------------------


def swiglu(cfg: QConfig, x, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
           act: str = "silu") -> Tensor:
    gate = qact(cfg, act, qdense(cfg, x, w_gate))
    up = qact(cfg, "none", qdense(cfg, x, w_up))
    h = qact(cfg, "none", gate * up)
    return qdense(cfg, h, w_down)


def norm(cfg: QConfig, kind: str, x, gamma: Tensor,
         beta: Tensor | None = None) -> Tensor:
    if kind == "rmsnorm":
        return qrmsnorm(cfg, x, gamma)
    return qlayernorm(cfg, x, gamma, beta)
