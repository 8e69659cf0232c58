"""Model building blocks: RoPE, chunked online-softmax attention for
training and monolithic prefill (native: the fused flash kernel forward,
autograd of the plain chunked body backward; sim and fp32: the plain
chunked body), int8-KV attention for serving (chunked
prefill pages, and decode against the pages fused or gathered, or against
a dense cache), the int8 KV writes, SwiGLU, the enc-dec's MLP, the norm and
the loss's target gather.

Port of `repro.models.layers`, with the reference's layouts at every
public function: activations (B, S, H, dh), KV pages (P, page, KV, dh)
int8, page tables (B, NB).  Attention follows the paper's scheme as the
reference adapts it: q.k and p.v are int8 x int8 integer dots through
qeinsum (error quantizer cfg.e_attn on the way back), softmax runs in fp32,
probabilities go onto the k_A grid.

Page writes update the arena IN PLACE (the reference returns new arrays;
eager PyTorch saves the copy per step).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import qact, qdense, qlayernorm, qprobs, qrmsnorm
from repro_torch.core.numerics import div32, exp32, sum64
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qdense import qeinsum
from repro_torch.core.qtensor import (QTensor, qt_carrier, save_qtensors,
                                      saved_qtensors)
from repro_torch.kernels import ops

Tensor = torch.Tensor

NEG_INF = -1e9


# --------------------------------------------------------------------------
# init (paper Eq. 9: MSRA + k_WU-grid discretization)
# --------------------------------------------------------------------------


def winit_(cfg: QConfig, w: Tensor, fan_in: int,
           generator: torch.Generator) -> Tensor:
    """In place: w <- clip(Q(normal / sqrt(fan_in), k_WU), +-(1 - d(k_WU)))
    (fp32 mode: normal / sqrt(fan_in), off the grid).

    The reference's `winit` formula, drawn from a torch.Generator: the same
    distribution as the reference's jax.random weights, not the same bits."""
    w.normal_(generator=generator).div_(math.sqrt(fan_in))
    if not cfg.quantize:
        return w
    s = 2.0 ** (cfg.k_wu - 1)
    lim = 1.0 - 2.0 ** (1 - cfg.k_wu)
    return w.mul_(s).round_().div_(s).clamp_(-lim, lim)


def maybe_remat(acfg, fn):
    """`fn` checkpointed when acfg.remat is "full" and autograd records
    (the reference's `maybe_remat`: its activations are not kept, the
    backward runs `fn` again), else `fn` itself (remat "none", and the
    serving paths under no_grad).  The forward draws no random numbers,
    so the recompute gives the first run's bits without restoring the RNG
    state; non-reentrant, so gradients reach the tensors `fn` closes over
    (the decoder's encoder output, the hybrid's shared block).  The
    recompute launches the forward's kernels again: `ops.LAUNCHES` of a
    training step count them."""
    if acfg.remat != "full":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


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


def target_logit(logits: Tensor, labels: Tensor) -> Tensor:
    """The labels' logits as a masked sum over the vocab (the reference's
    formula, which partitions over a vocab-sharded tensor)."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    mask = iota == labels[..., None].long()
    return torch.sum(torch.where(mask, logits, 0.0), dim=-1)


def _attn_scores(cfg: QConfig, q, k) -> Tensor:
    """(B,S,KV,G,dh) x (B,T,KV,dh) -> (B,S,KV,G,T) through qeinsum (one
    batched qmatmul over (B, KV)); QTensor operands (the int8 KV cache)
    feed their payloads with no re-decomposition."""
    return qeinsum(cfg, "bskgd,btkd->bskgt", cfg.e_attn, False, q, k)


def _attn_out(cfg: QConfig, p, v) -> Tensor:
    """(B,S,KV,G,T) x (B,T,KV,dh) -> (B,S,KV,G,dh) through qeinsum."""
    return qeinsum(cfg, "bskgt,btkd->bskgd", cfg.e_attn, False, p, v)


def _payload8(x) -> bool:
    """Single-plane int8 QTensor: what the fused attention kernel
    consumes (its carrier, when present, takes the gradient)."""
    return (isinstance(x, QTensor) and x.lo is None
            and x.data.dtype == torch.int8)


def chunked_attention(cfg: QConfig, q, k, v, *, causal: bool,
                      q_pos: Tensor, k_pos: Tensor, q_chunk: int = 1024,
                      kv_chunk: int = 512):
    """Memory-efficient online-softmax attention (flash style).

    q: (B, S, H, dh) on the activation grid; k/v: (B, T, KV, dh).  Returns
    (B, S, H, dh), the normalized output on the activation grid.  Native
    int8 payload operands (what qact makes there) take the fused route: the
    flash kernel (K5) forward, autograd of `_chunked_core` backward; sim and
    fp32 (fp32 operands) take `_chunked_core` whole.  The
    reference also asks a TPU VMEM budget (`flash_attention_fits`) here; a
    Hopper block's memory does not grow with the chunk, so the port does
    not: the two routes give the same numbers by the reference's contract.
    """
    if cfg.native and all(map(_payload8, (q, k, v))):
        out = _FlashFused.apply(q.carrier, k.carrier, v.carrier, cfg, causal,
                                min(q_chunk, q.shape[1]),
                                min(kv_chunk, k.shape[1]), q, k, v, q_pos,
                                k_pos)
        return qact(cfg, "none", out)
    return qact(cfg, "none", _chunked_core(
        cfg, q, k, v, causal=causal, q_pos=q_pos, k_pos=k_pos,
        q_chunk=q_chunk, kv_chunk=kv_chunk))


def _pad_seq(x: Tensor, n: int, value=0) -> Tensor:
    """Pad dim 1 (the sequence) of x by n entries of `value`."""
    if not n:
        return x
    shape = list(x.shape)
    shape[1] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], 1)


def _chunked_core(cfg: QConfig, q, k, v, *, causal: bool, q_pos: Tensor,
                  k_pos: Tensor, q_chunk: int, kv_chunk: int) -> Tensor:
    """Plain online-softmax body on the fp32 grid carriers (pre-Q_A
    output), the fused route's backward ground truth: the per-chunk
    qeinsums re-enter the integer path and apply Q_E2 (cfg.e_attn) on the
    way back (Alg. 2)."""
    q, k, v = qt_carrier(q), qt_carrier(k), qt_carrier(v)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, t)
    s_orig = s
    sp, tp = -s % q_chunk, -t % kv_chunk
    q = _pad_seq(q, sp)
    q_pos = _pad_seq(q_pos[None], sp)[0]
    k, v = _pad_seq(k, tp), _pad_seq(v, tp)
    k_pos = _pad_seq(k_pos[None], tp)[0]
    k_valid = _pad_seq(torch.ones((1, t), dtype=torch.bool,
                                  device=k.device), tp, False)[0]
    s, t = s + sp, t + tp
    q = q.reshape(b, s, kv, g, dh)
    outs = []
    for iq in range(s // q_chunk):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qi, qp = q[:, rows], q_pos[rows]
        m = torch.full(qi.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(qi.shape, dtype=torch.float32, device=q.device)
        for j in range(t // kv_chunk):
            cols = slice(j * kv_chunk, (j + 1) * kv_chunk)
            sc = _attn_scores(cfg, qi, k[:, cols]) * scale
            mask = k_valid[cols][None, :]
            if causal:
                mask = (qp[:, None] >= k_pos[cols][None, :]) & mask
            sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            p = qprobs(cfg, p)                        # Q_A on probabilities
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            o = o * alpha[..., None] + _attn_out(cfg, p, v[:, cols])
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-9)[..., None])
    out = torch.cat(outs, 1).reshape(b, s, h, dh)
    return out[:, :s_orig]


class _FlashFused(torch.autograd.Function):
    """Fused-forward attention: pad the payloads to chunk multiples and run
    the flash kernel (K5); backward = autograd of `_chunked_core` at the
    saved payloads (the reference's `_flash_fused` custom_vjp)."""

    @staticmethod
    def forward(ctx, qc, kc, vc, cfg, causal, q_chunk, kv_chunk, q, k, v,
                q_pos, k_pos):
        ctx.args = (cfg, causal, q_chunk, kv_chunk)
        ctx.ks = save_qtensors(ctx, q, k, v)
        ctx.pos = (q_pos, k_pos)
        s, t, dh = q.shape[1], k.shape[1], q.shape[3]
        sp, tp = -s % q_chunk, -t % kv_chunk
        ones = torch.ones((1, t), dtype=torch.int32, device=k.data.device)
        out = ops.flash_attention(
            _pad_seq(q.data, sp), _pad_seq(k.data, tp), _pad_seq(v.data, tp),
            _pad_seq(q_pos[None], sp)[0], _pad_seq(k_pos[None], tp)[0],
            _pad_seq(ones, tp)[0], q.scale, k.scale, v.scale,
            causal=causal, sm_scale=1.0 / math.sqrt(dh), q_chunk=q_chunk,
            kv_chunk=kv_chunk, k_a=cfg.k_a)
        return out[:, :s]

    @staticmethod
    def backward(ctx, ct):
        cfg, causal, q_chunk, kv_chunk = ctx.args
        q, k, v = saved_qtensors(ctx, ctx.ks)
        q_pos, k_pos = ctx.pos
        ins = [t.dequantize().requires_grad_() for t in (q, k, v)]
        qw, kw, vw = (QTensor(t.data, t.scale, t.k, carrier=c)
                      for t, c in zip((q, k, v), ins))
        with torch.enable_grad():
            out = _chunked_core(cfg, qw, kw, vw, causal=causal, q_pos=q_pos,
                                k_pos=k_pos, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
            dq, dk, dv = torch.autograd.grad(out, ins, ct)
        return (dq, dk, dv) + (None,) * 9


def decode_attention(cfg: QConfig, q, k, v, *, q_pos: Tensor,
                     t_valid) -> QTensor:
    """Single-step attention against a full int8 KV cache.

    q: (B, 1, H, dh); k/v: (B, T, KV, dh) QTensors straight from the int8
    cache (`kv_qtensor`: their payloads feed the integer dots, K1, with no
    dequantize round trip).  Positions past q_pos or at/after t_valid are
    masked; the normalized probabilities go onto the k_A grid.  The exp,
    the row sum and the division are taken in float64 and rounded once, as
    the fused route (K6 and its plain version) takes them, so the two
    routes give the same bits (the reference's fp32 ones are within an
    ulp)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    qr = q.reshape(b, s, kv, h // kv, dh)
    sc = _attn_scores(cfg, qr, k) * (1.0 / math.sqrt(dh))   # (B,1,KV,G,T)
    kp = torch.arange(t, device=sc.device)
    mask = (kp[None, :] <= q_pos[:, None]) & (kp[None, :] < t_valid)
    sc = torch.where(mask[:, None, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = exp32(sc - m)
    p = qprobs(cfg, div32(p, sum64(p.double(), -1)))
    out = _attn_out(cfg, p, v).reshape(b, s, h, dh)
    return qact(cfg, "none", out)


def paged_decode_attention(cfg: QConfig, q, k_pages: Tensor,
                           v_pages: Tensor, table: Tensor, k_scale, v_scale,
                           *, q_pos: Tensor, t_valid) -> QTensor:
    """Single-step attention against the PAGED int8 KV cache (one layer).
    q: (B, 1, H, dh) QTensor; k_pages/v_pages: (P, page, KV, dh) int8;
    table: (B, NB).

    In native mode with `cfg.fuse_kernels` and a single-token int8 query
    the fused two-pass paged_attention kernel (K6) streams the lanes'
    pages, so the gathered KV never exists.  Otherwise (sim and fp32 too)
    the unfused route gathers each pool (one page_gather, K7, per pool, as
    the reference does) and runs `decode_attention`: in native mode the
    same numbers.  (The reference also asks a TPU
    VMEM budget, `paged_attention_fits`; K6 sweeps any context, so the port
    does not.)"""
    b, s, h, dh = q.shape
    if cfg.native and cfg.fuse_kernels and s == 1 and _payload8(q):
        out = ops.paged_attention(
            q.data.reshape(b, h, dh), k_pages, v_pages, table, q_pos,
            t_valid, q.scale, k_scale, v_scale, sm_scale=1.0 / math.sqrt(dh),
            k_a=cfg.k_a)
        return qact(cfg, "none", out.reshape(b, s, h, dh))
    t = table.shape[1] * k_pages.shape[1]
    k8 = ops.page_gather(k_pages, table).reshape(b, t, *k_pages.shape[2:])
    v8 = ops.page_gather(v_pages, table).reshape(b, t, *v_pages.shape[2:])
    return decode_attention(cfg, q, kv_qtensor(k8, k_scale),
                            kv_qtensor(v8, v_scale), q_pos=q_pos,
                            t_valid=t_valid)


def paged_prefill_attention(cfg: QConfig, q: QTensor, k_pages: Tensor,
                            v_pages: Tensor, table: Tensor, k_scale, v_scale,
                            *, q_pos: Tensor) -> QTensor:
    """One PAGE of prefill attention against the paged int8 cache (one
    layer, one lane): the chunked-prefill data path.

    q: (1, S, H, dh) QTensor, S = page_size tokens whose KV page was just
    written; q_pos: (S,) their positions.  The lane's K and V pages are
    gathered in one launch (page_gather, K7), head-major, so the two
    contractions read each head's positions as views; every position past
    q_pos is masked, so stale arena contents never leak in.  Every amax
    spans this lane's page only.
    """
    b, s, h, dh = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    nb = table.shape[1]
    g = h // kv
    k8, v8 = ops.page_gather(k_pages, table, pages2=v_pages, head_major=True)
    k8, v8 = k8.permute(0, 2, 1, 3), v8.permute(0, 2, 1, 3)  # (b, T, KV, dh)
    qr = q.reshape(b, s, kv, g, dh)
    sc = _attn_scores(cfg, qr, QTensor(k8, k_scale, 8)) \
        * (1.0 / math.sqrt(dh))
    kp = torch.arange(nb * page, device=sc.device)
    mask = q_pos[:, None] >= kp[None, :]                 # (S, T) causal+valid
    sc = torch.where(mask[None, :, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = qprobs(cfg, p / torch.sum(p, dim=-1, keepdim=True))
    # p is decomposed once, one amax over the block (grid quantizer)
    out = _attn_out(cfg, p, QTensor(v8, v_scale, 8)).reshape(b, s, h, dh)
    return qact(cfg, "none", out)


# --------------------------------------------------------------------------
# int8 KV pages
# --------------------------------------------------------------------------


def kv_quantize(x, step) -> Tensor:
    """Payload on the int8 cache grid.  A QTensor (native) requantizes
    payload to payload, a pow2 shift saturating to int8 (no amax pass); an
    fp32 tensor (sim, fp32) is decomposed onto the grid by the quantize
    kernel (K2), clip(round(x / step), +-127) as the reference writes it
    (`step` is a power of two, so x * (1 / step) is the same value)."""
    if isinstance(x, QTensor):
        return x.requantize(step, k=8)
    return ops.quantize(x, 1.0 / step, lim=127.0)


def kv_qtensor(x8: Tensor, step) -> QTensor:
    """Wrap an int8 cache slice as a QTensor on the cache grid."""
    return QTensor(x8, step, 8)


def kv_cache_init(n_layers: int, b: int, t: int, kv: int, dh: int,
                  device) -> dict:
    """A dense int8 cache {"k", "v": (L, B, T, KV, dh), "k_scale",
    "v_scale": (L,) at 2^-7, "pos": (B,)}, the reference's layout."""
    i8 = dict(dtype=torch.int8, device=device)
    return {"k": torch.zeros((n_layers, b, t, kv, dh), **i8),
            "v": torch.zeros((n_layers, b, t, kv, dh), **i8),
            "k_scale": torch.full((n_layers,), 2.0 ** -7, device=device),
            "v_scale": torch.full((n_layers,), 2.0 ** -7, device=device),
            "pos": torch.zeros((b,), dtype=torch.int32, device=device)}


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


def mlp(cfg: QConfig, x, w_up: Tensor, w_down: Tensor,
        act: str = "gelu") -> Tensor:
    """The enc-dec's two-matrix MLP: Q_A(act(x @ w_up)) @ w_down."""
    h = qact(cfg, act, qdense(cfg, x, w_up))
    return qdense(cfg, h, w_down)


def norm(cfg: QConfig, kind: str, x, gamma: Tensor,
         beta: Tensor | None = None) -> Tensor:
    if kind == "rmsnorm":
        return qrmsnorm(cfg, x, gamma)
    return qlayernorm(cfg, x, gamma, beta)
