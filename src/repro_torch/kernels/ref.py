"""Plain PyTorch versions of the five Hopper kernels of the serving slice.

Each function repeats, operation for operation, the JAX package's oracle
(`repro/kernels/ref.py`) for the same TPU kernel, so that:

  * the CPU tests hold them against the reference package, and
  * `chip_smoke.py` holds each CUDA kernel against them on the card.

`kernels/ops.py` sends a CPU tensor here and a CUDA tensor to the kernel.

Integer dots run in float64: every product of two int8 values is exact and
every sum stays far below 2^53, so the float64 result is the exact integer
(`torch.mm` on int8 returns int8 and wraps, and CUDA has no int32 matmul).
Rounding is half to even (`torch.round`), as `jnp.round` and CUDA `rintf`.

The fp32 divisions, square roots and exponentials of K4 and K6 are taken in
float64 and rounded once to fp32 (`_div32`, `_sqrt32`, `_exp32`), as the
kernels take them: a division or sqrt rounded so is the correctly rounded
fp32 result (53 >= 2 * 24 + 2 bits), so the two sides agree bit for bit on
the card however PyTorch and the kernels' build compile fp32 `expf`, `/`
and `sqrtf`.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

NEG_INF = -1e9   # the attention mask fill (models/layers.py uses the same)


def _int_dot(a8: Tensor, b8: Tensor) -> Tensor:
    """Exact int32 product of integer tensors (batched like torch.matmul)."""
    return torch.matmul(a8.double(), b8.double()).to(torch.int32)


# --------------------------------------------------------------------------
# K1 qmatmul (repro/kernels/qmatmul.py)
# --------------------------------------------------------------------------


def qmatmul(a8: Tensor, b8: Tensor, requant_inv: Tensor | None = None, *,
            lim: float = 127.0) -> Tensor:
    """int8 (.., M, K) x int8 (.., K, N) -> int32 (.., M, N); with
    `requant_inv` the epilogue clip(round(acc * inv), +-lim) -> int8."""
    acc = _int_dot(a8, b8)
    if requant_inv is None:
        return acc
    v = torch.round(acc.float() * requant_inv)
    return torch.clamp(v, -lim, lim).to(torch.int8)


# --------------------------------------------------------------------------
# K2 quantize_fused (repro/kernels/quantize.py)
# --------------------------------------------------------------------------


def quantize(x: Tensor, inv_step: Tensor, lim: float = 127.0) -> Tensor:
    """Payload emission clip(round(x * inv_step), +-lim) -> int8."""
    return torch.clamp(torch.round(x * inv_step), -lim, lim).to(torch.int8)


# --------------------------------------------------------------------------
# K4 ubn_norm (repro/kernels/ubn.py)
# --------------------------------------------------------------------------


def _sum64(x64: Tensor, dim: int) -> Tensor:
    """A float64 sum rounded once to fp32: the statistic the kernels compute
    too, whatever their summation order (x*x is exact in float64)."""
    return torch.sum(x64, dim=dim, keepdim=True).float()


def _div32(a, b: Tensor) -> Tensor:
    """fp32 a / b, correctly rounded (through float64)."""
    a = a.double() if isinstance(a, Tensor) else a
    return (a / b.double()).float()


def _sqrt32(x: Tensor) -> Tensor:
    return torch.sqrt(x.double()).float()


def _exp32(x: Tensor) -> Tensor:
    return torch.exp(x.double()).float()


def _qd(x: Tensor, k: int) -> Tensor:
    s = 2.0 ** (k - 1)
    return torch.round(x * s) / s


def ubn_norm(x: Tensor, gamma: Tensor, beta: Tensor | None = None, *,
             kind: str = "rms", k_mu: int = 16, k_sigma: int = 16,
             k_bn: int = 16, k_gamma: int = 8, k_beta: int = 8,
             eps: float = 2.0 ** -8) -> Tensor:
    """Fused UBN: stats + normalize + the five direct quantizers.

    x: (M, N) f32; stats over N per row ("rms"/"layer") or over M per
    column ("batch").  Returns (M, N) f32 on the k_BN/k_gamma grid.  The
    sums behind mean and mean square are float64 rounded once to fp32 (the
    reference sums in fp32; the difference is within the tests' bound)."""
    dim = 0 if kind == "batch" else -1
    n = torch.tensor(float(x.shape[dim]), device=x.device)
    mean_sq = _div32(_sum64(torch.square(x.double()), dim), n)
    if kind == "rms":
        sigma = _sqrt32(mean_sq)
        xhat = _div32(x, _qd(sigma, k_sigma) + eps)
    else:
        mu = _div32(_sum64(x.double(), dim), n)
        var = mean_sq - torch.square(mu)
        sigma = _sqrt32(torch.clamp(var, min=0.0))
        xhat = _div32(x - _qd(mu, k_mu), _qd(sigma, k_sigma) + eps)
    xhat = _qd(xhat, k_bn)
    y = _qd(gamma.reshape(1, -1), k_gamma) * xhat
    if kind != "rms":
        y = y + _qd(beta.reshape(1, -1), k_beta)
    return y


# --------------------------------------------------------------------------
# K7 page_gather (repro/kernels/page_gather.py)
# --------------------------------------------------------------------------


def page_gather(pages: Tensor, table: Tensor) -> Tensor:
    """pages (P, page, ...) + table (B, NB) -> (B, NB, page, ...), int8.
    Out-of-range ids clamp (id 0 is the trash page dead lanes point at)."""
    return pages[torch.clamp(table.long(), 0, pages.shape[0] - 1)]


# --------------------------------------------------------------------------
# K6 paged_attention (repro/kernels/paged_attention.py)
# --------------------------------------------------------------------------


def _pow2_ceil(m: Tensor) -> Tensor:
    """Smallest power of two >= m; 1 for m <= 0 (exact; kernels/ does not
    import core/, so this repeats core.qfuncs.pow2_ceil)."""
    pos = m > 0
    mant, ex = torch.frexp(torch.where(pos, m, torch.ones_like(m)))
    ex = torch.where(mant == 0.5, ex - 1, ex).clamp(-126, 127)
    p2 = ((ex + 127) << 23).view(torch.float32)
    return torch.where(pos, p2, torch.ones_like(m))


def grid_decompose(x: Tensor, k: int):
    """GridQuantizer decomposition: pow2_ceil(amax) scale with a 2^-24
    floor, payload clip(round(x / step), +-(2^(k-1)-1)) int8.
    Returns (payload, step)."""
    s = torch.clamp(_pow2_ceil(torch.amax(torch.abs(x))), min=2.0 ** -24)
    step = s * 2.0 ** (1 - k)
    lim = 2.0 ** (k - 1) - 1.0
    p8 = torch.clamp(torch.round(x * (1.0 / step)), -lim, lim)
    return p8.to(torch.int8), step


def paged_attention_parts(q8: Tensor, k_pages: Tensor, v_pages: Tensor,
                          table: Tensor, q_pos: Tensor, t_valid,
                          q_scale, k_scale, v_scale, *, sm_scale: float,
                          k_a: int = 8) -> dict:
    """The decode attention with its intermediates: softmax stats m and l
    (B, H), the probability payload p8 (B, H, T) int8 and the output.

    q8: (B, H, dh) int8 (one decode token per lane); k_pages/v_pages:
    (P, page, KV, dh) int8; table: (B, NB) page ids (0 = trash page);
    q_pos: (B,) positions; t_valid: bound on valid positions; scales:
    pow2 payload scales (0-d tensors); sm_scale: 1/sqrt(dh).
    """
    p_cnt, page, kv, dh = k_pages.shape
    b, nb = table.shape
    h = q8.shape[1]
    g = h // kv
    t = nb * page
    tb = torch.clamp(table.long(), 0, p_cnt - 1)
    k8 = k_pages[tb].reshape(b, t, kv, dh)
    v8 = v_pages[tb].reshape(b, t, kv, dh)
    qr = q8.reshape(b, kv, g, dh)
    sc = _int_dot(qr, k8.permute(0, 2, 3, 1)).float() \
        * (q_scale * k_scale)                          # (B, KV, G, T)
    sc = sc * sm_scale
    kp = torch.arange(t, device=q8.device)
    mask = (kp[None, :] <= q_pos.reshape(-1, 1)) & (kp[None, :] < t_valid)
    sc = torch.where(mask[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1, keepdim=True)
    pex = _exp32(sc - m)
    l = _sum64(pex.double(), -1)
    pn = _div32(pex, l)
    s_ = 2.0 ** (k_a - 1)
    pg = torch.round(pn * s_) / s_                     # qprobs (Q_A grid)
    p8, step = grid_decompose(pg, k_a)                 # ONE batch-global amax
    out = _int_dot(p8, v8.permute(0, 2, 1, 3)).float() \
        * (step * v_scale)                             # (B, KV, G, dh)
    return {"m": m.reshape(b, h), "l": l.reshape(b, h),
            "p8": p8.reshape(b, h, t), "out": out.reshape(b, h, dh)}


def paged_attention(q8: Tensor, k_pages: Tensor, v_pages: Tensor,
                    table: Tensor, q_pos: Tensor, t_valid, q_scale, k_scale,
                    v_scale, *, sm_scale: float, k_a: int = 8) -> Tensor:
    """Fused paged decode attention -> (B, H, dh) f32 pre-Q_A output."""
    return paged_attention_parts(q8, k_pages, v_pages, table, q_pos,
                                 t_valid, q_scale, k_scale, v_scale,
                                 sm_scale=sm_scale, k_a=k_a)["out"]
