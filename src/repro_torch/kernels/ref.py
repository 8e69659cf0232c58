"""Plain PyTorch versions of the Hopper kernels of the port.

Each function repeats, operation for operation, the JAX package's oracle
(`repro/kernels/ref.py`) for the same TPU kernel, so that:

  * the CPU tests hold them against the reference package, and
  * `chip_smoke.py` holds each CUDA kernel against them on the card.

`kernels/ops.py` sends a CPU tensor here and a CUDA tensor to the kernel.

Integer dots run in float64: every product of two int8 or int16 payloads
is exact and every sum stays far below 2^53, so the float64 result is the
exact integer (`torch.mm` on int8 returns int8 and wraps, and CUDA has no
int32 matmul).  It is then wrapped to int32 as the reference's int32
accumulation wraps: an int16 error plane (e2_16) against int8 can pass 2^31
once the contraction is longer than 516.
Rounding is half to even (`torch.round`), as `jnp.round` and CUDA `rintf`.

The fp32 divisions, square roots and exponentials of K4 and K6 are taken in
float64 and rounded once to fp32 (`core/numerics.py`), as the
kernels take them: a division or sqrt rounded so is the correctly rounded
fp32 result (53 >= 2 * 24 + 2 bits), so the two sides agree bit for bit on
the card however PyTorch and the kernels' build compile fp32 `expf`, `/`
and `sqrtf`.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import div32 as _div32
from repro_torch.core.numerics import exp32 as _exp32
from repro_torch.core.numerics import sqrt32 as _sqrt32
from repro_torch.core.numerics import sum64 as _sum64

Tensor = torch.Tensor

NEG_INF = -1e9   # the attention mask fill (models/layers.py uses the same)


def _int_dot(a8: Tensor, b8: Tensor) -> Tensor:
    """Integer product of integer tensors (batched like torch.matmul),
    accumulated as int32 with two's-complement wrap."""
    acc = torch.matmul(a8.double(), b8.double()).to(torch.int64)
    return (torch.remainder(acc + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


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
# K8 cq_stochastic (repro/kernels/quantize.py)
# --------------------------------------------------------------------------


def cq_stochastic(x: Tensor, bits: Tensor, inv_step: Tensor,
                  dr: float = 128.0) -> Tensor:
    """Stochastic CQ payload (Eq. 7): clip(floor(v) + [u < v - floor(v)],
    +-(dr - 1)) -> int16, v = x * inv_step (one fp32 multiply).

    `bits` holds the uint32 random bits as the int32 tensor of the same
    pattern (PyTorch has few uint32 ops); u is their low 24 bits, which
    masking leaves non-negative, times 2^-24 (exact), in [0, 1)."""
    v = x * inv_step
    f = torch.floor(v)
    u = (bits & 0xFFFFFF).float() * 2.0 ** -24
    y = f + (u < (v - f)).float()
    return torch.clamp(y, -dr + 1.0, dr - 1.0).to(torch.int16)


# --------------------------------------------------------------------------
# K3 bwd_dgrad / bwd_wgrad (repro/kernels/backward.py)
# --------------------------------------------------------------------------


def bwd_error_planes(g: Tensor, inv: Tensor, *, mode: str, k: int) -> tuple:
    """Q_E payload plane(s) of an error tensor, the fused-prologue formula:
    "affine" one clip(round(g * inv), +-lim) plane (int8 for k <= 8, else
    int16); "flag" the two disjoint-support int8 planes of Eq. 17."""
    lim = 2.0 ** (k - 1) - 1.0
    dt = torch.int8 if k <= 8 else torch.int16
    if mode == "affine":
        return (torch.clamp(torch.round(g * inv), -lim, lim).to(dt),)
    if mode != "flag":
        raise ValueError(f"unknown prologue mode {mode!r}")
    n = g * inv
    nlo = torch.round(n * 2.0 ** (k - 1))
    isbig = (torch.abs(n) >= 1.0) | (torch.abs(nlo) >= 2.0 ** (k - 1))
    zero = torch.zeros_like(n)
    hi = torch.where(isbig, torch.clamp(torch.round(n), -lim, lim), zero)
    lo = torch.where(isbig, zero, torch.clamp(nlo, -lim, lim))
    return (hi.to(dt), lo.to(dt))


def _plane_sum(dots, scal: Tensor) -> Tensor:
    y = None
    for acc, s in zip(dots, (scal[1], scal[2])):
        t = acc.float() * s
        y = t if y is None else y + t
    return y


def dgrad(g: Tensor, b8: Tensor, scal: Tensor, *, mode: str,
          k: int) -> Tensor:
    """da (M, K) = sum_planes einsum('mn,kn->mk', Qe(g), b8)_int32 * s_plane;
    scal = [inv, s1, s2] (f32, on the device)."""
    planes = bwd_error_planes(g, scal[0], mode=mode, k=k)
    return _plane_sum((_int_dot(q, b8.t()) for q in planes), scal)


def wgrad(a8: Tensor, g: Tensor, scal: Tensor, *, mode: str,
          k: int) -> Tensor:
    """db (K, N) = sum_planes einsum('mk,mn->kn', a8, Qe(g))_int32 * s_plane."""
    planes = bwd_error_planes(g, scal[0], mode=mode, k=k)
    return _plane_sum((_int_dot(a8.t(), q) for q in planes), scal)


# --------------------------------------------------------------------------
# K4 ubn_norm (repro/kernels/ubn.py)
# --------------------------------------------------------------------------


def _qd(x: Tensor, k: int) -> Tensor:
    s = 2.0 ** (k - 1)
    return torch.round(x * s) / s


def ubn_norm(x: Tensor, gamma: Tensor, beta: Tensor | None = None, *,
             kind: str = "rms", k_mu: int = 16, k_sigma: int = 16,
             k_bn: int = 16, k_gamma: int = 8, k_beta: int = 8,
             eps: float = 2.0 ** -8) -> Tensor:
    """Fused UBN: stats + normalize + the five direct quantizers.

    x: (M, N) f32; stats over N per row ("rms"/"layer") or over M per
    column ("batch": x is the NHWC activation flattened to (N*H*W, C)).
    Returns (M, N) f32 on the k_BN/k_gamma grid.  The sums behind mean and
    mean square are float64 rounded once to fp32 (the reference sums in
    fp32; the difference is within the tests' bound)."""
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


# --------------------------------------------------------------------------
# K5 flash_attention (repro/kernels/paged_attention.py)
# --------------------------------------------------------------------------


def _heads_dot(a8: Tensor, b8: Tensor, swap: bool) -> Tensor:
    """Per-(batch, kv-head) integer dots.  swap=False (scores): a8
    (b, qc, kv, g, dh) x b8 (b, kc, kv, dh) -> (b, qc, kv, g, kc);
    swap=True (p.v): a8 (b, qc, kv, g, kc) x b8 (b, kc, kv, dh)
    -> (b, qc, kv, g, dh)."""
    b, qc, kv, g, n = a8.shape
    lhs = a8.permute(0, 2, 1, 3, 4).reshape(b, kv, qc * g, n)
    rhs = b8.permute(0, 2, 1, 3) if swap else b8.permute(0, 2, 3, 1)
    acc = _int_dot(lhs, rhs)
    return acc.reshape(b, kv, qc, g, -1).permute(0, 2, 1, 3, 4)


def flash_attention_parts(q8: Tensor, k8: Tensor, v8: Tensor, q_pos: Tensor,
                          k_pos: Tensor, k_valid: Tensor, q_scale, k_scale,
                          v_scale, *, causal: bool, sm_scale: float,
                          q_chunk: int, kv_chunk: int, k_a: int = 8) -> dict:
    """Tiled online-softmax attention on int8 payloads (forward), chunk
    for chunk the reference oracle `flash_attention_ref`: per-chunk grid
    decompositions with the amax over the whole (B, chunk, heads) block,
    probabilities quantized UNNORMALIZED onto the Q_A grid per kv step, and
    the online rescale m/l/alpha in fp32.  exp and the final division are
    taken in float64 and rounded once (`_exp32`, `_div32`), as the kernel
    takes them; the row sums of quantized probabilities are exact in fp32.

    q8: (B, S, H, dh) int8; k8/v8: (B, T, KV, dh) int8, pre-padded to chunk
    multiples; q_pos (S,), k_pos (T,) int; k_valid (T,) mask of real kv
    slots; scales: pow2 payload scales.  Returns {"out": (B, S, H, dh)
    f32, "m", "l": (B, S, H) the final softmax max and sum}."""
    b, s, h, dh = q8.shape
    t, kv = k8.shape[1], k8.shape[2]
    g = h // kv
    nq, nk = s // q_chunk, t // kv_chunk
    qf = (q8.float() * q_scale).reshape(b, s, kv, g, dh)
    kf = k8.float() * k_scale
    vf = v8.float() * v_scale
    valid = k_valid != 0
    s_ = 2.0 ** (k_a - 1)
    out = torch.empty((b, s, kv, g, dh), dtype=torch.float32,
                      device=q8.device)
    ms = torch.empty((b, s, kv, g), dtype=torch.float32, device=q8.device)
    ls = torch.empty_like(ms)
    for iq in range(nq):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qi8, q_step = grid_decompose(qf[:, rows], k_a)
        qp = q_pos[rows]
        m = torch.full(qi8.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q8.device)
        l = torch.zeros_like(m)
        o = torch.zeros(qi8.shape, dtype=torch.float32, device=q8.device)
        for j in range(nk):
            cols = slice(j * kv_chunk, (j + 1) * kv_chunk)
            ki8, k_step = grid_decompose(kf[:, cols], k_a)
            sc = _heads_dot(qi8, ki8, False).float() * (q_step * k_step)
            sc = sc * sm_scale
            mask = valid[cols][None, :]
            if causal:
                mask = (qp[:, None] >= k_pos[cols][None, :]) & mask
            sc = torch.where(mask[None, :, None, None, :], sc,
                             torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = _exp32(sc - m_new[..., None])
            p = torch.round(p * s_) / s_             # qprobs, unnormalized
            pi8, p_step = grid_decompose(p, k_a)
            vi8, v_step = grid_decompose(vf[:, cols], k_a)
            pv = _heads_dot(pi8, vi8, True).float() * (p_step * v_step)
            alpha = _exp32(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            o = o * alpha[..., None] + pv
            m = m_new
        out[:, rows] = _div32(o, torch.clamp(l, min=1e-9)[..., None])
        ms[:, rows], ls[:, rows] = m, l
    return {"out": out.reshape(b, s, h, dh), "m": ms.reshape(b, s, h),
            "l": ls.reshape(b, s, h)}


def flash_attention(q8: Tensor, k8: Tensor, v8: Tensor, q_pos: Tensor,
                    k_pos: Tensor, k_valid: Tensor, q_scale, k_scale,
                    v_scale, *, causal: bool, sm_scale: float, q_chunk: int,
                    kv_chunk: int, k_a: int = 8) -> Tensor:
    """`flash_attention_parts`' output (B, S, H, dh) f32."""
    return flash_attention_parts(
        q8, k8, v8, q_pos, k_pos, k_valid, q_scale, k_scale, v_scale,
        causal=causal, sm_scale=sm_scale, q_chunk=q_chunk,
        kv_chunk=kv_chunk, k_a=k_a)["out"]


# --------------------------------------------------------------------------
# K9 selective_scan (repro/kernels/selective_scan.py)
# --------------------------------------------------------------------------


def selective_scan(a: Tensor, b: Tensor, c: Tensor,
                   h0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Mamba1 recurrence h_t = a_t * h_{t-1} + b_t, y_t = sum_n c_t[n] h_t[n].

    a, b: (B, S, D, N); c: (B, S, N); h0: (B, D, N) or None (zeros); all
    f32 or all bf16.  Returns (y (B, S, D), h_last (B, D, N)) in that dtype.

    The numerics the kernel matches bit for bit: h in fp32 with two
    roundings per step (a multiply, then an add: no fused multiply-add),
    and y_t as the sum in n order of the float64 products h*c (each exact),
    rounded once to fp32.  The loop over t computes h only, into a
    (B, S, D, N) buffer; y then comes from one n-ordered float64 pass.
    bf16 carriers (`scan_dtype="bf16"`) run exactly that on their exact
    fp32 values, then round each output once more, fp32 -> bf16 to
    nearest even: y by the chain float64 -> fp32 -> bf16."""
    if a.dtype == torch.bfloat16:
        return _bf16_outputs(selective_scan(*_f32_inputs(a, b, c, h0)))
    bsz, s, d, n = a.shape
    hs, h = _scan_states(a, b, h0)
    acc = None
    for j in range(n):
        p = hs[..., j].double() * c[:, :, None, j].double()
        acc = p if acc is None else acc + p
    y = (acc.to(a.dtype) if acc is not None
         else torch.zeros((bsz, s, d), dtype=a.dtype, device=a.device))
    return y, h


def _f32_inputs(*ts):
    """bf16 operands as their exact fp32 values (None stays None)."""
    return [None if t is None else t.float() for t in ts]


def _bf16_outputs(ts):
    """fp32 results rounded once to bf16, to nearest even."""
    return tuple(None if t is None else t.to(torch.bfloat16) for t in ts)


def _scan_states(a: Tensor, b: Tensor, h0: Tensor | None):
    """Every h_t of the recurrence, (B, S, D, N), and h_last, with the
    forward's two roundings per step.  In a's dtype (fp32 on every path;
    float64 for a finite-difference check)."""
    bsz, s, d, n = a.shape
    h = (torch.zeros((bsz, d, n), dtype=a.dtype, device=a.device)
         if h0 is None else h0.to(a.dtype))
    hs = torch.empty_like(a)
    for t in range(s):
        h = a[:, t] * h
        h = h + b[:, t]
        hs[:, t] = h
    return hs, h


def scan_dc_groups(n: int) -> tuple[int, int]:
    """(channels in a group, groups in a tile) of the backward's dc sum:
    the channels one warp of K9b holds (32 lanes of N / 4 states) and the
    four warps of its block."""
    return 128 // n, 4


def selective_scan_bwd(a: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                       h0: Tensor | None = None,
                       dh_last: Tensor | None = None):
    """The gradient of `selective_scan` (K9b's function).

    a, b: (B, S, D, N); c: (B, S, N); dy: (B, S, D) the gradient of y;
    h0: (B, D, N) or None (zeros); dh_last: (B, D, N) the gradient of
    h_last, or None (zeros); all f32 or all bf16.  Returns (da, db
    (B, S, D, N), dc (B, S, N), dh0 (B, D, N), or None without h0) in
    that dtype.  bf16 carriers run the fp32 arithmetic below on their
    exact fp32 values and round each output once to bf16 (dc by the chain
    float64 -> fp32 -> bf16), to nearest even.

    With g_t the gradient of h_t, from t = S-1 down to 0:
        g_t  = a_{t+1} g_{t+1} + dy_t (x) c_t    (the carry starts at dh_last)
        db_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_0 g_0
        dc_t[n] = sum_d dy_t[d] h_t[d, n]
    Numerics, which the kernel matches bit for bit:
      * h_t is the forward's, recomputed with its two roundings a step;
      * dy_t[d] * c_t[n] rounds once, then the carry a_{t+1} * g_{t+1}
        (rounded once, or dh_last, or +0) is added, rounding once;
        da_t = g_t * h_{t-1} and the next carry a_t * g_t round once each
        (no fused multiply-add anywhere);
      * dc: the float64 products dy_t[d] * h_t[d, n] are exact.  Channels
        are padded with +0 products to whole tiles of 4 groups of
        `scan_dc_groups(N)[0]` channels; each group is summed in d order,
        a tile's four group sums in order, the tiles' sums in d order, all
        in float64, then rounded once to fp32."""
    if a.dtype == torch.bfloat16:
        return _bf16_outputs(selective_scan_bwd(
            *_f32_inputs(a, b, c, dy, h0, dh_last)))
    bsz, s, d, n = a.shape
    hs, _ = _scan_states(a, b, h0)
    carry = (torch.zeros((bsz, d, n), dtype=a.dtype, device=a.device)
             if dh_last is None else dh_last.to(a.dtype))
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(s - 1, -1, -1):
        g = carry + dy[:, t, :, None] * c[:, t, None, :]
        db[:, t] = g
        hp = hs[:, t - 1] if t > 0 else (
            torch.zeros_like(g) if h0 is None else h0.to(a.dtype))
        da[:, t] = g * hp
        carry = a[:, t] * g
    return da, db, _scan_dc(dy, hs), (None if h0 is None else carry)


def _scan_dc(dy: Tensor, hs: Tensor) -> Tensor:
    """dc in the order `selective_scan_bwd` states."""
    bsz, s, d, n = hs.shape
    w, q = scan_dc_groups(n)
    tiles = -(-d // (w * q))
    pad = tiles * w * q - d
    if pad:
        hs = torch.cat([hs, hs.new_zeros((bsz, s, pad, n))], 2)
        dy = torch.cat([dy, dy.new_zeros((bsz, s, pad))], 2)
    hv = hs.reshape(bsz, s, tiles, q, w, n)
    dv = dy.reshape(bsz, s, tiles, q, w)
    grp = None
    for j in range(w):
        p = dv[..., j, None].double() * hv[..., j, :].double()
        grp = p if grp is None else grp + p          # (B, S, tiles, q, N)
    if grp is None:
        return torch.zeros((bsz, s, n), dtype=hs.dtype, device=hs.device)
    tile = grp[:, :, :, 0]
    for i in range(1, q):
        tile = tile + grp[:, :, :, i]
    tot = tile[:, :, 0]
    for i in range(1, tiles):
        tot = tot + tile[:, :, i]
    return tot.to(hs.dtype)
