"""WAGEUBN quantization functions (paper §III-C).

Port of `repro.core.qfuncs`: `d`, `amax`, `pow2_ceil`, `pow2_round`,
`q_direct`, `q_clip`, `q_scaled`, shift quantization `sq` (errors), the
flag format `flag_qe2` (Eq. 17), constant quantization `cq` with stochastic
rounding (weight gradients, Eq. 7) and the straight-through `ste`.  Grid tensors are fp32 values that lie exactly on
a fixed-point grid x = n * step, step a power of two.  Rounding is half to
even everywhere (`torch.round`), as in the reference.

Powers of two come from the exponent bits (`torch.frexp` and an fp32 bit
pattern), never from `exp2(log2(m))`: the reference's `jnp.exp2` is inexact on the
CPU for integer k <= -15 and most k >= 13 (ROADMAP F1), while a scale built
from exponent bits is a power of two by construction.  Scales stay 0-d
tensors on the input's device, so no quantizer forces a host sync.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def d(k: int) -> float:
    """Minimum interval of a k-bit fixed-point grid (paper Eq. 8)."""
    return 2.0 ** (1 - k)


def amax(x: Tensor) -> Tensor:
    """max |x| as a 0-d fp32 tensor on x's device."""
    return torch.amax(torch.abs(x))


def _exp2_int(e: Tensor) -> Tensor:
    """2^e for an int32 tensor e, built from fp32 exponent bits (exact on
    every device, subnormals included; e clamps to [-149, 127])."""
    e = e.to(torch.int32).clamp(-149, 127)
    normal = (e + 127) << 23
    sub = torch.bitwise_left_shift(torch.ones_like(e), (e + 149).clamp(0, 22))
    return torch.where(e >= -126, normal, sub).view(torch.float32)


def pow2_ceil(m: Tensor) -> Tensor:
    """Smallest power of two >= m; 1 for m <= 0 (exact)."""
    pos = m > 0
    safe = torch.where(pos, m, torch.ones_like(m))
    mant, ex = torch.frexp(safe)          # safe = mant * 2^ex, mant in [.5, 1)
    ex = torch.where(mant == 0.5, ex - 1, ex)
    return torch.where(pos, _exp2_int(ex), torch.ones_like(m))


def pow2_round(m: Tensor) -> Tensor:
    """R(x) = 2^round(log2 m) for m = max|x| (paper Eq. 7); R(0) := 1.

    log2 m = (ex - 1) + log2(2 mant) with 2 mant in [1, 2): it rounds up
    iff 2 mant > sqrt(2), which no fp32 value equals, so there is no tie."""
    pos = m > 0
    safe = torch.where(pos, m, torch.ones_like(m))
    mant, ex = torch.frexp(safe)
    up = (2.0 * mant).double() > math.sqrt(2.0)
    ex = torch.where(up, ex, ex - 1)
    return torch.where(pos, _exp2_int(ex), torch.ones_like(m))


def q_direct(x: Tensor, k: int) -> Tensor:
    """Direct quantization Q(x,k) = round(x*2^(k-1)) / 2^(k-1)  (Eq. 6)."""
    s = 2.0 ** (k - 1)
    return torch.round(x * s) / s


def q_clip(x: Tensor, k: int) -> Tensor:
    """Direct quantization + saturation to (-1, 1): used for W (Eq. 10)."""
    lim = 1.0 - d(k)
    return torch.clamp(q_direct(x, k), -lim, lim)


def q_scaled(x: Tensor, k: int) -> Tensor:
    """Q_A with the layer-wise pow2 amax factor >= 1 (Eq. 14)."""
    s = torch.clamp(pow2_ceil(amax(x)), min=1.0)
    lim = 1.0 - d(k)
    return s * torch.clamp(q_direct(x / s, k), -lim, lim)


def sq(x: Tensor, k: int) -> Tensor:
    """Shift quantization SQ(x,k) = R * clip(Q(x/R, k), +-(1-d))  (Eq. 8)."""
    r = pow2_round(amax(x))
    lim = 1.0 - d(k)
    return r * torch.clamp(q_direct(x / r, k), -lim, lim)


def flag_qe2(x: Tensor, k: int = 8) -> Tensor:
    """Flag-bit error quantization (Eq. 17 / Fig. 4): multiples of
    Sc = R(x)/2^(k-1) where |x| >= Sc, multiples of Sc/2^(k-1) below."""
    r = pow2_round(amax(x))
    sc = r / 2.0 ** (k - 1)
    n = x / sc
    lim = 2.0 ** (k - 1) - 1.0
    big = sc * torch.clamp(torch.round(n), -lim, lim)
    small = sc * q_direct(n, k)
    return torch.where(torch.abs(n) >= 1.0, big, small)


def stochastic_round(x: Tensor, u: Tensor) -> Tensor:
    """Sr(x) (Eq. 7): floor(x) + [u < x - floor(x)], u uniform in [0, 1)
    (prng.uniform gives the reference's bits)."""
    f = torch.floor(x)
    return f + (u < (x - f)).to(x.dtype)


def cq(x: Tensor, key, dr_bits: int, k_gc: int,
       stochastic: bool = True) -> Tensor:
    """Constant quantization CQ (Eq. 7) for weight gradients G: range
    normalized by R(x), stochastic rounding onto the dr = 2^(dr_bits-1)
    range, output on the 2^-(k_gc-1) grid.

    `key` is a threefry key (prng.py): the noise is the reference's
    `jax.random.uniform(key, x.shape)`, drawn in chunks of the flat index
    range so that a large leaf needs no int64 tensor of its own size."""
    from .prng import uniform_flat
    r = pow2_round(amax(x))
    dr = float(2 ** (dr_bits - 1))
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    step = 1 << 24
    for i in range(0, flat.numel(), step):
        y = dr * (flat[i:i + step] / r)
        if stochastic:
            if key is None:
                raise ValueError("stochastic CQ needs a PRNG key")
            y = stochastic_round(y, uniform_flat(key, i, y.numel(), x.device))
        else:
            y = torch.round(y)
        out[i:i + step] = torch.clamp(y, -dr + 1.0, dr - 1.0) \
            / 2.0 ** (k_gc - 1)
    return out.reshape(x.shape)


class _Ste(torch.autograd.Function):
    """y = value in the forward pass; identity cotangent to x."""

    @staticmethod
    def forward(ctx, x, value):
        return value

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste(fn, x: Tensor) -> Tensor:
    """Straight-through estimator (paper Eq. 1): fn(x) forward, identity
    backward."""
    with torch.no_grad():
        value = fn(x.detach())
    return _Ste.apply(x, value)
