"""WAGEUBN quantization functions (paper §III-C), the forward subset.

Port of `repro.core.qfuncs`: `d`, `amax`, `pow2_ceil`, `pow2_round`,
`q_direct` and `q_clip`.  Grid tensors are fp32 values that lie exactly on
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
