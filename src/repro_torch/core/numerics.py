"""fp32 arithmetic taken in float64 and rounded once.

A division or square root rounded so is the correctly rounded fp32 result
(53 >= 2 * 24 + 2 bits), so code written with these helpers gives the same
bits on the CPU and on the card however PyTorch and the kernels' build
compile fp32 `expf`, `/` and `sqrtf`.  The kernels' plain versions
(`kernels/ref.py`) and the model layers that must match them bit for bit
(`models/layers.decode_attention` against K6) share them.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def sum64(x64: Tensor, dim: int) -> Tensor:
    """A float64 sum rounded once to fp32: the statistic the kernels compute
    too, whatever their summation order (x*x is exact in float64)."""
    return torch.sum(x64, dim=dim, keepdim=True).float()


def div32(a, b: Tensor) -> Tensor:
    """fp32 a / b, correctly rounded (through float64)."""
    a = a.double() if isinstance(a, Tensor) else a
    return (a / b.double()).float()


def sqrt32(x: Tensor) -> Tensor:
    return torch.sqrt(x.double()).float()


def exp32(x: Tensor) -> Tensor:
    return torch.exp(x.double()).float()
