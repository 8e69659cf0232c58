"""Quantized tensors and the forward quantizers of the serving slice.

Port of `repro.core.qtensor`: a `QTensor` is an integer payload with a
power-of-two scale (value = data * scale), and it is the object that flows
between the quantized ops, so a payload is decomposed once and consumed by
the integer dots as it is.  `carrier` is an optional fp32 view of the same
value; the reference keeps one for autodiff, and the port, which serves
without a backward, leaves it None and dequantizes on demand.

Quantizers ported so far (the registry's other kinds wait for training):

  grid    pow2_ceil(amax) scale, floor 2^-24 (decomposes grid carriers)
  direct  Q(x, k) on the fixed 2^(1-k) grid               (paper Eq. 6)
  clip    Q_W: direct + saturation, fixed 2^(1-k) scale   (paper Eq. 10)
  scaled  Q_A: pow2_ceil(amax) scale >= 1                 (paper Eq. 14)

Payloads of 8 bits or fewer go through the quantize kernel (K2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops

from . import qfuncs as qf

Tensor = torch.Tensor


def payload_dtype(k: int):
    if k <= 8:
        return torch.int8
    if k <= 16:
        return torch.int16
    return torch.int32


@dataclass(frozen=True)
class QTensor:
    """Integer payload + power-of-two scale (a 0-d fp32 tensor)."""

    data: Tensor
    scale: Tensor
    k: int = 8
    carrier: Tensor | None = None

    def dequantize(self) -> Tensor:
        return self.data.float() * self.scale

    def to_array(self) -> Tensor:
        """fp32 view: the carrier when present, else the dequantized value."""
        return self.carrier if self.carrier is not None else self.dequantize()

    def planes(self):
        """((data, scale),) integer planes for native matmuls."""
        return ((self.data, self.scale),)

    def drop_carrier(self) -> "QTensor":
        return self if self.carrier is None else \
            dataclasses.replace(self, carrier=None)

    def requantize(self, step, k: int | None = None) -> Tensor:
        """Re-express the payload on a new pow2 `step` WITHOUT an amax pass:
        a rounding shift plus a clip to the target width `k` (default this
        tensor's own), e.g. k=8 when writing into the int8 KV cache."""
        k = self.k if k is None else k
        v = self.data.float() * (self.scale / step)
        lim = 2.0 ** (k - 1) - 1.0
        return torch.clamp(torch.round(v), -lim, lim).to(payload_dtype(k))

    @property
    def shape(self):
        return self.data.shape

    def _map_payload(self, fn) -> "QTensor":
        return dataclasses.replace(
            self, data=fn(self.data),
            carrier=None if self.carrier is None else fn(self.carrier))

    def reshape(self, *shape) -> "QTensor":
        return self._map_payload(lambda t: t.reshape(*shape))

    def __getitem__(self, idx) -> "QTensor":
        return self._map_payload(lambda t: t[idx])

    # arithmetic degrades to the fp32 view
    def __mul__(self, o):
        return self.to_array() * qt_carrier(o)

    __rmul__ = __mul__


def qt_carrier(x) -> Tensor:
    """fp32 view of Tensor | QTensor."""
    return x.to_array() if isinstance(x, QTensor) else x


def _decompose(x: Tensor, step, k: int) -> QTensor:
    """clip(round(x / step)) saturated to the signed k-bit range; `step`
    (a 0-d tensor or a float) is a power of two, so the reciprocal multiply
    is exact.  int8-width payloads go through the quantize kernel."""
    lim = 2.0 ** (k - 1) - 1.0
    if not isinstance(step, Tensor):
        step = torch.full((), step, dtype=torch.float32, device=x.device)
    if k <= 8:
        data = ops.quantize(x, 1.0 / step, lim=lim)
    else:
        data = torch.clamp(torch.round(x / step), -lim,
                           lim).to(payload_dtype(k))
    return QTensor(data, step, k)


@dataclass(frozen=True)
class Quantizer:
    """`quantize` decomposes into a QTensor exactly once; `__call__` is the
    grid-valued fp32 output, dequantize(quantize(x))."""

    k: int = 8
    name = "base"

    def __call__(self, x: Tensor) -> Tensor:
        return self.quantize(x).dequantize()

    def quantize(self, x: Tensor) -> QTensor:
        raise NotImplementedError


@dataclass(frozen=True)
class GridQuantizer(Quantizer):
    """Decompose a tensor already on a fixed-point grid: pow2_ceil(amax)
    scale with a 2^-24 floor (lossless for q_scaled/q_clip outputs)."""

    name = "grid"

    def quantize(self, x):
        s = torch.clamp(qf.pow2_ceil(qf.amax(x)), min=2.0 ** -24)
        return _decompose(x, s * 2.0 ** (1 - self.k), self.k)


@dataclass(frozen=True)
class DirectQuantizer(Quantizer):
    """Q(x,k) = round(x * 2^(k-1)) / 2^(k-1) (paper Eq. 6)."""

    name = "direct"

    def __call__(self, x):
        return qf.q_direct(x, self.k)

    def quantize(self, x):
        return _decompose(x, 2.0 ** (1 - self.k), self.k)


@dataclass(frozen=True)
class ClipQuantizer(Quantizer):
    """Q_W (paper Eq. 10): direct quantization saturating to (-1, 1), with
    the FIXED 2^(1-k) payload scale (no amax pass on weights)."""

    name = "clip"

    def __call__(self, x):
        return qf.q_clip(x, self.k)

    def quantize(self, x):
        return _decompose(x, 2.0 ** (1 - self.k), self.k)


@dataclass(frozen=True)
class ScaledQuantizer(Quantizer):
    """Q_A (paper Eq. 14 + WAGE layer-wise pow2 scaling): pow2_ceil(amax)
    scale >= 1; the payload is int8-packable by construction."""

    name = "scaled"

    def quantize(self, x):
        s = torch.clamp(qf.pow2_ceil(qf.amax(x)), min=1.0)
        return _decompose(x, s * 2.0 ** (1 - self.k), self.k)


_REGISTRY = {c.name: c for c in (GridQuantizer, DirectQuantizer,
                                 ClipQuantizer, ScaledQuantizer)}


def get_quantizer(kind: str, k: int = 8) -> Quantizer:
    if kind not in _REGISTRY:
        raise NotImplementedError(
            f"quantizer {kind!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}); the rest of the registry comes with the "
            "training step (ROADMAP Queue 1 item 1)")
    return _REGISTRY[kind](k)


@dataclass(frozen=True)
class QuantSpec:
    """Hashable (kind, k) pair naming a registered quantizer."""

    kind: str
    k: int = 8

    def make(self) -> Quantizer:
        return get_quantizer(self.kind, self.k)
