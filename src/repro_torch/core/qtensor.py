"""Quantized tensors and the quantizer registry.

Port of `repro.core.qtensor`: a `QTensor` is an integer payload with a
power-of-two scale (value = data * scale, plus lo * lo_scale for the
two-plane flag format), and it is the object that flows between the
quantized ops, so a payload is decomposed once and consumed by the integer
dots as it is.  `carrier` is an optional fp32 view of the same value: the
QTensors made inside the training step (qact, qweight) carry one that
autograd differentiates, so gradients route around the integer payload;
raw payloads (the KV cache) leave it None.

Quantizers (registered names; legacy aliases such as "flag8" and "sq16"
resolve through ALIASES):

  none    identity; its payload is a lossless 16-bit grid decomposition
  grid    pow2_ceil(amax) scale, floor 2^-24 (decomposes grid carriers)
  direct  Q(x, k) on the fixed 2^(1-k) grid               (paper Eq. 6)
  clip    Q_W: direct + saturation, fixed 2^(1-k) scale   (paper Eq. 10)
  scaled  Q_A: pow2_ceil(amax) scale >= 1                 (paper Eq. 14)
  sq      SQ: pow2_round(amax) scale                      (paper Eq. 8)
  flag    Q_E2 flag format, two disjoint int8 planes      (paper Eq. 17)
  cq      CQ: stochastic, constant 2^(1-k_gc) scale       (paper Eq. 7)

`fused_plan` gives the scalar recipe of the backward kernels' prologue
(K3).  Payloads of 8 bits or fewer go through the quantize kernel (K2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

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
    lo: Tensor | None = None
    lo_scale: Tensor | None = None
    carrier: Tensor | None = None

    def dequantize(self) -> Tensor:
        y = self.data.float() * self.scale
        if self.lo is not None:
            y = y + self.lo.float() * self.lo_scale
        return y

    def to_array(self) -> Tensor:
        """fp32 view: the carrier when present, else the dequantized value."""
        return self.carrier if self.carrier is not None else self.dequantize()

    def planes(self):
        """((data, scale), ...) integer planes for native matmuls."""
        if self.lo is None:
            return ((self.data, self.scale),)
        return ((self.data, self.scale), (self.lo, self.lo_scale))

    def drop_carrier(self) -> "QTensor":
        return self if self.carrier is None else \
            dataclasses.replace(self, carrier=None)

    def requantize(self, step, k: int | None = None) -> Tensor:
        """Re-express the payload on a new pow2 `step` WITHOUT an amax pass:
        a rounding shift plus a clip to the target width `k` (default this
        tensor's own), e.g. k=8 when writing into the int8 KV cache."""
        k = self.k if k is None else k
        v = self.data.float() * (self.scale / step)
        if self.lo is not None:
            v = v + self.lo.float() * (self.lo_scale / step)
        lim = 2.0 ** (k - 1) - 1.0
        return torch.clamp(torch.round(v), -lim, lim).to(payload_dtype(k))

    @property
    def shape(self):
        return self.data.shape

    def _map_payload(self, fn) -> "QTensor":
        return dataclasses.replace(
            self, data=fn(self.data),
            lo=None if self.lo is None else fn(self.lo),
            carrier=None if self.carrier is None else fn(self.carrier))

    def reshape(self, *shape) -> "QTensor":
        return self._map_payload(lambda t: t.reshape(*shape))

    def __getitem__(self, idx) -> "QTensor":
        return self._map_payload(lambda t: t[idx])

    # arithmetic degrades to the fp32 view (differentiable via the carrier)
    def __mul__(self, o):
        return self.to_array() * qt_carrier(o)

    __rmul__ = __mul__


def qt_carrier(x) -> Tensor:
    """fp32 view of Tensor | QTensor."""
    return x.to_array() if isinstance(x, QTensor) else x


def save_qtensors(ctx, *qts: QTensor) -> tuple:
    """Save the payloads of carrier-free QTensors through
    `ctx.save_for_backward`, where a layer's checkpoint (remat "full")
    drops them and its recompute restores them; returns the widths that
    `saved_qtensors` needs to rebuild them."""
    ctx.save_for_backward(*(t for q in qts
                            for t in (q.data, q.scale, q.lo, q.lo_scale)))
    return tuple(q.k for q in qts)


def saved_qtensors(ctx, ks: tuple) -> list:
    """The QTensors `save_qtensors` saved, in order."""
    t = ctx.saved_tensors
    return [QTensor(t[4 * i], t[4 * i + 1], k, t[4 * i + 2], t[4 * i + 3])
            for i, k in enumerate(ks)]


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
    grid-valued fp32 output, dequantize(quantize(x)).  Frozen, so a
    quantizer is hashable (a key of the instance cache)."""

    k: int = 8
    name = "base"

    def __call__(self, x: Tensor, *, key=None) -> Tensor:
        return self.quantize(x, key=key).dequantize()

    def quantize(self, x: Tensor, *, key=None) -> QTensor:
        raise NotImplementedError

    def fused_plan(self, x: Tensor):
        """Scalar recipe for fusing this quantizer into a matmul prologue:
        (mode, plane_steps, k), mode "affine" (one plane, payload
        clip(round(x / steps[0]), +-(2^(k-1)-1))) or "flag" (two planes at
        steps (Sc, Sc * 2^(1-k))); None when the format cannot fuse.  Only
        the scale reduction (at most one amax) runs here."""
        return None


def _step_tensor(v: float, like: Tensor) -> Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class IdentityQuantizer(Quantizer):
    """No forward quantization; native payloads use a lossless-on-grid
    16-bit decomposition."""

    k: int = 16
    name = "none"

    def __call__(self, x, *, key=None):
        return x

    def _step(self, x):
        s = torch.clamp(qf.pow2_ceil(qf.amax(x)), min=2.0 ** -24)
        return s * 2.0 ** (1 - self.k)

    def quantize(self, x, *, key=None):
        return _decompose(x, self._step(x), self.k)

    def fused_plan(self, x):
        return ("affine", (self._step(x),), self.k)


@dataclass(frozen=True)
class GridQuantizer(IdentityQuantizer):
    """Decompose a tensor already on a fixed-point grid: pow2_ceil(amax)
    scale with a 2^-24 floor (lossless for q_scaled/q_clip/sq outputs)."""

    k: int = 8
    name = "grid"

    def __call__(self, x, *, key=None):
        return self.quantize(x).dequantize()


@dataclass(frozen=True)
class DirectQuantizer(Quantizer):
    """Q(x,k) = round(x * 2^(k-1)) / 2^(k-1) (paper Eq. 6)."""

    name = "direct"

    def __call__(self, x, *, key=None):
        return qf.q_direct(x, self.k)

    def quantize(self, x, *, key=None):
        return _decompose(x, 2.0 ** (1 - self.k), self.k)

    def fused_plan(self, x):
        return ("affine", (_step_tensor(2.0 ** (1 - self.k), x),), self.k)


@dataclass(frozen=True)
class ClipQuantizer(DirectQuantizer):
    """Q_W (paper Eq. 10): direct quantization saturating to (-1, 1), with
    the FIXED 2^(1-k) payload scale (no amax pass on weights)."""

    name = "clip"

    def __call__(self, x, *, key=None):
        return qf.q_clip(x, self.k)


@dataclass(frozen=True)
class ScaledQuantizer(Quantizer):
    """Q_A (paper Eq. 14 + WAGE layer-wise pow2 scaling): pow2_ceil(amax)
    scale >= 1; the payload is int8-packable by construction."""

    name = "scaled"

    def __call__(self, x, *, key=None):
        return qf.q_scaled(x, self.k)

    def _step(self, x):
        s = torch.clamp(qf.pow2_ceil(qf.amax(x)), min=1.0)
        return s * 2.0 ** (1 - self.k)

    def quantize(self, x, *, key=None):
        return _decompose(x, self._step(x), self.k)

    def fused_plan(self, x):
        return ("affine", (self._step(x),), self.k)


@dataclass(frozen=True)
class ShiftQuantizer(Quantizer):
    """SQ (paper Eq. 8): layer-wise pow2 scale R(x) = 2^round(log2 amax)."""

    name = "sq"

    def __call__(self, x, *, key=None):
        return qf.sq(x, self.k)

    def _step(self, x):
        return qf.pow2_round(qf.amax(x)) * 2.0 ** (1 - self.k)

    def quantize(self, x, *, key=None):
        return _decompose(x, self._step(x), self.k)

    def fused_plan(self, x):
        return ("affine", (self._step(x),), self.k)


@dataclass(frozen=True)
class FlagQuantizer(Quantizer):
    """Flag-bit error quantization (paper Eq. 17 / Fig. 4): two disjoint
    int8 planes, hi on multiples of Sc = R(x)/2^(k-1) and lo on multiples
    of Sc * 2^(1-k); their sum is flag_qe2(x) bit for bit."""

    name = "flag"

    def __call__(self, x, *, key=None):
        return qf.flag_qe2(x, self.k)

    def _sc(self, x):
        return qf.pow2_round(qf.amax(x)) / 2.0 ** (self.k - 1)

    def quantize(self, x, *, key=None):
        k = self.k
        sc = self._sc(x)
        n = x / sc
        lim = 2.0 ** (k - 1) - 1.0
        nlo = torch.round(n * 2.0 ** (k - 1))
        # |nlo| >= 2^(k-1) collapses to the hi regime (same value there)
        isbig = (torch.abs(n) >= 1.0) | (torch.abs(nlo) >= 2.0 ** (k - 1))
        zero = torch.zeros_like(n)
        hi = torch.where(isbig, torch.clamp(torch.round(n), -lim, lim), zero)
        lo = torch.where(isbig, zero, torch.clamp(nlo, -lim, lim))
        dt = payload_dtype(k)
        return QTensor(hi.to(dt), sc, k, lo=lo.to(dt),
                       lo_scale=sc * 2.0 ** (1 - k))

    def fused_plan(self, x):
        sc = self._sc(x)
        return ("flag", (sc, sc * 2.0 ** (1 - self.k)), self.k)


@dataclass(frozen=True)
class ConstantQuantizer(Quantizer):
    """CQ (paper Eq. 7) for weight gradients: range-normalized, constant
    pow2 scale 2^(1-k_gc), stochastic rounding with threefry noise (`key`
    from core/prng.py), shrinking dr schedule."""

    k: int = 15          # k_gc: constant scale bits
    dr_bits: int = 8     # dr = 2^(dr_bits-1), shrinks during training
    stochastic: bool = True

    name = "cq"

    def __call__(self, x, *, key=None):
        return qf.cq(x, key, self.dr_bits, self.k, stochastic=self.stochastic)

    def quantize(self, x, *, key=None):
        y = self(x, key=key) * 2.0 ** (self.k - 1)       # exact integers
        return QTensor(y.to(payload_dtype(self.dr_bits)),
                       _step_tensor(2.0 ** (1 - self.k), x), self.k)


_REGISTRY = {c.name: c for c in (
    IdentityQuantizer, GridQuantizer, DirectQuantizer, ClipQuantizer,
    ScaledQuantizer, ShiftQuantizer, FlagQuantizer, ConstantQuantizer)}

# legacy string kinds -> (registered name, fixed k or None)
ALIASES: dict[str, tuple[str, int | None]] = {
    "flag8": ("flag", 8),
    "sq8": ("sq", 8),
    "sq16": ("sq", 16),
    "q_direct": ("direct", None),
    "q_clip": ("clip", None),
    "q_scaled": ("scaled", None),
    "dec_int8": ("grid", 8),
    "dec_int16": ("grid", 16),
    "dec_int8_fixed": ("clip", 8),
    "identity": ("none", None),
}


@lru_cache(maxsize=None)
def get_quantizer(kind: str, k: int | None = None,
                  params: tuple = ()) -> Quantizer:
    """A quantizer by registry name or legacy alias; `params` is a tuple
    of (field, value) pairs (hashable, for the instance cache)."""
    if kind in ALIASES:
        name, fixed_k = ALIASES[kind]
        return get_quantizer(name, fixed_k if fixed_k is not None else k,
                             params)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown quantizer {kind!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    kw = dict(params)
    if k is not None:
        kw["k"] = k
    return _REGISTRY[kind](**kw)


@dataclass(frozen=True)
class QuantSpec:
    """Hashable (kind, k, params) triple naming a registered quantizer."""

    kind: str
    k: int = 8
    params: tuple = ()

    def make(self) -> Quantizer:
        return get_quantizer(self.kind, self.k, self.params)

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


def spec_from_alias(kind: str, default_k: int = 8) -> QuantSpec:
    """Legacy string kind -> QuantSpec ("sq16" -> sq@16, "flag8" -> flag@8);
    bare kinds take `default_k`."""
    if kind in ALIASES:
        name, fixed_k = ALIASES[kind]
        return QuantSpec(name, fixed_k if fixed_k is not None else default_k)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown quantizer {kind!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return QuantSpec(kind, default_k)


def legacy_kind(spec: QuantSpec) -> str:
    """Canonical legacy string for a spec (the deprecated alias fields)."""
    for alias, (name, fixed_k) in ALIASES.items():
        if name == spec.kind and fixed_k == spec.k:
            return alias
    return spec.kind


def resolve_quantizer(spec, default_k: int = 8) -> Quantizer:
    """QuantSpec | legacy string | Quantizer -> Quantizer instance."""
    if isinstance(spec, Quantizer):
        return spec
    if isinstance(spec, QuantSpec):
        return spec.make()
    return spec_from_alias(spec, default_k).make()


def quantize_ste(quantizer: Quantizer, x: Tensor) -> QTensor:
    """QTensor = quantizer.quantize(x) with a carrier whose cotangent goes
    to x unchanged (straight-through, paper Eq. 1).  Without autograd
    (serving) the carrier is left out: it is only the fp32 view, which
    `to_array` dequantizes on demand."""
    with torch.no_grad():
        qt = quantizer.quantize(x.detach())
    if not (torch.is_grad_enabled() and x.requires_grad):
        return qt
    return dataclasses.replace(qt, carrier=qf._Ste.apply(x, qt.dequantize()))
