"""Quantized compute ops with WAGEUBN backward semantics, QTensor-native.

Port of `repro.core.qdense`.  The paper's dataflow (Fig. 5 / Algorithms
1-2) runs through `torch.autograd.Function`s where the reference has
`jax.custom_vjp`s.  Each op has the reference's three modes (qconfig.py):
native on integer payloads, sim on the quantizers' grid values carried in
fp32, fp32 with every quantizer the identity.

  qweight   Q_W through cfg.w (fixed 2^(1-k_W) scale, no amax pass), STE to
            the fp32 master (paper Eq. 1): native the int8 payload, sim
            its grid value
  qact      activation + Q_A (native: a QTensor with a differentiable
            carrier; sim: the grid value; fp32: the activation); backward
            applies Q_E1 (shift quantization, e0; not in fp32) and then the
            activation derivative (e1), exactly Algorithm 2
  qprobs    attention probabilities onto the k_A grid (STE)
  qbn_param Q for norm operands (STE)
  qeinsum   every matmul.  Native, on integer payloads.  Forward: QTensor
            operands feed their payloads as they are; raw fp32 operands
            are decomposed once.  It saves the int payloads, not the fp32
            carriers.  Backward: Q_E2 on the incoming error (e3), then both
            integer dots of Alg. 2.  For the canonical 2-D spec with
            single-plane int8 residuals, Q_E2 is fused into the dgrad/wgrad
            kernels (K3): one amax here, the error payload never stored.
            Otherwise quantizer.quantize(g) and integer contractions through
            the batched qmatmul kernel (K1).  sim and fp32: the einsum of
            the fp32 carriers, and on the way back (after Q_E2 in sim) the
            two fp32 einsums, as the reference's `jnp.einsum`s outside any
            Pallas kernel; on the card they raise if cuBLAS's TF32 is on.
  qdense    x @ Q_W(w)
  qconv     the ResNet's convolution on the fp32 grid carriers (NHWC
            activations, HWIO weights, JAX's "SAME" padding); backward:
            Q_E2 on the incoming error (e3; not in fp32), then the
            convolution's input and weight gradients.  As in the reference,
            whose convolution is `lax.conv_general_dilated` outside any
            Pallas kernel, the convolution itself is cuDNN's (`F.conv2d`),
            in full fp32: on the card it raises if cuDNN's TF32 is on.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from . import qfuncs as qf
from .qconfig import QConfig
from .qtensor import (QTensor, get_quantizer, qt_carrier, quantize_ste,
                      resolve_quantizer, save_qtensors, saved_qtensors)

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# weight / activation / prob quantizers (forward path, STE)
# --------------------------------------------------------------------------


# Q_W's and Q_A's quantizers: their payload decomposition holds their grid
# value for every input (both saturate to the payload's range)
_PAYLOAD_EXACT = ("clip", "scaled")


def _grid(quantizer, x: Tensor) -> Tensor:
    """Sim mode's grid value of a forward quantizer: its payload
    decomposition dequantized (the quantize kernel, K2, for k <= 8, as the
    reference's `Quantizer.__call__` decomposes), equal to the reference's
    formula `quantizer(x)` but for the sign of a zero; formula-only
    quantizers give `quantizer(x)`."""
    if quantizer.name in _PAYLOAD_EXACT:
        return quantizer.quantize(x).dequantize()
    return quantizer(x)


def qweight(cfg: QConfig, w: Tensor):
    """Q_W (Eq. 10) of the fp32 master weight, decomposed on every forward
    (as the reference does; caching it is later work), with a gradient that
    reaches the master unchanged (STE): native the int8 payload (a QTensor
    with a carrier), sim its fp32 grid value, fp32 the master itself."""
    if not cfg.quantize or not cfg.quant_w:
        return w
    quantizer = cfg.w.make()
    if cfg.native:
        return quantize_ste(quantizer, w)
    return qf.ste(lambda t: _grid(quantizer, t), w)


def qbn_param(cfg: QConfig, p: Tensor, k: int) -> Tensor:
    """Q for norm operands (gamma/beta/mu/sigma, Eq. 13), STE."""
    if not cfg.quantize:
        return p
    return qf.ste(get_quantizer("direct", k), p)


def qprobs(cfg: QConfig, p: Tensor) -> Tensor:
    """Attention probabilities onto the k_A grid (in [0,1], exact range)."""
    if not cfg.quantize:
        return p
    return qf.ste(get_quantizer("direct", cfg.k_a), p)


def _silu(x: Tensor) -> Tensor:
    # jax.nn.silu's formula, x * sigmoid(x) (F.silu rounds differently)
    return x * torch.sigmoid(x)


def _dsilu(x: Tensor) -> Tensor:
    sg = torch.sigmoid(x)
    return sg * (1.0 + x * (1.0 - sg))


# jax.nn.gelu's approximate=True constants, as fp32 values
_GELU_C = float(np.float32(np.sqrt(2 / np.pi)))
_GELU_A = float(np.float32(0.044715))


def _gelu_tanh(x: Tensor) -> Tensor:
    return torch.tanh(_GELU_C * (x + _GELU_A * (x * (x * x))))


def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu (approximate=True) in its own order:
    # x * (0.5 * (1 + tanh(c * (x + a * x^3)))), x^3 as x * (x * x)
    # (F.gelu(approximate="tanh") rounds differently; XLA's CPU build
    # fuses x + a * x^3 into one FMA and its tanh differs by a few ulps)
    return x * (0.5 * (1.0 + _gelu_tanh(x)))


def _dgelu(x: Tensor) -> Tensor:
    # jax.grad of that formula, written out in the order its jaxpr takes
    h = _gelu_tanh(x)
    q = (0.5 * x) * (1.0 - h)
    t = _GELU_C * (q + q * h)
    return (0.5 * (1.0 + h) + t) + (_GELU_A * t) * (3.0 * (x * x))


_ACT = {"silu": (_silu, _dsilu),
        "gelu": (_gelu, _dgelu),
        "relu": (torch.relu, lambda x: (x > 0).float()),
        "none": (lambda x: x, None)}


def _act_backward(ctx, g):
    """Q_E1 (not in fp32), then the activation derivative: Alg. 2."""
    cfg = ctx.cfg
    if cfg.quantize and cfg.quant_e1:
        g = cfg.e1.make()(g)          # Q_E1: e0 = SQ(e4^{l+1})   (Eq. 15)
    if ctx.dfn is not None:
        (x,) = ctx.saved_tensors
        g = g * ctx.dfn(x)            # e1 = e0 * dACT            (Alg. 2)
    return g


class _QAct(torch.autograd.Function):
    """Native activation + Q_A forward; Q_E1 then the activation
    derivative backward.  Outputs (carrier, payload, scale); only the
    carrier is differentiable."""

    @staticmethod
    def forward(ctx, x, cfg, act):
        fn, dfn = _ACT[act]
        ctx.cfg, ctx.dfn = cfg, dfn
        if dfn is not None:
            ctx.save_for_backward(x)
        qt = cfg.a.make().quantize(fn(x))
        carrier = qt.dequantize()
        ctx.mark_non_differentiable(qt.data, qt.scale)
        return carrier, qt.data, qt.scale

    @staticmethod
    def backward(ctx, g, _gd, _gs):
        return _act_backward(ctx, g), None, None


def _float_act(cfg: QConfig, act: str, x: Tensor) -> Tensor:
    """sim: the grid value of Q_A(act(x)); fp32: act(x)."""
    y = _ACT[act][0](x)
    if cfg.quantize and cfg.quant_a:
        return _grid(cfg.a.make(), y)
    return y


class _FloatAct(torch.autograd.Function):
    """sim / fp32 activation (`_float_act`); backward as `_QAct`'s."""

    @staticmethod
    def forward(ctx, x, cfg, act):
        ctx.cfg, ctx.dfn = cfg, _ACT[act][1]
        if ctx.dfn is not None:
            ctx.save_for_backward(x)
        return _float_act(cfg, act, x)

    @staticmethod
    def backward(ctx, g):
        return _act_backward(ctx, g), None, None


def qact(cfg: QConfig, act: str, x):
    """activation + Q_A.  Native: a QTensor (the int8 payload is what
    downstream dots consume; its carrier is the differentiable fp32 view).
    sim and fp32: an fp32 tensor, the grid value (sim) or the activation
    (fp32)."""
    x = qt_carrier(x)
    if not cfg.native:
        if torch.is_grad_enabled() and x.requires_grad:
            return _FloatAct.apply(x, cfg, act)
        return _float_act(cfg, act, x)
    if not cfg.quant_a:
        return _ACT[act][0](x)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return cfg.a.make().quantize(_ACT[act][0](x))    # serving: no carrier
    carrier, data, scale = _QAct.apply(x, cfg, act)
    return QTensor(data, scale, cfg.a.k, carrier=carrier)


# --------------------------------------------------------------------------
# quantized einsum
# --------------------------------------------------------------------------


def _bwd_specs(spec: str):
    ins, out = spec.split("->")
    a_s, b_s = ins.split(",")
    for idx in a_s + b_s:
        if idx not in out and not (idx in a_s and idx in b_s):
            raise ValueError(f"unsupported einsum {spec}")
    return f"{out},{b_s}->{a_s}", f"{a_s},{out}->{b_s}"


def _mergeable(t: Tensor, spec: str, axes) -> bool:
    """Do `axes` of t (named by `spec`), in this order, form one strided
    axis (so a reshape that joins them is a view)?"""
    for c, d in zip(axes, axes[1:]):
        i, j = spec.index(c), spec.index(d)
        if t.shape[i] != 1 and t.shape[j] != 1 \
                and t.stride(i) != t.stride(j) * t.shape[j]:
            return False
    return True


def _int_contract(spec: str, a8: Tensor, b8: Tensor) -> Tensor:
    """Integer contraction as ONE (batched) qmatmul launch on views of the
    payloads: the axes both operands and the output share become the
    batch, a's other output axes the rows, b's the columns, the shared
    non-output axes the depth.

    A group of rows, columns or depth whose strides do not join into one
    axis (the attention's (s, g) rows or depth) keeps its largest axis;
    the others join the batch, broadcast over the operand that lacks them,
    or, for depth, summed after the product (an int64 sum wrapped to int32:
    the exact sum modulo 2^32, as one int32 accumulator gives).  So the
    operands reach ops.qmatmul as permuted views of the payloads, never as
    copies."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    batch = [c for c in out if c in sa and c in sb]
    depth = [c for c in sa if c in sb and c not in out]
    fa = [c for c in sa if c not in sb]
    fb = [c for c in sb if c not in sa]
    size = {c: a8.shape[sa.index(c)] for c in sa}
    size.update({c: b8.shape[sb.index(c)] for c in sb})

    def split(group, holders):
        if len(group) < 2 or all(_mergeable(t, s_, group)
                                 for t, s_ in holders):
            return group, []
        keep = max(group, key=lambda c: size[c])
        return [keep], [c for c in group if c != keep]

    fa, pa = split(fa, [(a8, sa)])
    fb, pb = split(fb, [(b8, sb)])
    depth, pd = split(depth, [(a8, sa), (b8, sb)])
    lead = batch + pd + pa + pb

    def arrange(t, s_, rows, cols):
        held = [c for c in lead if c in s_]
        v = t.permute([s_.index(c) for c in held + rows + cols])
        return v.reshape([size[c] if c in s_ else 1 for c in lead]
                         + [math.prod(size[c] for c in rows),
                            math.prod(size[c] for c in cols)])

    y = ops.qmatmul(arrange(a8, sa, fa, depth), arrange(b8, sb, depth, fb))
    y = y.reshape([size[c] for c in lead + fa + fb])
    if pd:
        y = y.sum([len(batch) + i for i in range(len(pd))]).to(torch.int32)
    order = batch + pa + pb + fa + fb
    return y.permute([order.index(c) for c in out])


def _qt_contract(contract, qa: QTensor, qb: QTensor) -> Tensor:
    """Sum of integer dots over the operands' plane products, rescaled:
    `contract` is an einsum spec or a function (a_data, b_data) -> int32."""
    if isinstance(contract, str):
        spec = contract
        contract = lambda a, b: _int_contract(spec, a, b)  # noqa: E731
    y = None
    for a_data, a_scale in qa.planes():
        for b_data, b_scale in qb.planes():
            t = contract(a_data, b_data).float() * (a_scale * b_scale)
            y = t if y is None else y + t
    return y


def _fwd_quantize(cfg: QConfig, x, weight_side: bool) -> QTensor:
    """Native operand entry: QTensors pass through untouched (no
    re-decomposition); raw fp32 carriers are decomposed exactly once by the
    grid quantizer (k_W wide on the weight side, k_A otherwise)."""
    if isinstance(x, QTensor):
        return x.drop_carrier()
    k = cfg.k_w if weight_side else cfg.k_a
    with torch.no_grad():
        return get_quantizer("grid", k).quantize(x)


def _error_quantizer(cfg: QConfig, e_kind):
    """Registry lookup for Q_E2: QuantSpec | legacy string | "default"."""
    if cfg.quant_e2:
        quantizer = resolve_quantizer(
            cfg.e2 if e_kind == "default" else e_kind, cfg.k_e2)
        if quantizer.name != "none":
            return quantizer
    return get_quantizer("none")


def _fusable(q) -> bool:
    return (isinstance(q, QTensor) and q.lo is None
            and q.data.dtype == torch.int8 and q.data.dim() == 2)


def _fused_bwd(spec, quantizer, g, a_s, b_s, want_a, want_b):
    """Fused-prologue backward (K3), or None where it does not apply: the
    canonical 2-D spec with single-plane int8 residuals.  Only the
    quantizer's scale reduction (at most ONE amax, shared by both dots)
    runs here; the error payload is made inside the kernels."""
    if spec != "mk,kn->mn" or g.dim() != 2:
        return None
    if (want_a and not _fusable(b_s)) or (want_b and not _fusable(a_s)):
        return None
    plan = quantizer.fused_plan(g)
    if plan is None:
        return None
    mode, steps, k = plan
    inv = 1.0 / steps[0]                       # pow2: exact reciprocal
    s2 = steps[1] if len(steps) > 1 else torch.zeros_like(steps[0])
    da = db = None
    if want_a:    # e4 = W^T e3, Q_E2 in the kernel prologue (Alg. 2)
        scal = torch.stack([inv, steps[0] * b_s.scale, s2 * b_s.scale])
        da = ops.dgrad(g, b_s.data, scal, mode=mode, k=k)
    if want_b:    # g_W = e3 x0^T, same fused prologue (Alg. 2)
        scal = torch.stack([inv, steps[0] * a_s.scale, s2 * a_s.scale])
        db = ops.wgrad(a_s.data, g, scal, mode=mode, k=k)
    return da, db


class _QEinsum(torch.autograd.Function):
    """Forward on the payloads; backward Q_E2 + both integer dots."""

    @staticmethod
    def forward(ctx, a_in, b_in, cfg, spec, e_kind, qa, qb):
        ctx.cfg, ctx.spec, ctx.e_kind = cfg, spec, e_kind
        ctx.ks = save_qtensors(ctx, qa, qb)
        return _qt_contract(spec, qa, qb)

    @staticmethod
    def backward(ctx, g):
        want_a, want_b = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        a_s, b_s = saved_qtensors(ctx, ctx.ks)
        spec = ctx.spec
        quantizer = _error_quantizer(ctx.cfg, ctx.e_kind)
        g = g.contiguous()
        fused = _fused_bwd(spec, quantizer, g, a_s, b_s, want_a, want_b)
        if fused is not None:
            da, db = fused
        else:
            da_spec, db_spec = _bwd_specs(spec)
            gq = quantizer.quantize(g)        # e3 = Q_E2(e2), decomposed once
            da = _qt_contract(da_spec, gq, b_s) if want_a else None
            db = _qt_contract(db_spec, a_s, gq) if want_b else None
        return da, db, None, None, None, None, None


def fp32_matmul(t: Tensor, what: str = "qeinsum: the sim and fp32 "
                "products") -> None:
    """fp32 products (sim and fp32 qeinsums, Mamba2's SSD einsums) run in
    full fp32 or not at all: raise on the card when cuBLAS's TF32 is on."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} must run in full fp32, but "
            "torch.backends.cuda.matmul.allow_tf32 is on")


class _FloatEinsum(torch.autograd.Function):
    """sim / fp32: the einsum of the fp32 carriers; backward Q_E2 on the
    error (sim only), then both fp32 einsums."""

    @staticmethod
    def forward(ctx, a, b, cfg, spec, e_kind):
        fp32_matmul(a)
        ctx.cfg, ctx.spec, ctx.e_kind = cfg, spec, e_kind
        ctx.save_for_backward(a, b)
        return torch.einsum(spec, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if ctx.cfg.quantize:          # e3 = Q_E2(e2)
            g = _error_quantizer(ctx.cfg, ctx.e_kind)(g)
        da_spec, db_spec = _bwd_specs(ctx.spec)
        da = torch.einsum(da_spec, g, b) if ctx.needs_input_grad[0] else None
        db = torch.einsum(db_spec, a, g) if ctx.needs_input_grad[1] else None
        return da, db, None, None, None


def _grad_input(x):
    """What the gradient of an operand lands on: a QTensor's carrier (None
    for a payload without one, e.g. the KV cache), or the tensor itself."""
    if isinstance(x, QTensor):
        return x.carrier
    return x


def qeinsum(cfg: QConfig, spec: str, e_kind, b_weight: bool, a, b) -> Tensor:
    """y = einsum(spec, a, b) with WAGEUBN forward/backward quantization.

    `a`/`b`: fp32 grid carriers or QTensors (whose payloads feed the
    integer dots directly in native mode; sim and fp32 take their fp32
    views).  `e_kind` selects Q_E2: a QuantSpec, a registered/legacy name
    ("flag8" | "sq16" | "sq8" | "none"), or "default" (cfg.e2).
    `b_weight` marks b as a Q_W weight (k_W-wide grid decomposition for
    raw arrays, native)."""
    if not cfg.native:
        return _FloatEinsum.apply(qt_carrier(a), qt_carrier(b), cfg, spec,
                                  e_kind)
    qa = _fwd_quantize(cfg, a, False)
    qb = _fwd_quantize(cfg, b, b_weight)
    return _QEinsum.apply(_grad_input(a), _grad_input(b), cfg, spec, e_kind,
                          qa, qb)


def qdense(cfg: QConfig, x, w: Tensor, e_kind="default") -> Tensor:
    """x @ Q_W(w): the Conv step of Alg. 1 for matmul architectures.

    x: (..., K) on the activation grid (Tensor or QTensor); w: (K, N) master
    weights.  Returns (..., N) fp32."""
    wq = qweight(cfg, w)
    xm = x.reshape(-1, x.shape[-1])
    y = qeinsum(cfg, "mk,kn->mn", e_kind, True, xm, wq)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# --------------------------------------------------------------------------
# quantized convolution (ResNet reproduction)
# --------------------------------------------------------------------------


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX's "SAME" padding of one spatial axis: out = ceil(size / stride),
    total = max((out - 1) * stride + k - size, 0), split (total // 2,
    total - total // 2): asymmetric, e.g. (0, 1) for a 3x3 stride-2 window
    over an even size, which no symmetric `padding=` of PyTorch gives."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: Tensor, kh: int, kw: int, stride: int,
             value: float = 0.0) -> Tensor:
    """x (N, H, W, C) padded for a "SAME" (kh, kw) window at `stride`."""
    (t, b), (lft, r) = (same_pads(x.shape[1], kh, stride),
                        same_pads(x.shape[2], kw, stride))
    if t == b == lft == r == 0:
        return x
    return F.pad(x, (0, 0, lft, r, t, b), value=value)


def _nchw(x: Tensor) -> Tensor:
    """NHWC -> an NCHW view (a channels_last tensor: cuDNN needs no copy)."""
    return x.permute(0, 3, 1, 2)


def _oihw(w: Tensor) -> Tensor:
    """HWIO weight -> the OIHW view conv2d takes."""
    return w.permute(3, 2, 0, 1)


def conv_valid(xp: Tensor, w: Tensor, stride: int) -> Tensor:
    """Unpadded convolution of an NHWC input with an HWIO weight -> NHWC."""
    return F.conv2d(_nchw(xp), _oihw(w), stride=stride).permute(0, 2, 3, 1)


def _conv_error(cfg: QConfig, g: Tensor) -> Tensor:
    """Q_E2 on the convolution's incoming error, as the reference's
    `_qconv_bwd`: none in fp32; the formula in sim; in native, single-plane
    affine formats of k <= 8 decompose through the quantize kernel (K2)
    and are consumed as their grid value, while the flag format (full8)
    and wide formats (sq16, e2_16) take the one-pass formula.  Both give
    the same grid value (the registry's invariant)."""
    if not cfg.quantize:
        return g
    quantizer = _error_quantizer(cfg, "default")
    if not cfg.native:
        return quantizer(g)
    plan = quantizer.fused_plan(g)
    if plan is not None and plan[0] == "affine" and plan[2] <= 8 \
            and quantizer.name != "none":
        return quantizer.quantize(g).dequantize()
    return quantizer(g)                  # e3 = Q_E2(e2)


class _QConv(torch.autograd.Function):
    """Convolution of the padded carriers; backward Q_E2, then both
    convolution gradients (cropping the padding is the F.pad outside)."""

    @staticmethod
    def forward(ctx, xp, w, cfg, stride):
        if xp.is_cuda and torch.backends.cudnn.allow_tf32:
            raise RuntimeError(
                "qconv: torch.backends.cudnn.allow_tf32 is on; the "
                "convolution of grid values must run in full fp32")
        ctx.cfg, ctx.stride = cfg, stride
        ctx.save_for_backward(xp, w)
        return conv_valid(xp, w, stride)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        e3 = _conv_error(ctx.cfg, g.contiguous())
        gx, gw, _ = torch.ops.aten.convolution_backward(
            _nchw(e3), _nchw(xp), _oihw(w), None, [ctx.stride] * 2, [0, 0],
            [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        gx = None if gx is None else gx.permute(0, 2, 3, 1)
        gw = None if gw is None else gw.permute(2, 3, 1, 0)
        return gx, gw, None, None


def qconv(cfg: QConfig, x, wq, stride: int) -> Tensor:
    """Quantized convolution with JAX's "SAME" padding: x (N, H, W, Cin) on
    the activation grid (Tensor or QTensor), wq (kh, kw, Cin, Cout) the
    Q_W weight (QTensor from qweight, or its carrier).  The arithmetic
    runs on the exact grid values in fp32 (the reference's carrier);
    backward errors go through Q_E2.  Returns (N, Ho, Wo, Cout) fp32."""
    w = qt_carrier(wq)
    xp = pad_same(qt_carrier(x), w.shape[0], w.shape[1], stride)
    return _QConv.apply(xp, w, cfg, stride)
