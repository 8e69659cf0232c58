"""Quantized compute ops with WAGEUBN backward semantics, QTensor-native.

Port of `repro.core.qdense`.  The paper's dataflow (Fig. 5 / Algorithms
1-2) runs through `torch.autograd.Function`s where the reference has
`jax.custom_vjp`s:

  qweight   Q_W through cfg.w (fixed 2^(1-k_W) scale, no amax pass), STE to
            the fp32 master (paper Eq. 1)
  qact      activation + Q_A -> QTensor with a differentiable carrier;
            backward applies Q_E1 (shift quantization, e0) and then the
            activation derivative (e1), exactly Algorithm 2
  qprobs    attention probabilities onto the k_A grid (STE)
  qbn_param Q for norm operands (STE)
  qeinsum   every matmul on integer payloads.  Forward: QTensor operands
            feed their payloads as they are; raw fp32 operands are
            decomposed once.  It saves the int payloads, not the fp32
            carriers.  Backward: Q_E2 on the incoming error (e3), then both
            integer dots of Alg. 2.  For the canonical 2-D spec with
            single-plane int8 residuals, Q_E2 is fused into the dgrad/wgrad
            kernels (K3): one amax here, the error payload never stored.
            Otherwise quantizer.quantize(g) and integer contractions through
            the batched qmatmul kernel (K1).
  qdense    x @ Q_W(w)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from . import qfuncs as qf
from .qconfig import QConfig
from .qtensor import (QTensor, get_quantizer, qt_carrier, quantize_ste,
                      resolve_quantizer)

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# weight / activation / prob quantizers (forward path, STE)
# --------------------------------------------------------------------------


def qweight(cfg: QConfig, w: Tensor):
    """Q_W (Eq. 10): the int8 payload of the fp32 master weight, decomposed
    on every forward (as the reference does; caching it is later work),
    with a carrier whose gradient reaches the master unchanged (STE)."""
    if not cfg.quant_w:
        return w
    return quantize_ste(cfg.w.make(), w)


def qbn_param(cfg: QConfig, p: Tensor, k: int) -> Tensor:
    """Q for norm operands (gamma/beta/mu/sigma, Eq. 13), STE."""
    return qf.ste(get_quantizer("direct", k), p)


def qprobs(cfg: QConfig, p: Tensor) -> Tensor:
    """Attention probabilities onto the k_A grid (in [0,1], exact range)."""
    return qf.ste(get_quantizer("direct", cfg.k_a), p)


def _silu(x: Tensor) -> Tensor:
    # jax.nn.silu's formula, x * sigmoid(x) (F.silu rounds differently)
    return x * torch.sigmoid(x)


def _dsilu(x: Tensor) -> Tensor:
    sg = torch.sigmoid(x)
    return sg * (1.0 + x * (1.0 - sg))


_ACT = {"silu": (_silu, _dsilu),
        "relu": (torch.relu, lambda x: (x > 0).float()),
        "none": (lambda x: x, None)}


class _QAct(torch.autograd.Function):
    """activation + Q_A forward; Q_E1 then the activation derivative
    backward.  Outputs (carrier, payload, scale); only the carrier is
    differentiable."""

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
        cfg = ctx.cfg
        if cfg.quant_e1:
            g = cfg.e1.make()(g)      # Q_E1: e0 = SQ(e4^{l+1})   (Eq. 15)
        if ctx.dfn is not None:
            (x,) = ctx.saved_tensors
            g = g * ctx.dfn(x)        # e1 = e0 * dACT            (Alg. 2)
        return g, None, None


def qact(cfg: QConfig, act: str, x):
    """activation + Q_A -> QTensor (the int8 payload is what downstream
    dots consume; its carrier is the differentiable fp32 view)."""
    x = qt_carrier(x)
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


def _int_contract(spec: str, a8: Tensor, b8: Tensor) -> Tensor:
    """Integer contraction as ONE (batched) qmatmul launch: the axes both
    operands and the output share become the batch, a's other output axes
    the rows, b's the columns, the shared non-output axes the depth."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    batch = [c for c in out if c in sa and c in sb]
    depth = [c for c in sa if c in sb and c not in out]
    fa = [c for c in sa if c not in sb]
    fb = [c for c in sb if c not in sa]
    size = {c: a8.shape[sa.index(c)] for c in sa}
    size.update({c: b8.shape[sb.index(c)] for c in sb})

    def prod(cs):
        n = 1
        for c in cs:
            n *= size[c]
        return n

    a = a8.permute([sa.index(c) for c in batch + fa + depth])
    b = b8.permute([sb.index(c) for c in batch + depth + fb])
    a = a.reshape(prod(batch), prod(fa), prod(depth))
    b = b.reshape(prod(batch), prod(depth), prod(fb))
    if not batch:
        y = ops.qmatmul(a[0].contiguous(), b[0].contiguous())
    else:
        y = ops.qmatmul(a.contiguous(), b.contiguous())
    y = y.reshape([size[c] for c in batch + fa + fb])
    order = batch + fa + fb
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
        ctx.cfg, ctx.spec, ctx.e_kind, ctx.qa, ctx.qb = (cfg, spec, e_kind,
                                                         qa, qb)
        return _qt_contract(spec, qa, qb)

    @staticmethod
    def backward(ctx, g):
        want_a, want_b = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        a_s, b_s, spec = ctx.qa, ctx.qb, ctx.spec
        ctx.qa = ctx.qb = None
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


def _grad_input(x):
    """What the gradient of an operand lands on: a QTensor's carrier (None
    for a payload without one, e.g. the KV cache), or the tensor itself."""
    if isinstance(x, QTensor):
        return x.carrier
    return x


def qeinsum(cfg: QConfig, spec: str, e_kind, b_weight: bool, a, b) -> Tensor:
    """y = einsum(spec, a, b) with WAGEUBN forward/backward quantization.

    `a`/`b`: fp32 grid carriers or QTensors (whose payloads feed the
    integer dots directly).  `e_kind` selects Q_E2: a QuantSpec, a
    registered/legacy name ("flag8" | "sq16" | "sq8" | "none"), or
    "default" (cfg.e2).  `b_weight` marks b as a Q_W weight (k_W-wide grid
    decomposition for raw arrays)."""
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
