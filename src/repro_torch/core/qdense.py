"""Quantized forward ops of the serving slice, QTensor-native.

Port of `repro.core.qdense`, forward only (serving has no backward, so no
`autograd.Function` is needed yet; the Alg. 2 backward comes with the
training step, ROADMAP Queue 1 item 1):

  qweight      Q_W through cfg.w (fixed 2^(1-k_W) scale, no amax pass)
  qact         activation + Q_A through cfg.a -> QTensor
  qprobs       attention probabilities onto the k_A grid
  qdense       x @ Q_W(w): every 2-D integer dot goes through the qmatmul
               kernel (K1)
  _qt_contract sum of integer dots over the operands' planes, rescaled
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from . import qfuncs as qf
from .qconfig import QConfig
from .qtensor import QTensor, get_quantizer, qt_carrier

Tensor = torch.Tensor


def qweight(cfg: QConfig, w: Tensor) -> QTensor:
    """Q_W (Eq. 10): the int8 payload of the fp32 master weight, decomposed
    on every forward (as the reference does; caching it is later work)."""
    return cfg.w.make().quantize(w)


def qprobs(cfg: QConfig, p: Tensor) -> Tensor:
    """Attention probabilities onto the k_A grid (in [0,1], exact range)."""
    return qf.q_direct(p, cfg.k_a)


def _silu(x: Tensor) -> Tensor:
    # jax.nn.silu's formula, x * sigmoid(x) (F.silu rounds differently)
    return x * torch.sigmoid(x)


_ACT = {"silu": _silu, "relu": torch.relu, "none": lambda x: x}


def qact(cfg: QConfig, act: str, x) -> QTensor:
    """activation + Q_A; the int8 payload is what downstream dots consume."""
    return cfg.a.make().quantize(_ACT[act](qt_carrier(x)))


def _fwd_quantize(cfg: QConfig, x, k: int) -> QTensor:
    """QTensors pass through untouched (no re-decomposition); raw fp32
    carriers are decomposed exactly once by the grid quantizer."""
    if isinstance(x, QTensor):
        return x.drop_carrier()
    return get_quantizer("grid", k).quantize(x)


def _qt_contract(contract, qa: QTensor, qb: QTensor) -> Tensor:
    """Sum of integer dots over the operands' plane products, rescaled:
    `contract(a_data, b_data)` returns the int32 dot."""
    y = None
    for a_data, a_scale in qa.planes():
        for b_data, b_scale in qb.planes():
            t = contract(a_data, b_data).float() * (a_scale * b_scale)
            y = t if y is None else y + t
    return y


def qdense(cfg: QConfig, x, w: Tensor) -> Tensor:
    """x @ Q_W(w): the Conv step of Alg. 1 for matmul architectures.

    x: (..., K) on the activation grid (Tensor or QTensor); w: (K, N) master
    weights.  Returns (..., N) fp32."""
    wq = qweight(cfg, w)
    xm = x.reshape(-1, x.shape[-1])
    qa = _fwd_quantize(cfg, xm, cfg.k_a)
    y = _qt_contract(ops.qmatmul, qa, wq)
    return y.reshape(*x.shape[:-1], w.shape[-1])
