"""Quantized normalization (paper Eq. 11-13), fused forward through UBN.

Port of `repro.core.qnorm`.  In native mode the forward of every norm is
the ubn_norm kernel (K4): statistics, normalize, and the five direct quantizations
Q(mu), Q(sigma), Q_BN, Q(gamma), Q(beta) (per row for RMSNorm and
LayerNorm, per channel over the whole batch for BN).  The backward, as in
the reference, is autograd of the unfused body (`_qbatchnorm_unfused`,
`_qrmsnorm_unfused`, `_qlayernorm_unfused`) re-run at the saved inputs:
every quantizer there is a straight-through direct quantizer, so autograd
through the body IS the paper's quantized backward evaluated on grid
values.  Q_E2 on the outgoing error is applied by the adjacent qeinsum or
qconv.  sim mode (and native with `quant_bn` off) runs the unfused body
forward too, as the reference's does; in fp32 mode every quantizer of the
body is the identity, so it is plain BN.  `batchnorm` is that plain BN,
the ResNet's exempt stem's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from . import qfuncs as qf
from .qconfig import FP32, QConfig
from .qtensor import get_quantizer, qt_carrier

Tensor = torch.Tensor

EPS_Q = 2.0 ** -8  # epsilon_q: small fixed-point value (Eq. 12)


def _qs(cfg: QConfig, t: Tensor, k: int) -> Tensor:
    """Direct-quantize with STE when BN quantization is on."""
    if not cfg.quantize or not cfg.quant_bn:
        return t
    return qf.ste(get_quantizer("direct", k), t)


def _maybe_stop(cfg: QConfig, t: Tensor) -> Tensor:
    return t if cfg.norm_full_bwd else t.detach()


def _qbatchnorm_unfused(cfg: QConfig, x: Tensor, gamma: Tensor,
                        beta: Tensor) -> Tensor:
    dims = tuple(range(x.dim() - 1))
    mu = _maybe_stop(cfg, torch.mean(x, dim=dims))
    var = _maybe_stop(cfg, torch.mean(torch.square(x), dim=dims)
                      - torch.square(mu))
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    mu_q = _qs(cfg, mu, cfg.k_mu)
    sigma_q = _qs(cfg, sigma, cfg.k_sigma)
    xhat = (x - mu_q) / (sigma_q + EPS_Q)
    xhat = _qs(cfg, xhat, cfg.k_bn)                        # Q_BN
    gamma_q = _qs(cfg, gamma, cfg.k_gamma)
    beta_q = _qs(cfg, beta, cfg.k_beta)
    return gamma_q * xhat + beta_q


def _qrmsnorm_unfused(cfg: QConfig, x: Tensor, gamma: Tensor) -> Tensor:
    ms = _maybe_stop(cfg, torch.mean(torch.square(x), dim=-1, keepdim=True))
    sigma = torch.sqrt(ms)
    sigma_q = _qs(cfg, sigma, cfg.k_sigma)
    xhat = x / (sigma_q + EPS_Q)
    xhat = _qs(cfg, xhat, cfg.k_bn)
    gamma_q = _qs(cfg, gamma, cfg.k_gamma)
    return gamma_q * xhat


def _qlayernorm_unfused(cfg: QConfig, x: Tensor, gamma: Tensor,
                        beta: Tensor) -> Tensor:
    mu = _maybe_stop(cfg, torch.mean(x, dim=-1, keepdim=True))
    var = _maybe_stop(cfg, torch.mean(torch.square(x), dim=-1, keepdim=True)
                      - torch.square(mu))
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    mu_q = _qs(cfg, mu, cfg.k_mu)
    sigma_q = _qs(cfg, sigma, cfg.k_sigma)
    xhat = (x - mu_q) / (sigma_q + EPS_Q)
    xhat = _qs(cfg, xhat, cfg.k_bn)
    gamma_q = _qs(cfg, gamma, cfg.k_gamma)
    beta_q = _qs(cfg, beta, cfg.k_beta)
    return gamma_q * xhat + beta_q


_UNFUSED = {"batch": _qbatchnorm_unfused, "rms": _qrmsnorm_unfused,
            "layer": _qlayernorm_unfused}

def _ubn_widths(cfg: QConfig) -> dict:
    return dict(k_mu=cfg.k_mu, k_sigma=cfg.k_sigma, k_bn=cfg.k_bn,
                k_gamma=cfg.k_gamma, k_beta=cfg.k_beta, eps=EPS_Q)


class _FusedNorm(torch.autograd.Function):
    """K4 forward; backward = autograd of the unfused body."""

    @staticmethod
    def forward(ctx, x, gamma, beta, cfg, kind):
        ctx.cfg, ctx.kind = cfg, kind
        ctx.save_for_backward(x, gamma, beta)
        y = ops.ubn_norm(x.reshape(-1, x.shape[-1]), gamma, beta, kind=kind,
                         **_ubn_widths(cfg))
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        ins = [t.detach().requires_grad_() for t in (x, gamma)]
        if beta is not None:
            ins.append(beta.detach().requires_grad_())
        with torch.enable_grad():
            y = _UNFUSED[ctx.kind](ctx.cfg, *ins)
            grads = torch.autograd.grad(y, ins, g)
        beta_g = grads[2] if beta is not None else None
        return grads[0], grads[1], beta_g, None, None


def _norm(cfg: QConfig, kind: str, x, gamma, beta):
    x = qt_carrier(x)
    if not (cfg.native and cfg.quant_bn):
        args = (x, gamma) if kind == "rms" else (x, gamma, beta)
        return _UNFUSED[kind](cfg, *args)
    return _FusedNorm.apply(x, gamma, beta, cfg, kind)


def qbatchnorm(cfg: QConfig, x, gamma: Tensor, beta: Tensor) -> Tensor:
    """Quantized BN over all axes but the last (channel), paper Eq. 12."""
    return _norm(cfg, "batch", x, gamma, beta)


def batchnorm(x, gamma: Tensor, beta: Tensor) -> Tensor:
    """Plain fp32 BN (statistics over all axes but the last, eps_q added
    to sigma), autograd through mean and variance: the exempt ResNet
    stem's BN, the reference's qbatchnorm(FP32, ...)."""
    return _qbatchnorm_unfused(FP32, qt_carrier(x), gamma, beta)


def qrmsnorm(cfg: QConfig, x, gamma: Tensor) -> Tensor:
    """Quantized RMSNorm: the BN recipe with per-token stats, no mean."""
    return _norm(cfg, "rms", x, gamma, None)


def qlayernorm(cfg: QConfig, x, gamma: Tensor, beta: Tensor) -> Tensor:
    """Quantized LayerNorm (per-token mean + var), same widths as BN."""
    return _norm(cfg, "layer", x, gamma, beta)
