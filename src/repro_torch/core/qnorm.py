"""Quantized normalization (paper Eq. 11-13), fused forward through UBN.

Port of `repro.core.qnorm`, forward only: in native mode the whole norm
chain (statistics, normalize, and the five direct quantizations Q(mu),
Q(sigma), Q_BN, Q(gamma), Q(beta)) is ONE pass of the ubn_norm kernel (K4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .qconfig import QConfig
from .qtensor import qt_carrier

Tensor = torch.Tensor

EPS_Q = 2.0 ** -8  # epsilon_q: small fixed-point value (Eq. 12)


def _ubn_widths(cfg: QConfig) -> dict:
    return dict(k_mu=cfg.k_mu, k_sigma=cfg.k_sigma, k_bn=cfg.k_bn,
                k_gamma=cfg.k_gamma, k_beta=cfg.k_beta, eps=EPS_Q)


def qrmsnorm(cfg: QConfig, x, gamma: Tensor) -> Tensor:
    """Quantized RMSNorm: the BN recipe with per-token stats, no mean."""
    x = qt_carrier(x)
    y = ops.ubn_norm(x.reshape(-1, x.shape[-1]), gamma, None, kind="rms",
                     **_ubn_widths(cfg))
    return y.reshape(x.shape)


def qlayernorm(cfg: QConfig, x, gamma: Tensor, beta: Tensor) -> Tensor:
    """Quantized LayerNorm (per-token mean + var), same widths as BN."""
    x = qt_carrier(x)
    y = ops.ubn_norm(x.reshape(-1, x.shape[-1]), gamma, beta, kind="layer",
                     **_ubn_widths(cfg))
    return y.reshape(x.shape)
