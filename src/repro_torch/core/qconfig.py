"""Quantization configuration (the forward widths the serving slice reads).

Port of `repro.core.qconfig.QConfig`, forward subset: the mode, the
forward-path widths and per-path quantizer specs.  The port serves with
the fused kernels (UBN, paged decode attention) only: it has no unfused
route, so the reference's `fuse_kernels` switch has no counterpart.
Bit-width names follow the paper (k_W, k_A, k_BN, k_mu, k_sigma, k_gamma,
k_beta, k_WU).  The error/gradient/optimizer widths arrive with the
training step (ROADMAP Queue 1 item 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .qtensor import QuantSpec


@dataclass(frozen=True)
class QConfig:
    # "native": QTensor int8 payloads + pow2 scales, integer dots.  The
    # port serves native mode only so far; "sim" and "fp32" raise.
    mode: str = "native"

    k_w: int = 8
    k_a: int = 8
    k_bn: int = 16
    k_mu: int = 16
    k_sigma: int = 16
    k_gamma: int = 8
    k_beta: int = 8
    k_wu: int = 24           # master-weight grid (init, paper Eq. 9)

    w: QuantSpec = field(default=QuantSpec("clip", 8))       # Q_W  (Eq. 10)
    a: QuantSpec = field(default=QuantSpec("scaled", 8))     # Q_A  (Eq. 14)

    def replace(self, **kw) -> "QConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.mode != "native":
            raise NotImplementedError(
                f"mode={self.mode!r}: the port serves native mode only (the "
                "sim/fp32 modes come with the training step, ROADMAP Queue 1 "
                "item 1)")
        self.w.make()
        self.a.make()


FULL8 = QConfig()                                   # paper full 8-bit version

PRESETS = {"full8": FULL8}


def preset(name: str, mode: str | None = None) -> QConfig:
    if name not in PRESETS:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet (ported: {sorted(PRESETS)}; "
            "the others come with the training step, ROADMAP Queue 1 item 1)")
    cfg = PRESETS[name]
    if mode is not None:
        cfg = cfg.replace(mode=mode)
    cfg.validate()
    return cfg
