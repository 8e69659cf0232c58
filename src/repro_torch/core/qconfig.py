"""Quantization configuration for the WAGEUBN framework.

Port of `repro.core.qconfig.QConfig`.  Bit-width names follow the paper
(Yang et al. 2019, §III-B/§IV-A):
  k_W, k_A, k_GW, k_E1, k_E2  weights / activations / weight-grad (dr bits) /
                              error at layer boundary / error before matmul
  k_GC                        constant scale bits of CQ (Eq. 7)
  k_BN, k_mu, k_sigma, k_gamma, k_beta   BN / norm operand widths (Eq. 13)
  k_Ggamma, k_Gbeta           gamma/beta gradient widths (Eq. 18)
  k_Mom, k_Acc, k_lr, k_WU    Momentum optimizer + update widths (Eq. 19-24)

Per-path quantizers are `QuantSpec`s resolved through the registry
(`qtensor.py`): `w`/`a`/`e1`/`e2`/`e_attn`/`g`.  `e2_kind`/`e_attn_kind`
are the reference's deprecated string aliases, reconciled with the specs in
`__post_init__` exactly as the reference does.

Three numeric modes, as in the reference:

  native  int8/int16 QTensor payloads with pow2 scales, integer dots (K1,
          K3), the fused norm (K4) and attention (K5, K6) kernels;
  sim     the same quantizers, their grid values carried in fp32: the
          matmuls are fp32 einsums of the grid values (exact wherever
          every partial sum is), the norms and attention the unfused
          bodies;
  fp32    every quantizer the identity: the vanilla float baseline the
          paper compares against.

The default mode is "native", where the reference's is "sim": a bare
`QConfig()` or `preset(name)` is what every caller of the port builds its
kernel paths from, and a sim default would quietly take each of them off
K1, K3, K4, K5 and K6.  Pass `mode="sim"` for the reference's default.

`fuse_kernels` (default True, as in the reference) picks native decode
attention's route: the fused paged_attention kernel (K6), or
gather-then-attend (page_gather, K7, then `decode_attention`, whose dots
run on K1), the same bits either way.  Unlike the reference's, it leaves
the other native ops alone: the attention forward of training and of
monolithic prefill always runs the flash kernel (K5), the norms K4 and the
backward dots K3.  Presets: `full8` and `e2_16` (the paper's two
versions), `fp32` (mode fp32) and the bit-width lanes `w4a8`, `a4` and
`g16`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .qtensor import QuantSpec, legacy_kind, spec_from_alias

# legacy single-width fields <-> structured spec fields
_WIDTH_TO_SPEC = {"k_w": "w", "k_a": "a", "k_e1": "e1", "k_e2": "e2",
                  "k_gc": "g"}

MODES = ("fp32", "sim", "native")


@dataclass(frozen=True)
class QConfig:
    # "fp32" (vanilla), "sim" (grid values carried in fp32) or "native"
    # (QTensor int8/int16 payloads + pow2 scales, integer dots); the
    # default differs from the reference's "sim" (see the module docstring)
    mode: str = "native"

    # --- forward-path widths ---
    k_w: int = 8
    k_a: int = 8
    k_bn: int = 16
    k_mu: int = 16
    k_sigma: int = 16
    k_gamma: int = 8
    k_beta: int = 8

    # --- error-path widths (backward) ---
    k_e1: int = 8            # Q_E1 = shift-quantization at layer boundaries
    k_e2: int = 8            # Q_E2 before weight matmuls (flag or 16-bit)

    # --- structured per-path quantizer specs (registry-resolved) ---
    w: QuantSpec = field(default=QuantSpec("clip", 8))       # Q_W  (Eq. 10)
    a: QuantSpec = field(default=QuantSpec("scaled", 8))     # Q_A  (Eq. 14)
    e1: QuantSpec = field(default=QuantSpec("sq", 8))        # Q_E1 (Eq. 15)
    e2: QuantSpec = field(default=QuantSpec("flag", 8))      # Q_E2 (Eq. 17)
    e_attn: QuantSpec = field(default=QuantSpec("sq", 8))    # act-act matmuls
    g: QuantSpec = field(default=QuantSpec("cq", 15))        # CQ   (Eq. 7)

    # deprecated string aliases; after __post_init__ they hold the
    # canonical legacy names of the specs
    e2_kind: str | None = None
    e_attn_kind: str | None = None

    # --- gradient / optimizer widths ---
    k_gw: int = 8            # CQ dr bits: the base of the shrink schedule
    k_gc: int = 15           # constant scale bits of CQ
    k_ggamma: int = 15
    k_gbeta: int = 15
    k_mom: int = 3
    k_acc: int = 13
    k_lr: int = 10
    k_wu: int = 24           # master-weight grid (init, paper Eq. 9)
    stochastic_g: bool = True  # stochastic rounding inside CQ (Eq. 7)

    # norm backward: autodiff through the statistics (True) or the paper's
    # elementwise 1/sigma approximation (False)
    norm_full_bwd: bool = True

    # per-path switches (paper Table II single-path sensitivity runs)
    quant_w: bool = True
    quant_a: bool = True
    quant_bn: bool = True
    quant_g: bool = True
    quant_e1: bool = True
    quant_e2: bool = True
    quant_u: bool = True

    # carrier dtype of the Mamba1 scan's inputs and state in train and
    # chunk modes: "bf16" selects bf16 carriers (K9 / K9b keep h in fp32
    # and round their outputs to bf16), anything else fp32; decode stays
    # fp32 (models/ssm.py mamba1_block)
    scan_dtype: str = "f32"

    # paged decode attention through the fused kernel (K6) or gather-then-
    # attend (K7 + K1)
    fuse_kernels: bool = True

    def __post_init__(self):
        set_ = lambda n, v: object.__setattr__(self, n, v)  # noqa: E731
        # a string alias wins only when it differs from its spec's own
        # canonical name (a carried-through canonical string must not
        # rebuild the spec)
        e2_str = self.e2_kind
        if e2_str is not None and e2_str != legacy_kind(self.e2):
            set_("e2", spec_from_alias(e2_str, self.k_e2))
        if (self.e_attn_kind is not None
                and self.e_attn_kind != legacy_kind(self.e_attn)):
            set_("e_attn", spec_from_alias(self.e_attn_kind, self.e_attn.k))
        # an explicitly configured spec wins; an untouched default spec
        # inherits its width field; a present e2 string pins e2's width
        for kf, sf in _WIDTH_TO_SPEC.items():
            if sf == "e2" and e2_str is not None:
                set_("k_e2", self.e2.k)
                continue
            spec, kval = getattr(self, sf), getattr(self, kf)
            if spec.k != kval:
                if spec == _DEFAULT_SPECS[sf]:
                    set_(sf, spec.replace(k=kval))
                else:
                    set_(kf, spec.k)
        set_("e2_kind", legacy_kind(self.e2))
        set_("e_attn_kind", legacy_kind(self.e_attn))

    @property
    def quantize(self) -> bool:
        return self.mode != "fp32"

    @property
    def native(self) -> bool:
        return self.mode == "native"

    def replace(self, **kw) -> "QConfig":
        if "e2" in kw and "e2_kind" not in kw:
            kw["e2_kind"] = None
        if "e_attn" in kw and "e_attn_kind" not in kw:
            kw["e_attn_kind"] = None
        for kf, sf in _WIDTH_TO_SPEC.items():
            if kf in kw and sf not in kw:
                kw[sf] = getattr(self, sf).replace(k=kw[kf])
                if sf == "e2" and "e2_kind" not in kw:
                    kw["e2_kind"] = None
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (one of {MODES})")
        # Paper Eq. 22: k_Ggamma = k_Gbeta = k_GC = k_Mom + k_Acc - 1
        if not (self.k_ggamma == self.k_gbeta == self.k_gc
                == self.k_mom + self.k_acc - 1):
            raise ValueError("bit-width closure Eq.(22) violated")
        # Paper Eq. 24: k_WU = k_GC + k_lr - 1
        if self.k_wu != self.k_gc + self.k_lr - 1:
            raise ValueError("bit-width closure Eq.(24) violated")
        for spec in (self.w, self.a, self.e1, self.e2, self.e_attn, self.g):
            spec.make()


_DEFAULT_SPECS = {sf: QConfig.__dataclass_fields__[sf].default
                  for sf in _WIDTH_TO_SPEC.values()}

FULL8 = QConfig()                                   # paper full 8-bit version
E2_16 = QConfig(e2_kind="sq16", k_e2=16)            # paper 16-bit E2 version
FP32 = QConfig(mode="fp32")                         # vanilla baseline

# the bit-width lanes (DESIGN.md §14): each re-widths one registry spec
# through __post_init__, the same quantizer kind at another k
W4A8 = QConfig(k_w=4)      # 4-bit weights: clip@4 on the fixed 2^-3 grid
A4 = QConfig(k_a=4)        # 4-bit activations: scaled@4 (pow2-amax scale)
G16 = QConfig(k_gw=16)     # wide CQ range: dr = 2^15 on int16 payloads

PRESETS = {"full8": FULL8, "e2_16": E2_16, "fp32": FP32, "w4a8": W4A8,
           "a4": A4, "g16": G16}


def preset(name: str, mode: str | None = None) -> QConfig:
    """PRESETS[name], in `mode` when given (else the preset's own: native,
    but fp32 for "fp32")."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r} (one of "
                         f"{sorted(PRESETS)})")
    cfg = PRESETS[name]
    if mode is not None:
        cfg = cfg.replace(mode=mode)
    cfg.validate()
    return cfg
