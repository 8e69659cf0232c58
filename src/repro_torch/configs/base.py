"""Architecture configuration schema (the fields the ported families read).

Mirrors `repro.configs.base.ArchConfig` for the decoder-only LMs (families
"lm" and "vlm"), the MoE LMs ("moe"), the Mamba1 SSM, the Mamba2 hybrid
("hybrid"), the encoder-decoder ("encdec") and the ResNet: the same field
names and defaults, `dh`, `d_inner`, `vocab_padded` and `reduced()`, so a
configuration reads the same in both packages.  The reference's dry-run
metadata (`shapes`, `skip_notes`) is not kept.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # lm | vlm | moe | ssm | hybrid | encdec
                                 # | resnet
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"
    rope_theta: float = 1e4
    # MoE: experts, experts per token, and the capacity factor of the
    # dispatch (cap = ceil(T * topk / experts * capacity_factor))
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    # attention chunking of the training forward: the quantization chunks
    # of the flash kernel (each per-chunk decomposition's amax spans one)
    q_chunk: int = 1024
    kv_chunk: int = 512
    # SSM (mamba1, and mamba2: SSD heads of `headdim` channels)
    ssm_state: int = 0
    ssm_kind: str = ""           # mamba1 | mamba2
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    # SSM sequence chunk: Mamba2's SSD chunk scan runs over chunks of it;
    # Mamba1's is the reference's associative-scan chunk (the port's Mamba1
    # scan is sequential, ops.selective_scan, so there it is kept for
    # parity), as is unroll_scan_chunks (a lax.scan option)
    scan_chunk: int = 256
    unroll_scan_chunks: bool = False
    # remat policy for the layer loop: "full" (checkpoint every layer)
    # or "none" (save everything; trades HBM for recompute)
    remat: str = "full"
    # hybrid (zamba2): one shared attention block after every `attn_every`
    # Mamba2 layers
    attn_every: int = 0
    # enc-dec: encoder and decoder depths, and the target length as a
    # fraction of the source's (tgt_len = seq_len // tgt_ratio)
    enc_layers: int = 0
    dec_layers: int = 0
    tgt_ratio: int = 4
    # resnet
    block: str = ""              # basic | bottleneck
    stage_sizes: tuple = ()
    num_classes: int = 1000
    img_size: int = 224
    source: str = ""

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """vocab padded to a multiple of 512 (the reference's TP padding)."""
        return ((self.vocab + 511) // 512) * 512

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's sizes:
        2 layers, width 64, 4 heads / 2 KV heads of width 16, chunks 16;
        4 experts, top-2, for an MoE; an SSM state of 4 and SSD heads of 8;
        a shared block after every layer of 2 for the hybrid; 2 encoder and
        2 decoder layers for an enc-dec; a ResNet keeps
        one block in each of its first two stages, 10 classes and 16 px
        images)."""
        if self.family == "resnet":
            return self.replace(name=self.name + "-smoke", stage_sizes=(1, 1),
                                num_classes=10, img_size=16)
        kw = dict(
            n_layers=min(self.n_layers, 2), d_model=64, n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv else 0,
            d_ff=96 if self.d_ff else 0, vocab=min(self.vocab, 128),
            head_dim=16, q_chunk=16, kv_chunk=16)
        if self.moe_experts:
            kw.update(moe_experts=4, moe_topk=2)
        if self.ssm_state:
            kw.update(ssm_state=4, headdim=8)
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.enc_layers:
            kw.update(enc_layers=2, dec_layers=2)
        return self.replace(name=self.name + "-smoke", **kw)
