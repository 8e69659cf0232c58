"""seamless-m4t-large-v2 [audio]: 24 + 24 layers, d_model=1024, 16H (kv=16)
of 64, d_ff=8192, vocab=256206: the enc-dec backbone (the reference
package's configs/seamless_m4t_large_v2.py).  The audio frontend is a stub:
the encoder takes precomputed frame embeddings (B, S, d_model)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=0, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256206, head_dim=64, norm="layernorm", act="gelu",
    enc_layers=24, dec_layers=24, tgt_ratio=4,
    source="arXiv:2308.11596; hf",
)
