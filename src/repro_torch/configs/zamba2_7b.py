"""zamba2-7b [hybrid]: 81 Mamba2 layers, d_model 3584 (d_inner 7168: 112
SSD heads of 64), ssm_state 64, d_conv 4, and one shared attention + MLP
block (32 query / 32 KV heads of 112, d_ff 14336) after every 6 of them;
vocab 32000 (the reference package's configs/zamba2_7b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, head_dim=112, norm="rmsnorm", act="silu",
    ssm_state=64, ssm_kind="mamba2", d_conv=4, expand=2, headdim=64,
    attn_every=6,
    source="arXiv:2411.15242; unverified",
)
