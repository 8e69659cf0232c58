"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 (the reference package's configs/phi4_mini_3_8b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="phi4-mini-3.8b", family="lm",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=200064, head_dim=128, norm="rmsnorm", act="silu",
    source="arXiv:2412.08905; hf",
)
