"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 (the reference package's configs/minitron_4b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="minitron-4b", family="lm",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=9216,
    vocab=256000, head_dim=128, norm="rmsnorm", act="silu",
    source="arXiv:2407.14679; hf",
)
