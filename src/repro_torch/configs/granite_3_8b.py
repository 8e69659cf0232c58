"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 (the reference package's configs/granite_3_8b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="granite-3-8b", family="lm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800,
    vocab=49155, head_dim=128, norm="rmsnorm", act="silu",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
