"""granite-34b [dense]: 88L d_model=6144 48H (MQA: kv=1) d_ff=24576
vocab=49152 (the reference package's configs/granite_34b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="granite-34b", family="lm",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, head_dim=128, norm="rmsnorm", act="silu",
    source="arXiv:2405.04324; hf",
)
