"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (the reference package's configs/chameleon_34b.py).  Its VQ
image tokens are vocabulary entries, so the model is the dense decoder on
token ids."""
from .base import ArchConfig

CFG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
    vocab=65536, head_dim=128, norm="rmsnorm", act="silu",
    source="arXiv:2405.09818; unverified",
)
