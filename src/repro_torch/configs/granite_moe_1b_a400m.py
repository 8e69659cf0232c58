"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 (the reference package's
configs/granite_moe_1b_a400m.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512,
    vocab=49155, head_dim=64, norm="rmsnorm", act="silu",
    moe_experts=32, moe_topk=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
