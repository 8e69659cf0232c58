"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (kimi/moonlight; the reference package's
configs/moonshot_v1_16b_a3b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=163840, head_dim=128, norm="rmsnorm", act="silu",
    moe_experts=64, moe_topk=6,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
