"""falcon-mamba-7b [ssm]: 64 Mamba1 layers, d_model 4096 (d_inner 8192),
ssm_state 16, d_conv 4, dt rank 256, vocab 65024 (the reference package's
configs/falcon_mamba_7b.py)."""
from .base import ArchConfig

CFG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, d_ff=0, vocab=65024,
    ssm_state=16, ssm_kind="mamba1", d_conv=4, expand=2,
    norm="rmsnorm",
    source="arXiv:2410.05355; unverified",
)
