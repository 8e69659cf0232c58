"""Architecture configs the port runs; `get(name)` resolves `--arch` ids."""
from .base import ArchConfig
from .chameleon_34b import CFG as chameleon_34b
from .falcon_mamba_7b import CFG as falcon_mamba_7b
from .granite_34b import CFG as granite_34b
from .granite_3_8b import CFG as granite_3_8b
from .granite_moe_1b_a400m import CFG as granite_moe_1b_a400m
from .minitron_4b import CFG as minitron_4b
from .moonshot_v1_16b_a3b import CFG as moonshot_v1_16b_a3b
from .phi4_mini_3_8b import CFG as phi4_mini_3_8b
from .resnets import RESNET18, RESNET34, RESNET50
from .seamless_m4t_large_v2 import CFG as seamless_m4t_large_v2
from .zamba2_7b import CFG as zamba2_7b

ARCHS = {c.name: c for c in [granite_3_8b, granite_34b, phi4_mini_3_8b,
                              minitron_4b, chameleon_34b,
                              granite_moe_1b_a400m, moonshot_v1_16b_a3b,
                              falcon_mamba_7b, zamba2_7b,
                              seamless_m4t_large_v2,
                              RESNET18, RESNET34, RESNET50]}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (known: {sorted(ARCHS)})")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "get"]
