"""Quantized Momentum optimizer (paper Eq. 19-24)."""
from .momentum import (MomentumState, apply_leaf_update, dr_bits_schedule,
                       fixed_point_lr, flatten, init_momentum, momentum_update,
                       parse_boundaries, quantize_grad_leaf, tree_map,
                       unflatten)

__all__ = ["MomentumState", "apply_leaf_update", "dr_bits_schedule",
           "fixed_point_lr", "flatten", "init_momentum", "momentum_update",
           "parse_boundaries", "quantize_grad_leaf", "tree_map", "unflatten"]
