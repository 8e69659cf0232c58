"""Carry the reference package's LM weights into the port.

`params_from_jax(tree)` takes the output of `repro`'s `LMTransformer.init`
with every leaf converted to numpy (the caller does that, so this module
needs no JAX) and returns the same tree as torch tensors, ready for
`repro_torch.models.LMTransformer.load_params`.  Both packages keep one
layout (stacked (L, ...) layer weights), so the conversion is a copy.

On the card there is no JAX: `LMTransformer.init` draws weights there from
a torch.Generator by the same formulas, which gives the same distribution
but not the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import LAYER_KEYS


def params_from_jax(tree: dict, device="cpu") -> dict:
    """{"embed", "layers": {ln1, wq, ...}, "final_norm", "lm_head"} of
    numpy arrays -> the same tree of fp32 torch tensors on `device`."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return {"embed": t(tree["embed"]),
            "layers": {k: t(tree["layers"][k]) for k in LAYER_KEYS},
            "final_norm": t(tree["final_norm"]),
            "lm_head": t(tree["lm_head"])}


def momentum_from_jax(acc: dict, step: int = 0, device="cpu"):
    """The reference's MomentumState.acc tree (numpy leaves) -> the port's
    MomentumState, so both packages can start from one optimizer state."""
    from repro_torch.optim import MomentumState
    return MomentumState(acc=params_from_jax(acc, device), step=int(step))
