"""Carry the reference package's weights and optimizer state into the port.

`params_from_jax(tree)` takes the output of `repro`'s `LMTransformer.init`
(dense or MoE), `ssm_params_from_jax(tree)` that of its `SSMLM.init`,
`hybrid_params_from_jax(tree)` that of its `Zamba2.init`,
`encdec_params_from_jax(tree)` that of its `EncDec.init` and
`resnet_params_from_jax(tree)` that of its `ResNet.init`, with every
leaf converted to numpy (the caller does that, so this module needs no
JAX), and returns the same tree as torch tensors, ready for the port's
`load_params`.  Both packages keep one layout (stacked (L, ...) layer
weights for the LM, its `moe` subtree, the SSM, the hybrid's Mamba2 layers
(beside its `shared` block) and the enc-dec's `enc` and `dec`; HWIO convolutions, (in, classes) fc and the list of stages of block
dicts for the ResNet), so the conversion is a copy.

On the card there is no JAX: the models' `init` draws weights there from a
torch.Generator by the same formulas, which gives the same distribution
but not the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ssm
from repro_torch.models.transformer import LAYER_KEYS
from repro_torch.optim import MomentumState, tree_map


def _tensors(tree, device):
    return tree_map(lambda x: torch.tensor(np.asarray(x, np.float32),
                                           device=device), tree)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """{"embed", "layers": {ln1, wq, ..., and w_gate, w_up, w_down or the
    MoE's "moe" {router, wg, wu, wd}}, "final_norm", "lm_head"} of numpy
    arrays -> the same tree of fp32 torch tensors on `device`."""
    layers = {k: v for k, v in tree["layers"].items()
              if k in LAYER_KEYS or k == "moe"}
    return _tensors({"embed": tree["embed"], "layers": layers,
                     "final_norm": tree["final_norm"],
                     "lm_head": tree["lm_head"]}, device)


def ssm_params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference SSMLM's tree ({"embed", "layers": {ln, in_proj, ...,
    out_proj} stacked (L, ...), "final_norm", "lm_head"}) of numpy arrays
    -> the same tree of fp32 torch tensors on `device`."""
    return _tensors({"embed": tree["embed"],
                     "layers": {k: tree["layers"][k]
                                for k in ssm.LAYER_KEYS},
                     "final_norm": tree["final_norm"],
                     "lm_head": tree["lm_head"]}, device)


def hybrid_params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference Zamba2's tree ({"embed", "layers": {ln, in_proj, ...,
    out_proj} stacked (L, ...), "shared": {ln1, wq, ..., w_down},
    "final_norm", "lm_head"}) of numpy arrays -> the same tree of fp32
    torch tensors on `device`."""
    return _tensors({"embed": tree["embed"],
                     "layers": {k: tree["layers"][k]
                                for k in ssm.MAMBA2_KEYS},
                     "shared": tree["shared"],
                     "final_norm": tree["final_norm"],
                     "lm_head": tree["lm_head"]}, device)


def encdec_params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference EncDec's tree ({"enc", "dec": stacked (L, ...) leaves,
    "embed", "final_ln_g", "final_ln_b", "lm_head"}) of numpy arrays -> the
    same tree of fp32 torch tensors on `device`."""
    return _tensors(tree, device)


def resnet_params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference ResNet's tree ({"stem", "bn_stem", "stages": [[block
    dict, ...], ...], "fc", "fc_b"}) of numpy arrays -> the same tree of
    fp32 torch tensors on `device`."""
    return _tensors(tree, device)


def momentum_from_jax(acc: dict, step: int = 0, device="cpu"):
    """The reference's MomentumState.acc tree (numpy leaves, shaped like
    any of the trees above, an MoE LM's "moe" subtree included) -> the
    port's MomentumState, so both packages can start from one optimizer
    state."""
    return MomentumState(acc=_tensors(acc, device), step=int(step))
