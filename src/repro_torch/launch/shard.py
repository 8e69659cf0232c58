"""Data-parallel partition rules of the sharded training step.

Port of the DP and ZeRO-1 parts of `repro.launch.shard`.  The sharded
step (launch/train.make_sharded_train_step) runs in every rank of the
mesh's data group:

  data  - batch parallelism.  The global batch splits into `n_shards`
          VIRTUAL shards (the quantization granularity, a static property
          of the algorithm); each rank runs n_shards/dp of them and the
          gradient sync rides the integer wire (runtime/compress.py).

A "spec" here names where a leaf lives: None, replicated on every rank,
or DATA_AXIS, split into dp equal flat chunks of which each rank holds
its own (the ZeRO-1 accumulator).  `shard_arrays` takes this rank's part
of a global tree and `gather_arrays` puts the global tree back together,
as the reference's device_put / device_get do across its mesh.

The model axis (tensor parallelism: the per-family tables of which leaf
axes shard, `tp_param_specs`, `decode_slot_specs`, `page_pool_spec`) is
ROADMAP Queue 1 item 5, step 2b.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.optim import MomentumState, flatten, tree_map, unflatten

from .mesh import DATA_AXIS, MODEL_AXIS


def mesh_dims(mesh) -> tuple[int, int]:
    """(dp, tp) sizes of a (data, model) training mesh."""
    names = set(mesh.axis_names)
    if names != {DATA_AXIS, MODEL_AXIS}:
        raise ValueError(
            f"sharded training wants a (data, model) mesh, got {names}")
    return mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]


def param_specs(params):
    """Every parameter replicated (pure DP; tp = 1)."""
    return tree_map(lambda _: None, params)


def opt_specs(param_specs):
    """MomentumState specs for the replicated-optimizer layout: the
    accumulator mirrors the params, the step counter is replicated."""
    return MomentumState(acc=param_specs, step=None)


def zero_opt_specs(params):
    """Specs for the ZeRO-1 MomentumState: accumulator chunks over data."""
    return MomentumState(acc=tree_map(lambda _: DATA_AXIS, params),
                         step=None)


def local_rows(n: int, dp: int, rank: int) -> slice:
    """Rank `rank`'s rows of an n-row global batch: [r n/dp, (r+1) n/dp),
    so virtual shard v covers the same global rows on any layout."""
    if n % dp:
        raise ValueError(f"global batch {n} must divide by dp={dp}")
    per = n // dp
    return slice(rank * per, (rank + 1) * per)


def put_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global host batch (every entry split on its
    leading dimension, as the reference's P("data") places them)."""
    n = len(next(iter(batch.values())))
    rows = local_rows(n, mesh.dp, mesh.rank)
    return {k: v[rows] for k, v in batch.items()}


# --------------------------------------------------------------------------
# ZeRO-1 layout: Momentum accumulator as flat per-rank chunks
# --------------------------------------------------------------------------
#
# Each leaf's accumulator is stored FLAT, padded to dp equal chunks, global
# shape (dp * chunk,), of which each rank holds the chunk it updates.  The
# update itself is elementwise (optim/momentum.py apply_leaf_update), so
# chunking cannot change a bit of the result; the gradient quantization
# (CQ amax + stochastic bits) always runs on the FULL leaf before chunking
# for the same reason.


def zero_chunk_len(size: int, dp: int) -> int:
    return -(-size // dp)


def zero_init_momentum(params, dp: int) -> MomentumState:
    """MomentumState with flat padded (dp * chunk,) accumulator leaves
    (the global layout; `shard_arrays` takes a rank's chunk of it)."""
    return MomentumState(acc=tree_map(
        lambda p: torch.zeros(dp * zero_chunk_len(p.numel(), dp),
                              dtype=p.dtype, device=p.device), params))


def zero_template(params, dp: int) -> MomentumState:
    """Host MomentumState of the ZeRO-1 layout under `dp`: the restore
    target for a checkpoint written under that membership."""
    return MomentumState(acc=tree_map(
        lambda p: np.zeros(dp * zero_chunk_len(p.numel(), dp),
                           dtype=np.float32), params))


def zero_reshard(acc_tree, params, dp_new: int):
    """Re-chunk flat ZeRO-1 accumulator leaves for a new DP membership:
    (dp_old * chunk_old,) -> (dp_new * chunk_new,).

    Bit-exact by the layout's own algebra: the logical accumulator is the
    first `p.size` entries of the flat leaf and the tail is padding that
    both STARTS zero (zero_init_momentum) and STAYS zero (the elementwise
    update of a zero-param/zero-grad slot is zero, launch/train.py
    `_zero1_update`), so resharding is exactly unpad + repad with zeros.
    Runs on host numpy: reshard happens between memberships."""
    def f(a, p):
        flat = np.asarray(a).reshape(-1)[: int(np.prod(np.shape(p)))]
        c = zero_chunk_len(flat.size, dp_new)
        return np.pad(flat, (0, dp_new * c - flat.size))
    return _zip_map(f, acc_tree, params)


def _zip_map(fn, tree, other):
    """fn(leaf, other's leaf) over two trees of one structure."""
    return unflatten(tree, [fn(x, o) for x, o in zip(flatten(tree),
                                                      flatten(other))])


def shard_arrays(mesh, tree, specs):
    """This rank's part of a global tree: a DATA_AXIS leaf's chunk (its
    flat (dp * chunk,) layout cut in dp), every other leaf as it is."""
    def part(x, spec):
        if spec != DATA_AXIS:
            return x
        c = x.shape[0] // mesh.dp
        return x[mesh.rank * c:(mesh.rank + 1) * c].clone()
    if isinstance(tree, MomentumState):
        return MomentumState(acc=_zip_map(part, tree.acc, specs.acc),
                             step=tree.step)
    return _zip_map(part, tree, specs)


def gather_arrays(mesh, tree, specs):
    """The global tree from every rank's part (a collective: every rank of
    the data group calls it): DATA_AXIS chunks gathered in rank order."""
    from repro_torch.runtime.compress import all_gather

    def whole(x, spec):
        if spec != DATA_AXIS:
            return x
        return all_gather(x, mesh.group, what="state").reshape(-1)
    if isinstance(tree, MomentumState):
        return MomentumState(acc=_zip_map(whole, tree.acc, specs.acc),
                             step=tree.step)
    return _zip_map(whole, tree, specs)


def pad_flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """x flattened and zero-padded to n elements."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, n - flat.numel())) if flat.numel() < n else flat
