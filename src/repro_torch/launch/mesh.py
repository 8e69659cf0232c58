"""The training mesh over a torch.distributed world.

Port of `repro.launch.mesh`.  The reference's mesh is a grid of devices
with named axes; the port's is the view one rank has of its world: the
data-parallel size `dp`, the tensor-parallel size `tp` (1: tensor
parallelism is ROADMAP Queue 1 item 5, step 2b), this rank's place on the
data axis and the process group that axis reduces over.  Nothing is made
at import time: a mesh is built from a world that the caller initialized
(`torch.distributed.init_process_group`), or from no world at all when
dp = 1, where every collective of `runtime/compress.py` is the identity.

The reference's `make_production_mesh` (the 16 x 16 pod slice) and
`make_replica_meshes` (disjoint serving replicas for the router) belong to
ROADMAP Queue 1 item 5, step 4.
"""
from __future__ import annotations

from dataclasses import dataclass

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_UNPORTED = ("tensor parallelism is not ported yet: ROADMAP Queue 1 "
               "item 5, step 2b")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data, model) mesh."""

    dp: int
    tp: int = 1
    rank: int = 0            # this rank's index on the data axis
    group: object = None     # the data axis's process group (None: default)

    @property
    def axis_names(self) -> tuple:
        return (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def make_mesh(dp: int | None = None, tp: int = 1, group=None) -> Mesh:
    """The mesh of an initialized world (or of one process when none is):
    `dp` defaults to the group's size and must equal it."""
    import torch.distributed as dist
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: {TP_UNPORTED}")
    size = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    dp = size if dp is None else dp
    if dp != size:
        raise ValueError(
            f"a dp={dp} mesh needs a process group of {dp} ranks, this one "
            f"has {size} (torch.distributed.init_process_group first)")
    return Mesh(dp=dp, tp=tp, rank=rank, group=group)


def make_cpu_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """The reference's small test mesh: `n_data` ranks of the default
    group (one process for n_data = 1), tensor parallelism off."""
    return make_mesh(n_data, n_model)


def mesh_axes(mesh: Mesh):
    """(dp_axes, tp_axis) convention used throughout the framework."""
    return (DATA_AXIS,), MODEL_AXIS
