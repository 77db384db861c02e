"""The ``data`` and ``space`` axes of the JAX mesh over processes
(counterpart of stcd_tpu/parallel/mesh.py, those two axes).

In the JAX package a mesh's ``data`` axis shards the batch and its ``space``
axis the rows of each image, and XLA replicates the parameters. Here the
axes are a grid over the process group, ``data`` x ``space`` with space the
inner axis, as in JAX (stcd_tpu/parallel/mesh.py:29-48): rank r is data
shard ``r // S`` and strip ``r % S``. A data shard holds rows ``d::D`` of the
batch (``batch_sharding``); the S ranks of a space group hold the same
images, each a strip of their rows (``parallel/spatial.py``). Every rank
holds a full copy of the train state, which ``place_train_state`` makes
equal to rank 0's. The ``model`` and ``stage`` axes (tensor and pipeline
parallelism) are ROADMAP.md Queue 1 #11b.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stcd_tpu_torch.parallel import distributed


class Mesh(NamedTuple):
    """``data`` x ``space`` ranks, this process being rank ``rank``."""

    data: int
    rank: int
    space: int = 1


def create_mesh(data: Optional[int] = None, model: int = 1, space: int = 1,
                stage: int = 1) -> Mesh:
    """The data x space grid over the process group: ``data`` None means the
    world over ``space``. A grid of another size than the group raises, and so
    does a ``model`` or ``stage`` axis other than 1. With a space axis every
    rank creates the D space groups (``dist.new_group``, in one order on
    every rank) and keeps its own. Nothing reduces over a data axis alone:
    the sums of BatchNorm, the losses and the gradients run over every rank."""
    for name, size in (("model", model), ("stage", stage)):
        if size != 1:
            raise NotImplementedError(
                f"a '{name}' axis of {size}: tensor and pipeline parallelism are not "
                "ported (ROADMAP.md Queue 1 #11b)")
    world = distributed.world_size()
    if space < 1 or world % space:
        raise ValueError(
            f"a 'space' axis of {space} in a run of {world} process(es): launch a multiple "
            f"of it, torchrun --nproc_per_node {space * (data or 1)} -m <module> ...")
    if data is None:
        data = world // space
    if data * space != world:
        raise ValueError(
            f"a 'data' axis of {data} x a 'space' axis of {space} in a run of {world} "
            f"process(es): launch one process a device, torchrun --nproc_per_node "
            f"{data * space} -m <module> ... (or leave the data axis to the launch)")
    space_group = None
    if space > 1:
        import torch.distributed as dist

        for d in range(data):
            group = dist.new_group(list(range(d * space, (d + 1) * space)))
            if distributed.rank() // space == d:
                space_group = group
    distributed.set_grid(space, space_group)
    return Mesh(data=data, rank=distributed.rank(), space=space)


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of a global batch that this rank's data shard holds."""
    return distributed.global_batch_sharding(mesh.data, mesh.rank // mesh.space)


def place_train_state(mesh: Mesh, state):
    """Make every rank's train state rank 0's: its parameters, its buffers
    (BatchNorm's running statistics) and its optimizer state, broadcast.
    Call it after any restore from a checkpoint, as the JAX CLIs place a
    restored state. Returns ``state``, changed in place."""
    if mesh.data * mesh.space == 1:
        return state
    tensors = [*state.model.parameters(), *state.model.buffers()]
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            distributed.broadcast_(t)
    return state
