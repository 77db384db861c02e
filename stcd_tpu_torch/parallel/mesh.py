"""The ``data`` axis of the JAX mesh over processes (counterpart of
stcd_tpu/parallel/mesh.py, that axis only).

In the JAX package a mesh's ``data`` axis shards the batch and XLA
replicates the parameters. Here the axis is the process group: one rank a
card, each holding rows ``r::W`` of the batch (``batch_sharding``) and a
full copy of the train state, which ``place_train_state`` makes equal to
rank 0's. The ``model``, ``space`` and ``stage`` axes (tensor, spatial and
pipeline parallelism) are ROADMAP.md Queue 1 #11.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stcd_tpu_torch.parallel import distributed


class Mesh(NamedTuple):
    """``data`` ranks, this process being rank ``rank``."""

    data: int
    rank: int


def create_mesh(data: Optional[int] = None, model: int = 1, space: int = 1,
                stage: int = 1) -> Mesh:
    """The data axis over the process group: ``data`` None means every rank.
    Another size than the group's raises, and so does a ``model``, ``space``
    or ``stage`` axis other than 1."""
    for name, size in (("model", model), ("space", space), ("stage", stage)):
        if size != 1:
            raise NotImplementedError(
                f"a '{name}' axis of {size}: tensor, spatial and pipeline parallelism are "
                "not ported (ROADMAP.md Queue 1 #11)")
    world = distributed.world_size()
    if data is None:
        data = world
    if data != world:
        raise ValueError(
            f"a 'data' axis of {data} in a run of {world} process(es): launch one process "
            f"a device, torchrun --nproc_per_node {data} -m <module> ... (or leave the data "
            "axis to the launch)")
    return Mesh(data=data, rank=distributed.rank())


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of a global batch that this rank holds."""
    return distributed.global_batch_sharding(mesh.data, mesh.rank)


def place_train_state(mesh: Mesh, state):
    """Make every rank's train state rank 0's: its parameters, its buffers
    (BatchNorm's running statistics) and its optimizer state, broadcast.
    Call it after any restore from a checkpoint, as the JAX CLIs place a
    restored state. Returns ``state``, changed in place."""
    if mesh.data == 1:
        return state
    tensors = [*state.model.parameters(), *state.model.buffers()]
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            distributed.broadcast_(t)
    return state
