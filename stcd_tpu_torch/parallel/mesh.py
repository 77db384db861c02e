"""The ``data``, ``space`` and ``stage`` axes of the JAX mesh over processes
(counterpart of stcd_tpu/parallel/mesh.py, those three axes).

In the JAX package a mesh's ``data`` axis shards the batch, its ``space``
axis the rows of each image and its ``stage`` axis a pipeline's stages, and
XLA replicates the parameters. Here the axes are a grid over the process
group, ``data`` x ``space`` or ``data`` x ``stage`` with the second the inner
axis, as in JAX (stcd_tpu/parallel/mesh.py:29-48, order data, model, space,
stage): rank r is data shard ``r // S`` and strip or stage ``r % S``. A data
shard holds rows ``d::D`` of the batch (``batch_sharding``); the S ranks of
a space group hold the same images, each a strip of their rows
(``parallel/spatial.py``); the S ranks of a stage group hold the same rows
and each runs one stage of the pipeline (``parallel/pipeline.py``). Every
rank holds a full copy of the train state, which ``place_train_state``
makes equal to rank 0's. The ``model`` axis (tensor parallelism) and a
space axis beside a stage axis are ROADMAP.md Queue 1 #11c.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stcd_tpu_torch.parallel import distributed

TP_ITEM = "ROADMAP.md Queue 1 #11c"  # tensor parallelism, and space x stage


class Mesh(NamedTuple):
    """``data`` x ``space`` x ``stage`` ranks (space or stage 1), this process
    being rank ``rank``."""

    data: int
    rank: int
    space: int = 1
    stage: int = 1


def create_mesh(data: Optional[int] = None, model: int = 1, space: int = 1,
                stage: int = 1) -> Mesh:
    """The data x space or data x stage grid over the process group: ``data``
    None means the world over the inner axis. A grid of another size than the
    group raises, and so do a ``model`` axis other than 1 and a space axis
    beside a stage axis. Every rank creates the groups of the inner axis (and
    with a stage axis the S data groups, the ranks of one stage index) with
    ``dist.new_group``, in one order on every rank, and keeps its own. Sums
    over rows (BatchNorm's, the losses', the counts') run over the data group
    under a stage axis and over every rank otherwise (``distributed``)."""
    if model != 1:
        raise NotImplementedError(
            f"a 'model' axis of {model}: tensor parallelism is not ported ({TP_ITEM})")
    if space > 1 and stage > 1:
        raise NotImplementedError(
            f"a 'space' axis of {space} beside a 'stage' axis of {stage}: spatial "
            f"partitioning inside a pipeline is not ported ({TP_ITEM})")
    inner = space * stage
    name = "space" if space > 1 or stage == 1 else "stage"
    world = distributed.world_size()
    if inner < 1 or world % inner:
        raise ValueError(
            f"a '{name}' axis of {inner} in a run of {world} process(es): launch a multiple "
            f"of it, torchrun --nproc_per_node {inner * (data or 1)} -m <module> ...")
    if data is None:
        data = world // inner
    if data * inner != world:
        raise ValueError(
            f"a 'data' axis of {data} x a '{name}' axis of {inner} in a run of {world} "
            f"process(es): launch one process a device, torchrun --nproc_per_node "
            f"{data * inner} -m <module> ... (or leave the data axis to the launch)")
    groups = {}
    if inner > 1:
        import torch.distributed as dist

        me = distributed.rank()
        for d in range(data):
            group = dist.new_group(list(range(d * inner, (d + 1) * inner)))
            if me // inner == d:
                groups["inner"] = group
        if stage > 1:
            for s in range(stage):
                group = dist.new_group(list(range(s, world, stage)))
                if me % stage == s:
                    groups["data"] = group
    if stage > 1:
        distributed.set_grid(1, None, stage, groups["inner"], groups["data"])
    else:
        distributed.set_grid(space, groups.get("inner"))
    return Mesh(data=data, rank=distributed.rank(), space=space, stage=stage)


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of a global batch that this rank's data shard holds."""
    return distributed.global_batch_sharding(mesh.data,
                                             mesh.rank // (mesh.space * mesh.stage))


def place_train_state(mesh: Mesh, state):
    """Make every rank's train state rank 0's: its parameters, its buffers
    (BatchNorm's running statistics) and its optimizer state, broadcast.
    Call it after any restore from a checkpoint, as the JAX CLIs place a
    restored state. Returns ``state``, changed in place."""
    if mesh.data * mesh.space * mesh.stage == 1:
        return state
    tensors = [*state.model.parameters(), *state.model.buffers()]
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            distributed.broadcast_(t)
    return state
