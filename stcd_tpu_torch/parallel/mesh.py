"""The ``data``, ``model``, ``space`` and ``stage`` axes of the JAX mesh over
processes (counterpart of stcd_tpu/parallel/mesh.py).

In the JAX package a mesh's ``data`` axis shards the batch, its ``model``
axis the wide parameters (``param_sharding``), its ``space`` axis the rows
of each image and its ``stage`` axis a pipeline's stages. Here the axes are a
grid over the process group in JAX's order (stcd_tpu/parallel/mesh.py:29-48:
data, model, space, stage; the last the innermost): rank r is data shard
``r // (T S)``, model index ``(r // S) % T`` and strip or stage ``r % S``. A
data shard holds rows ``d::D`` of the batch (``batch_sharding``); the T ranks
of a model group hold the same rows and each a shard of the split parameters
and of their optimizer state (``parallel/tensor.py``); the S ranks of a space
group hold the same images, each a strip of their rows
(``parallel/spatial.py``); the S ranks of a stage group hold the same rows
and each runs one stage of the pipeline (``parallel/pipeline.py``).
``grid_ranks`` lays the groups out, a pure function of the axes' sizes.
``place_train_state`` makes every rank's state rank 0's and then keeps each
rank's shards.

A space axis composes with a model axis, as JAX's manual ``shard_map``
space axis does (stcd_tpu/parallel/spatial.py, ``param_sharding(
manual_space=True)``): rank r is then data shard ``r // (T S)``, model index
``(r // S) % T`` and strip ``r % S``; a split conv takes its halo rows on its
whole input, then gathers its channels over the model group. A space axis
beside a stage axis raises: JAX has no step that runs it (ROADMAP.md "No
counterpart").

Serving is one process over several cards, not one process a card:
``serving_devices`` picks the cards of its ``data`` axis, and
``serving/replicas.py`` splits each batch by rows over them.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch

from stcd_tpu_torch.parallel import distributed

class Mesh(NamedTuple):
    """``data`` x ``model`` x ``space`` x ``stage`` ranks (space 1 beside a
    stage axis), this process being rank ``rank``."""

    data: int
    rank: int
    space: int = 1
    stage: int = 1
    model: int = 1


def _axes_text(model: int, space: int, stage: int) -> str:
    axes = [f"'{name}' axis of {size}" for name, size in
            (("model", model), ("space", space), ("stage", stage)) if size > 1]
    return " x a ".join(axes) or "'space' axis of 1"


def grid_ranks(data: int, model: int = 1, space: int = 1, stage: int = 1) -> dict:
    """The process groups of the data x model x space x stage grid, as lists
    of global ranks: rank ``((d T + m) S + s) G + g`` holds data shard d,
    model index m, strip s and stage g, JAX's device order
    (``np.arange(W).reshape(D, T, S, G)``). Only the groups that the grid
    uses are listed, each in one order on every rank:

    - ``space``: the S ranks of one (d, m, g), in strip order (S > 1);
    - ``model``: the T ranks of one (d, s, g), in model order (T > 1);
    - ``stage``: the G ranks of one (d, m, s), in stage order (G > 1);
    - ``data``: the ranks whose rows, or strips of them, make the global
      batch once, the D x S ranks of one (m, g) (T G > 1; without a model
      or stage axis that is every rank, and no group is made);
    - ``shard``: the ranks that hold one shard of a split parameter, the
      D x S x G ranks of one model index (T > 1)."""
    def rank(d, m, s, g):
        return ((d * model + m) * space + s) * stage + g

    D, T, S, G = range(data), range(model), range(space), range(stage)
    out = {}
    if space > 1:
        out["space"] = [[rank(d, m, s, g) for s in S]
                        for d, m, g in itertools.product(D, T, G)]
    if model > 1:
        out["model"] = [[rank(d, m, s, g) for m in T]
                        for d, s, g in itertools.product(D, S, G)]
    if stage > 1:
        out["stage"] = [[rank(d, m, s, g) for g in G]
                        for d, m, s in itertools.product(D, T, S)]
    if model * stage > 1:
        out["data"] = [[rank(d, m, s, g) for d, s in itertools.product(D, S)]
                       for m, g in itertools.product(T, G)]
    if model > 1:
        out["shard"] = [[rank(d, m, s, g) for d, s, g in itertools.product(D, S, G)]
                        for m in T]
    return out


def create_mesh(data: Optional[int] = None, model: int = 1, space: int = 1,
                stage: int = 1) -> Mesh:
    """The data x model x space x stage grid over the process group: ``data``
    None means the world over the other axes. A grid of another size than the
    group raises, and so does a space axis beside a stage axis. Every rank
    creates every group of ``grid_ranks`` with ``dist.new_group``, in one
    order on every rank, and keeps its own. Sums over rows (BatchNorm's, the
    losses', the counts') run over the data group under a model or stage axis
    and over every rank otherwise (``distributed``)."""
    if space > 1 and stage > 1:
        raise NotImplementedError(
            f"a 'space' axis of {space} beside a 'stage' axis of {stage}: the JAX package "
            f"has no step that runs spatial partitioning with pipeline parallelism, so the "
            'port has none to hold one against (ROADMAP.md "No counterpart")')
    inner = model * space * stage
    world = distributed.world_size()
    axes = _axes_text(model, space, stage)
    if inner < 1 or world % inner:
        raise ValueError(
            f"a {axes} in a run of {world} process(es): launch a multiple of {inner}, "
            f"torchrun --nproc_per_node {inner * (data or 1)} -m <module> ...")
    if data is None:
        data = world // inner
    if data * inner != world:
        raise ValueError(
            f"a 'data' axis of {data} x a {axes} in a run of {world} process(es): launch "
            f"one process a device, torchrun --nproc_per_node {data * inner} -m <module> "
            "... (or leave the data axis to the launch)")
    groups = {}
    if inner > 1:
        import torch.distributed as dist

        me = distributed.rank()
        for name, sets in grid_ranks(data, model, space, stage).items():
            for ranks in sets:
                group = dist.new_group(ranks)
                if me in ranks:
                    groups[name] = group
    distributed.set_grid(space, groups.get("space"), stage, groups.get("stage"),
                         groups.get("data"), model, groups.get("model"), groups.get("shard"))
    return Mesh(data=data, rank=distributed.rank(), space=space, stage=stage, model=model)


def serving_devices(device: str = "cuda", batch: Optional[int] = None,
                    no_shard: bool = False) -> list:
    """The devices one serving process splits its tile batch over: the
    counterpart of scripts/serve.py:111-128's ``batch_sharding(create_mesh(
    model=1))``. ``cuda`` is every visible card (``torch.cuda.device_count()``),
    ``cuda:N`` that card alone, and ``no_shard`` one card; a ``batch`` that
    the card count does not divide prints the JAX script's warning and
    serves on one card. Any other device is itself."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or no_shard:
        return [dev]
    n = torch.cuda.device_count()
    if n <= 1:
        return [dev]
    if batch is not None and batch % n:
        print(f"warning: --batch {batch} does not divide across {n} devices; serving "
              f"single-device (pass a multiple of {n}, or --no_shard to silence)",
              flush=True)
        return [torch.device("cuda", 0)]
    return [torch.device("cuda", i) for i in range(n)]


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of a global batch that this rank's data shard holds."""
    return distributed.global_batch_sharding(
        mesh.data, mesh.rank // (mesh.model * mesh.space * mesh.stage))


def place_train_state(mesh: Mesh, state):
    """Make every rank's train state rank 0's: its parameters, its buffers
    (BatchNorm's running statistics) and its optimizer state, broadcast;
    then, with a model axis, split the model by ``parallel/tensor.py``'s plan
    (JAX's ``param_sharding`` rules) so that each rank keeps its shard of
    each split parameter and of its optimizer moments (JAX shards Adam's
    moments with the parameters, stcd_tpu/parallel/mesh.py:83-113). A state
    split already is made equal to its shard's owners in data shard 0.
    Call it after any restore from a checkpoint, as the JAX CLIs place a
    restored state. Returns ``state``, changed in place."""
    from stcd_tpu_torch.parallel import tensor

    if mesh.data * mesh.model * mesh.space * mesh.stage == 1:
        return state
    shards, whole = [], list(state.model.buffers())
    for p in state.model.parameters():
        split = hasattr(p, "tp_split")
        (shards if split else whole).append(p)
        for v in state.optimizer.state.get(p, {}).values():
            if torch.is_tensor(v):
                (shards if split and v.shape == p.shape else whole).append(v)
    with torch.no_grad():
        for t in whole:
            distributed.broadcast_(t)
        # from the rank of data shard 0 and strip 0 that holds the same shard (and
        # runs the same stage): one source for the whole data group
        src = (distributed.model_rank() * mesh.space * mesh.stage
               + mesh.rank % mesh.stage)
        for t in shards:
            distributed.broadcast_(t, src=src, group=distributed.data_group())
    if mesh.model > 1 and not tensor.is_split(state.model):
        tensor.split_model(state.model, mesh.model, distributed.model_rank(),
                           state.optimizer)
    return state
