"""The process group of data-parallel training and its collectives
(counterpart of stcd_tpu/parallel/distributed.py).

The JAX package runs one SPMD program over a mesh whose ``data`` axis spans
every device, and XLA inserts each reduction, so a data-parallel step
computes the one-device step on the global batch. The port runs one process
a card and makes those reductions itself:

1. ``initialize()`` once a process. Under torchrun (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) it
   creates the process group: NCCL for a card (``cuda:LOCAL_RANK``), gloo for
   the CPU and for ranks that share one card. A process started without them is one process, and
   ``initialize`` does nothing.
2. The loader (data/loader.py) gives rank r the rows ``r::W`` of each global
   batch (``global_batch_sharding``).
3. What XLA would reduce is reduced where the arithmetic needs it:
   BatchNorm's moments (layers/norm.py) and the sums of the ratio losses
   (losses/functional.py) through ``all_reduce_sum``, whose backward
   all-reduces the incoming gradient; the gradients by one flat all-reduce
   after the backward, averaged over the ranks (``average_gradients``). With
   that mean, the summed backward of ``all_reduce_sum`` gives the gradient of
   the global loss exactly, as SyncBatchNorm's does.

Spatial partitioning (``parallel/spatial.py``) splits the W ranks into a
grid of ``data`` x ``space`` (``mesh.create_mesh``; space the inner axis,
so rank r is data index ``r // S`` and space index ``r % S``). The ranks of a
space group hold the same images, each a strip of their rows. The sums above
stay over every rank (over the data group under a model axis, below): the
strips of all the data shards are the global batch.
What follows the data axis alone (the loader's split, the draws' rows) reads
``data_size`` and ``data_rank``; without a space axis they are the world's.

Pipeline parallelism (``parallel/pipeline.py``) makes the grid ``data`` x
``stage`` instead (stage the inner axis: rank r is data shard ``r // S`` and
stage ``r % S``). The S ranks of a stage group hold the same rows, so what
is summed over rows (BatchNorm's moments, the ratio losses, the confusion
counts) sums over the data group, the D ranks of one stage index
(``data_group``); the stage group's own traffic is point to point
(``send`` / ``recv``) and ``broadcast_in``.

Tensor parallelism (``parallel/tensor.py``) adds a ``model`` axis outside
the space or stage axis (rank r is data shard ``r // (T S)``, model index
``(r // S) % T`` and strip or stage ``r % S``, with S the space or the stage
axis; the two do not meet). The T ranks of a model group hold the same rows
(or strip) and each a shard of the split parameters; their layers meet
through Megatron's two functions, ``copy_in`` (forward identity, backward
all-reduce over the model group) and ``reduce_out`` (forward all-reduce,
backward identity), and ``gather_channels``. What is summed over rows sums
over the data group: the D ranks of one model index and stage, or under a
space axis the D x S ranks of one model index, whose strips make the global
batch once. A split parameter's gradient is averaged over the ranks that
hold its shard (``average_gradients``).

Every collective here is a no-op in one process (``data_parallel()`` false),
so one process runs the arithmetic it runs without this module. Nothing
creates a process group at import.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Join the process group of a multi-process run; returns this process's
    device (``cuda:LOCAL_RANK`` for a card, else ``device``).

    The arguments default to torchrun's environment (``init_method``
    ``env://`` reads ``MASTER_ADDR`` and ``MASTER_PORT``; a card is
    ``cuda:LOCAL_RANK`` unless ``device`` names one). Without a world size
    there or here the process is alone and nothing is done, as in the JAX
    function. The backend follows the device: NCCL for a card, gloo for the
    CPU, and gloo where ``device`` names one card and the launch puts more
    than one rank on this host (``LOCAL_WORLD_SIZE``): those ranks share the
    card, and NCCL refuses two ranks on one device. ``backend`` overrides
    it. A failure raises: a run that meant to be W processes
    never carries on as one. A second call is a no-op."""
    device = torch.device(device)
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if world_size is None:
        return device
    if dist.is_initialized():
        return (torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda"
                else device)
    rank = _env_int("RANK") if rank is None else rank
    if rank is None:
        raise ValueError(f"world size {world_size} without a rank: set RANK or pass rank")
    shared = device.index is not None and (_env_int("LOCAL_WORLD_SIZE") or 1) > 1
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: --device {device}: no CUDA device is available")
        device = torch.device("cuda", device.index if device.index is not None
                              else _env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


# the grid that mesh.create_mesh sets: the space, model and stage axes' sizes, this
# rank's space, model and stage groups (None with an axis of 1), its data group (None:
# every rank holds rows of its own or strips of them) and its shard group (the ranks
# of its model index)
_GRID = {"space": 1, "space_group": None, "stage": 1, "stage_group": None,
         "data_group": None, "model": 1, "model_group": None, "shard_group": None}


def set_grid(space: int, space_group=None, stage: int = 1, stage_group=None,
             data_group=None, model: int = 1, model_group=None,
             shard_group=None) -> None:
    """Record the grid that ``mesh.create_mesh`` checked: a space axis of
    ``space`` ranks and this rank's space group, a model axis of ``model``
    ranks and this rank's model and shard groups, a stage axis of ``stage``
    ranks and this rank's stage group, and its data group."""
    _GRID.update(space=space, space_group=space_group, stage=stage,
                 stage_group=stage_group, data_group=data_group, model=model,
                 model_group=model_group, shard_group=shard_group)


def space_size() -> int:
    """The ranks that share one image, each holding a strip of its rows."""
    return _GRID["space"] if is_initialized() else 1


def space_rank() -> int:
    """Which strip of its images this rank holds (0 the top)."""
    return rank() % space_size()


def space_group():
    """This rank's space group (the ranks of its images' strips), or None."""
    return _GRID["space_group"] if space_size() > 1 else None


def stage_size() -> int:
    """The ranks of a pipeline: the stages one data shard's rows pass."""
    return _GRID["stage"] if is_initialized() else 1


def stage_rank() -> int:
    """Which stage of its pipeline this rank runs."""
    return rank() % stage_size()


def stage_group():
    """This rank's stage group (the ranks of its pipeline), or None."""
    return _GRID["stage_group"] if stage_size() > 1 else None


def stage_ranks() -> list:
    """The global ranks of this rank's pipeline, stage 0 first."""
    first = rank() - stage_rank()
    return list(range(first, first + stage_size()))


def model_size() -> int:
    """The ranks of a model group: the shards of a split parameter."""
    return _GRID["model"] if is_initialized() else 1


def model_rank() -> int:
    """Which shard of each split parameter this rank holds: the model axis
    lies outside the space and stage axes."""
    return (rank() // (space_size() * stage_size())) % model_size()


def model_group():
    """This rank's model group (the T ranks of its data shard and its strip
    or stage), or None."""
    return _GRID["model_group"] if model_size() > 1 else None


def shard_group():
    """The ranks that hold this rank's shard of a split parameter (its model
    index: the D x S ranks of its data shards and strips or stages), or None
    without a model axis."""
    return _GRID["shard_group"] if model_size() > 1 else None


def data_group():
    """The ranks whose rows, or strips of them, together are the global batch
    once each: with a model or stage axis the D x S ranks of this rank's
    model and stage index (D under a stage axis, where S is 1), else None
    (every rank, which a space axis splits into strips of the rows)."""
    return _GRID["data_group"] if stage_size() * model_size() > 1 else None


def data_group_size() -> int:
    """The ranks of ``data_group()``: D x S (the world over the model and
    stage axes)."""
    return world_size() // (stage_size() * model_size())


def data_size() -> int:
    """The data axis: the shards the global batch is split into."""
    return world_size() // (space_size() * model_size() * stage_size())


def data_rank() -> int:
    """Which shard of the global batch this rank holds."""
    return rank() // (space_size() * model_size() * stage_size())


def is_primary() -> bool:
    return rank() == 0


def data_parallel() -> bool:
    """True under a process group of more than one rank: the collectives
    below then reduce; otherwise each returns its input."""
    return world_size() > 1


def print_primary(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if is_primary():
        print(*args, **kwargs)


def _comm_device() -> torch.device:
    """Where a tensor made only to be reduced lives: the card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str) -> None:
    """Every rank waits here for every other (no-op without a group). ``name``
    labels the error when the barrier fails."""
    if not is_initialized():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} on rank {rank()}: {e}") from e


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group`` (None: all); its backward is the
    sum over them of the incoming gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks (of ``group``, default ``data_group()``:
    every rank but the copies a stage axis makes), differentiably; ``x``
    itself in one process. Every rank of the group must call it, in the same
    order."""
    if not data_parallel():
        return x
    return _AllReduceSum.apply(x, data_group() if group is None else group)


def all_reduce_(x: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """In place: ``x`` reduced by ``op`` (default the sum) over ``group``
    (default ``data_group()``), without a gradient. Returns ``x``."""
    if data_parallel():
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=data_group() if group is None else group)
    return x


def average_gradients(parameters: Iterable[torch.nn.Parameter], staged=()) -> None:
    """Replace every gradient by its mean over the data shards: one
    all-reduce a (device, dtype, split) group of one flat buffer. A
    parameter that ``parallel/tensor.py`` split (``tp_split``) sums over its
    shard group (the ranks that hold its shard), any other over every rank.
    Each sum is divided by the copies of the gradient in it: the data
    group's ranks (D x S under a space axis of S, whose strips' gradients
    are partial sums), times the stage axis unless the parameter is in
    ``staged`` (a pipeline stage's parameters have their gradient on the
    stage's ranks only, zeros elsewhere), times T unless it is split. Every
    rank holds gradients for the same parameters, as the same model on every
    rank does."""
    if not data_parallel():
        return
    staged = {id(p) for p in staged}
    groups: Dict[tuple, list] = {}
    for p in parameters:
        if p.grad is not None:
            split = hasattr(p, "tp_split")
            copies = data_group_size() * (1 if id(p) in staged else stage_size()) * (
                1 if split else model_size())
            groups.setdefault((p.grad.device, p.grad.dtype, split), []).append(
                (p.grad, copies))
    for (_, _, split), members in groups.items():
        grads = [g for g, _ in members]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=shard_group() if split else None)
        for (g, copies), synced in zip(members,
                                       torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(synced).div_(copies)


def _model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=model_group())
    return out


def _fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


class _CopyIn(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over the model group
    backward (a replicated input of column-parallel layers)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _model_all_reduce(grad)


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward (a row-parallel
    layer's partial products), the identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad


class _GatherChannels(torch.autograd.Function):
    """The model group's blocks of ``dim``, rank order, as one tensor; the
    backward keeps this rank's block. Each rank writes its block into zeros
    and the group sums them (exact: every other term is 0), which gloo and
    NCCL both run on host and card tensors."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        ctx.dim, ctx.size = dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= model_size()
        full = x.new_zeros(shape)
        full.narrow(dim, model_rank() * ctx.size, ctx.size).copy_(x)
        dist.all_reduce(full, group=model_group())
        return full

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, model_rank() * ctx.size, ctx.size), None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f over the model group (``x`` itself without a model axis
    and in a shape pass over fake tensors)."""
    if model_size() == 1 or _fake(x):
        return x
    return _CopyIn.apply(x)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g over the model group (``x`` itself without a model axis
    and in a shape pass over fake tensors)."""
    if model_size() == 1 or _fake(x):
        return x
    return _ReduceOut.apply(x)


def gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model group's equal blocks of ``dim`` in rank order, differentiably
    (the backward keeps this rank's block). In a shape pass over fake
    tensors: T copies of ``x``."""
    if model_size() == 1:
        return x
    if _fake(x):
        return torch.cat([x] * model_size(), dim)
    return _GatherChannels.apply(x, dim)


def broadcast_(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: global rank ``src``'s ``x`` on every rank (of ``group``,
    default all). A host tensor under NCCL and a tensor in another memory
    layout go through a copy."""
    if not data_parallel():
        return x
    staged = x
    if not x.is_contiguous() or (dist.get_backend() == "nccl" and not x.is_cuda):
        staged = x.to(_comm_device() if not x.is_cuda else x.device).contiguous()
    dist.broadcast(staged, src, group=group)
    if staged is not x:
        x.copy_(staged)
    return x


def _gloo_bytes(x: torch.Tensor) -> torch.Tensor:
    """A host byte view of ``x`` for gloo, whose point-to-point calls take
    host tensors only; bytes carry every dtype."""
    return x.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def send(x: torch.Tensor, dst: int) -> None:
    """``x`` to global rank ``dst``, which calls ``recv`` with its shape and
    dtype. Under NCCL the tensor goes as it is, under gloo as host bytes. The
    two ranks must pair their sends and receives in one order (NCCL has no
    tags)."""
    if dist.get_backend() == "nccl":
        dist.send(x.detach().contiguous(), dst)
    else:
        dist.send(_gloo_bytes(x), dst)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device`` from global rank
    ``src``'s ``send``."""
    if dist.get_backend() == "nccl":
        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, src)
        return out
    host = torch.empty(shape, dtype=dtype)
    dist.recv(host.reshape(-1).view(torch.uint8), src)
    return host.to(device)


def broadcast_in(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``: every rank
    passes a tensor of the shape and dtype, and gets the result (``x``
    itself on ``src``). Under gloo through host bytes."""
    if dist.get_backend() == "nccl":
        x = x.detach().contiguous()
        dist.broadcast(x, src, group=group)
        return x
    host = _gloo_bytes(x).clone()
    dist.broadcast(host, src, group=group)
    return host.view(x.dtype).reshape(x.shape).to(x.device)


def global_or(flag: bool) -> bool:
    """The OR of a per-rank flag over the ranks (an all-reduce MAX; every rank
    must call it together)."""
    if not data_parallel():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def global_batch_sharding(n_ranks: Optional[int] = None, index: Optional[int] = None) -> slice:
    """The rows of the global batch that data shard ``index`` (default this
    rank's) of ``n_ranks`` (default the data axis) holds, ``d::D``: the
    strided split of data/loader.py gives shard d its rows in this order."""
    n_ranks = data_size() if n_ranks is None else n_ranks
    index = data_rank() if index is None else index
    return slice(index, None, n_ranks)


def assemble_global_batch(local_batch: dict) -> dict:
    """The global batch on every rank, from each rank's rows of it (rank r's
    row j is global row ``r + W j``). The ranks may hold different counts:
    a partial final batch of n rows split ``r::W`` gives rank r
    ``ceil((n - r) / W)`` of them. Entries that are not tensors (``name``
    lists) stay this rank's. One process: the batch as it is."""
    if not data_parallel():
        return dict(local_batch)
    n_ranks, me = world_size(), rank()
    out = {}
    for key, value in local_batch.items():
        if not torch.is_tensor(value):
            out[key] = value
            continue
        counts = torch.zeros(n_ranks, dtype=torch.int64, device=_comm_device())
        counts[me] = value.shape[0]
        dist.all_reduce(counts)
        counts = counts.tolist()
        staged = value.to(torch.uint8) if value.dtype == torch.bool else value
        buf = staged.new_zeros((n_ranks, max(counts)) + tuple(value.shape[1:]))
        buf[me, :value.shape[0]] = staged
        dist.all_reduce(buf)
        g = torch.arange(sum(counts), device=buf.device)
        out[key] = buf[g % n_ranks, g // n_ranks].to(value.dtype)
    return out
