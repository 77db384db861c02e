"""BatchNorm statistics: per-channel sum and sum of squares (counterpart of
stcd_tpu/ops/bn_stats.py).

``bn_stats(x)`` takes a channels-last ``(..., C)`` tensor, bfloat16 or
float32, and returns ``(sum, sum of squares)`` over all leading dims, each
``float32[C]`` accumulated in float32. It dispatches on the tensor's device:

- a CUDA tensor goes to the hand-written kernel ``csrc/bn_stats.cu``
  (``bn_stats_kernel``: one CUDA launch, planned by ``bn_stats_plan``), or
  the call raises: there is no fallback;
- a CPU tensor goes to the plain PyTorch version ``bn_stats_plain``.

The gradient is the JAX package's: ``dx = g_sum + 2 x g_sumsq`` in float32,
cast to x's dtype; an elementwise expression that stays plain PyTorch there
and here.

A standalone op, as in the JAX package: ``layers/norm.py`` does not call it.
The TPU kernel's lane folding of narrow C, its ``supports_pallas`` shape rule
and its ``custom_partitioning`` rule are not carried over: the kernel takes
any number of rows and any C.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from stcd_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Constants of bn_stats.cu (kThreads, kSms, ...): the plan mirrors its plan_for, and
# its C entry refuses a plan that is not its own.
THREADS = 256           # a block's threads
SMS = 132               # streaming multiprocessors of an H100
BLOCKS_PER_SM = 2       # persistent blocks an SM, all resident at once
DEPTH = 8               # 16-byte loads a thread issues before it sums any
TICKET_SLOTS = 4096     # ticket slots: one for each (device, stream) and captured call
TICKETS_PER_SLOT = 32   # a ticket for each finishing group and the top one
MAX_C = 2 ** 24


def bn_stats_plan(rows: int, c: int, itemsize: int, aligned: bool) -> dict:
    """The launch of ``csrc/bn_stats.cu`` for a (rows, c) view of ``itemsize``
    bytes an element (4 float32, 2 bfloat16); ``aligned``: x starts on a
    16-byte boundary. A function of these alone, so two runs on one input add
    in one order.

    ``vec`` channels a thread loads at once (16 bytes, or 1 where c or the
    pointer does not allow it); ``width`` channel groups and ``row_slots`` rows
    a pass of a block of THREADS, ``col_tiles`` column tiles where c / vec >
    THREADS; ``blocks`` persistent blocks a column tile (at most BLOCKS_PER_SM
    x SMS in all, so all are resident at once), each owning ``rows_per_block``
    contiguous rows, a whole number of passes; finishing groups of
    ``group_blocks`` neighbouring blocks (``groups`` of them), the partial rows
    and group rows of the scratch (``part_rows``). The load scheme,
    ``"ldg"``: DEPTH 16-byte loads in flight a thread, ``bytes_in_flight`` an
    SM at most."""
    if rows < 1 or c < 1:
        raise ValueError(f"bn_stats_plan takes rows, c >= 1, got {(rows, c)}")
    if itemsize not in (2, 4):
        raise ValueError(f"bn_stats_plan takes 2- or 4-byte elements, got {itemsize}")
    if c > MAX_C:
        raise ValueError(f"C = {c} is beyond the kernel's grid")
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    groups = c // vec
    col_tiles = -(-groups // THREADS)
    width = min(groups, THREADS)
    row_slots = THREADS // width
    target = max(1, SMS * BLOCKS_PER_SM // col_tiles)
    rows_per_block = -(-(-(-rows // target)) // row_slots) * row_slots
    blocks = -(-rows // rows_per_block)
    group_blocks = math.isqrt(blocks - 1) + 1  # the least g with g * g >= blocks
    n_groups = -(-blocks // group_blocks)
    return {"vec": vec, "width": width, "row_slots": row_slots, "col_tiles": col_tiles,
            "blocks": blocks, "rows_per_block": rows_per_block, "group_blocks": group_blocks,
            "groups": n_groups, "part_rows": blocks + (n_groups if n_groups > 1 else 0),
            "scheme": "ldg",
            "bytes_in_flight": BLOCKS_PER_SM * width * row_slots * DEPTH * vec * itemsize,
            "launches": 1}


def _check_args(x: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"bn_stats takes a channels-last (..., C) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bn_stats takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def bn_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: upcast to float32, sum x and x*x over the rows of
    the (rows, C) view. Its gradient is autograd's."""
    _check_args(x)
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


# The tickets are a static array of the loaded library, one for the process, so
# their slots are handed out process-wide.
_SLOTS: Dict[Tuple[int, int], int] = {}  # (device, stream) -> slot of its eager calls
_CAPTURED_SLOTS: List[int] = []          # a slot for each call captured into a CUDA graph
_SLOTS_LOCK = threading.Lock()


def _ticket_slot(device: int, stream: int, capturing: bool = False) -> int:
    """The ticket slot of a call on a (device, stream). An eager call takes its
    stream's slot, its own for as long as the process lives, so that calls on
    two streams never share a ticket. A call that a stream is capturing into a
    CUDA graph takes a new slot of its own: graphs are captured on one shared
    stream but may be replayed at once on two. Slots are never given back, so
    a process has at most TICKET_SLOTS streams and captured calls in all."""
    with _SLOTS_LOCK:
        if not capturing and (device, stream) in _SLOTS:
            return _SLOTS[(device, stream)]
        slot = len(_SLOTS) + len(_CAPTURED_SLOTS)
        if slot >= TICKET_SLOTS:
            raise RuntimeError(f"bn_stats_kernel serves at most {TICKET_SLOTS} (device, "
                               f"stream) pairs and captured calls in a process")
        if capturing:
            _CAPTURED_SLOTS.append(slot)
        else:
            _SLOTS[(device, stream)] = slot
        return slot


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[-1]
    rows = x.numel() // c
    plan = bn_stats_plan(rows, c, x.element_size(), x.data_ptr() % 16 == 0)
    lib = _build.load_library()
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, plan["part_rows"], c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
    err = lib.stcd_bn_stats_fwd(
        x.data_ptr(), part.data_ptr(), out.data_ptr(), rows, c, _DTYPE_CODE[x.dtype],
        plan["vec"], plan["blocks"], plan["rows_per_block"], plan["group_blocks"],
        plan["part_rows"], _ticket_slot(x.device.index, stream, capturing), x.device.index,
        stream)
    _build.check(lib, err, "stcd_bn_stats_fwd")
    bn_stats_kernel.kernel_launches += 1
    return out[0], out[1]


class _BnStatsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, g_sum, g_sq):
        (x,) = ctx.saved_tensors
        dx = g_sum.float() + 2.0 * x.float() * g_sq.float()
        return dx.to(x.dtype)


def bn_stats_kernel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bn_stats.cu`` on x's device and current stream: one CUDA
    launch, with the plan of ``bn_stats_plan``.

    Takes a contiguous CUDA tensor of float32 or bfloat16; raises on anything
    else. ``kernel_launches`` counts the calls. The finish counts arrivals on
    integer tickets: eager calls use their stream's slot of tickets, and a call
    captured into a CUDA graph a slot of its own, so graphs may replay at once
    on two streams, but replays of one graph must not overlap each other. A
    process gets TICKET_SLOTS slots in all, never given back: one for each
    (device, stream) that calls eagerly and one for each captured call; past
    them the wrapper raises."""
    _check_args(x)
    if not x.is_cuda:
        raise RuntimeError(f"bn_stats_kernel needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("bn_stats_kernel needs a contiguous channels-last tensor")
    if x.shape[-1] > MAX_C:
        raise ValueError(f"C = {x.shape[-1]} is beyond the kernel's grid")
    if torch.is_grad_enabled() and x.requires_grad:
        return _BnStatsFunction.apply(x)
    return _launch(x)


bn_stats_kernel.kernel_launches = 0


def bn_stats(x: torch.Tensor, impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum(x) and sum(x*x) over all leading dims of ``(..., C)``, float32[C] each.

    ``impl=None`` picks by device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``impl="plain"`` or ``"kernel"`` forces
    one; it exists so that a run on the card can hold the two against each
    other."""
    if impl is None:
        impl = "kernel" if x.is_cuda else "plain"
    if impl == "kernel":
        return bn_stats_kernel(x)
    if impl == "plain":
        return bn_stats_plain(x)
    raise ValueError(f"impl must be None, 'kernel' or 'plain', got {impl!r}")
