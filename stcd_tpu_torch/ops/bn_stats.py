"""BatchNorm statistics: per-channel sum and sum of squares (counterpart of
stcd_tpu/ops/bn_stats.py).

``bn_stats(x)`` takes a channels-last ``(..., C)`` tensor, bfloat16 or
float32, and returns ``(sum, sum of squares)`` over all leading dims, each
``float32[C]`` accumulated in float32. It dispatches on the tensor's device:

- a CUDA tensor goes to the hand-written kernel ``csrc/bn_stats.cu``
  (``bn_stats_kernel``), or the call raises: there is no fallback;
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

from typing import Optional, Tuple

import torch

from stcd_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kThreads in bn_stats.cu. It only steers the choice of ``blocks`` here: the kernel
# takes any blocks >= 1, launches that many and writes that many scratch rows, and
# the C entry checks ``vec`` against c and the pointer itself.
_THREADS = 256
_TARGET_BLOCKS = 1056  # 8 blocks for each of an H100's 132 SMs


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


def _geometry(rows: int, c: int, itemsize: int, aligned: bool) -> Tuple[int, int]:
    """(channels per load, row blocks) of the launch: a function of the shape
    and dtype alone, so two runs on one input add in one order."""
    vec = 16 // itemsize
    if c % vec != 0 or not aligned:
        vec = 1
    groups = c // vec
    col_tiles = (groups + _THREADS - 1) // _THREADS
    row_slots = _THREADS // min(groups, _THREADS)
    blocks = min((rows + row_slots - 1) // row_slots, max(1, _TARGET_BLOCKS // col_tiles))
    return vec, max(1, blocks)


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[-1]
    rows = x.numel() // c
    vec, blocks = _geometry(rows, c, x.element_size(), x.data_ptr() % 16 == 0)
    lib = _build.load_library()
    out_sum = torch.empty((c,), dtype=torch.float32, device=x.device)
    out_sq = torch.empty_like(out_sum)
    part = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    err = lib.stcd_bn_stats_fwd(
        x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), out_sum.data_ptr(),
        out_sq.data_ptr(), rows, c, _DTYPE_CODE[x.dtype], vec, blocks, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "stcd_bn_stats_fwd")
    bn_stats_kernel.kernel_launches += 1
    return out_sum, out_sq


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
    """Launch ``csrc/bn_stats.cu`` on x's device and current stream.

    Takes a contiguous CUDA tensor of float32 or bfloat16; raises on anything
    else. ``kernel_launches`` counts the calls."""
    _check_args(x)
    if not x.is_cuda:
        raise RuntimeError(f"bn_stats_kernel needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("bn_stats_kernel needs a contiguous channels-last tensor")
    if x.shape[-1] > 2 ** 24:
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
