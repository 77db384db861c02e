"""Fused train-time photometric augmentation (counterpart of
stcd_tpu/ops/augment_kernel.py).

``apply_augment_batch`` takes an (N, H, W, 3) NHWC batch, uint8 or float32
in [0, 1], and the draws of ``data.augment.sample_augment_params``, and
returns the augmented, ImageNet-normalised float32 NHWC batch. It
dispatches on the tensor's device:

- a CUDA tensor goes to the hand-written kernel ``csrc/augment.cu``
  (``apply_augment_kernel``), or the call raises: there is no fallback;
- a CPU tensor goes to the plain PyTorch version
  ``data.augment.apply_augment_reference``.

The TPU kernel's planar (N, 3H, W) layout is not carried over: the kernel
reads and writes NHWC, so ``out.permute(0, 3, 1, 2)`` is a channels_last
NCHW tensor without a copy. The random draws are made outside the kernel,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from stcd_tpu_torch.data.augment import BLUR_RADIUS, Params, apply_augment_reference
from stcd_tpu_torch.ops import _build

REDUCE_BLOCKS = 16  # partial sums per image; must match kReduceBlocks in augment.cu
# The tile a block of augment.cu's second launch owns, and the blur's halo
# (kTileH, kTileW, kRadius); the staged tile and halo, one f32 plane a channel,
# rows of kStageStride floats
TILE_H, TILE_W, HALO = 32, 64, 5
STAGE_STRIDE = 76
THREADS = 256
STORE_BYTES = THREADS * 3 * 16  # each warp's 96 16-byte words through which it stores
MAX_GRID_Y = 65535
MAX_PIXELS = 2 ** 24


def augment_plan(n: int, h: int, w: int) -> dict:
    """The launch geometry of ``csrc/augment.cu`` for n images of h x w, which
    its C entry recomputes and checks: launch (a) ``gray_mean_partials`` on
    (REDUCE_BLOCKS, n) blocks, launch (b) ``augment_tiles`` on (tiles_x,
    tiles_y, n) blocks, each owning the TILE_H x TILE_W tile at (TILE_W bx,
    TILE_H by) and, for a blurred image, staging it with its HALO-pixel halo
    ((TILE_H + 2 HALO) x (TILE_W + 2 HALO) pixels, indices clamped to the
    image) in shared memory, beside the words through which each warp stores
    whole rows: ``smem_bytes`` in all."""
    if min(n, h, w) < 1:
        raise ValueError(f"augment_plan takes n, h, w >= 1, got {(n, h, w)}")
    tiles_x, tiles_y = -(-w // TILE_W), -(-h // TILE_H)
    if n > MAX_GRID_Y or tiles_y > MAX_GRID_Y or h * w > MAX_PIXELS:
        raise ValueError(f"batch {(n, h, w)} is beyond the kernel's grid")
    stage_rows = TILE_H + 2 * HALO
    return {"tile_h": TILE_H, "tile_w": TILE_W, "halo": HALO, "tiles_x": tiles_x,
            "tiles_y": tiles_y, "blocks": tiles_x * tiles_y * n,
            "reduce_blocks": REDUCE_BLOCKS, "stage_rows": stage_rows,
            "stage_cols": TILE_W + 2 * HALO, "stage_stride": STAGE_STRIDE,
            "smem_bytes": 3 * stage_rows * STAGE_STRIDE * 4 + STORE_BYTES, "launches": 2}


def _check_args(imgs: torch.Tensor, params: Params) -> None:
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"apply_augment_batch takes (N, H, W, 3), got {tuple(imgs.shape)}")
    if imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {imgs.dtype}")
    n = imgs.shape[0]
    want = {"perm": (n, 4), "factors": (n, 4), "jitter_apply": (n,), "gray_apply": (n,),
            "blur_apply": (n,), "blur_kern": (n, 2 * BLUR_RADIUS + 1)}
    for key, shape in want.items():
        if key not in params:
            raise KeyError(f"augment params lack {key!r}")
        if tuple(params[key].shape) != shape:
            raise ValueError(f"params[{key!r}] has shape {tuple(params[key].shape)}, "
                             f"expected {shape}")


def apply_augment_kernel(imgs: torch.Tensor, params: Params) -> torch.Tensor:
    """Launch ``csrc/augment.cu`` on the images' device and current stream.

    Takes a contiguous CUDA batch and parameters on the same device; raises
    on anything else. ``kernel_launches`` counts the calls (one per call; a
    call makes the two CUDA launches of ``augment_plan``). The draws are read
    as the sampler makes them (perm int64, the three gates bool): a draw of
    another type is converted first.

    The kernel is forward only: it refuses an input that requires grad."""
    _check_args(imgs, params)
    if imgs.requires_grad or any(v.requires_grad for v in params.values()):
        raise RuntimeError("apply_augment_kernel has no backward: its inputs are data "
                           "and must not require grad")
    if not imgs.is_cuda:
        raise RuntimeError(f"apply_augment_kernel needs CUDA tensors, got {imgs.device}")
    if any(v.device != imgs.device for v in params.values()):
        raise RuntimeError("the augment params must lie on the images' device "
                           f"{imgs.device}")
    if not imgs.is_contiguous():
        raise ValueError("apply_augment_kernel needs a contiguous NHWC batch")
    n, h, w, _ = imgs.shape
    if n == 0 or h == 0 or w == 0:
        raise ValueError(f"empty batch {tuple(imgs.shape)}")
    plan = augment_plan(n, h, w)
    # no-ops (no kernel) for the sampler's draws
    perm = params["perm"].to(torch.int64).contiguous()
    factors = params["factors"].to(torch.float32).contiguous()
    gates = [params[key].to(torch.bool).contiguous()
             for key in ("jitter_apply", "gray_apply", "blur_apply")]
    kern = params["blur_kern"].to(torch.float32).contiguous()
    lib = _build.load_library()
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=imgs.device)
    partials = torch.empty((n, REDUCE_BLOCKS), dtype=torch.float32, device=imgs.device)
    err = lib.stcd_augment_fwd(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), perm.data_ptr(),
        factors.data_ptr(), *(g.data_ptr() for g in gates), kern.data_ptr(), out.data_ptr(),
        partials.data_ptr(), n, h, w, plan["tiles_x"], plan["tiles_y"], plan["smem_bytes"],
        imgs.device.index, torch.cuda.current_stream(imgs.device).cuda_stream)
    _build.check(lib, err, "stcd_augment_fwd")
    with _build.COUNT_LOCK:
        apply_augment_kernel.kernel_launches += 1
    return out


apply_augment_kernel.kernel_launches = 0


def apply_augment_batch(imgs: torch.Tensor, params: Params,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Augment and normalise an (N, H, W, 3) batch with sampled draws.

    ``impl=None`` picks by device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``impl="plain"`` or ``"kernel"`` forces
    one; it exists so that a run on the card can hold the two against each
    other."""
    if impl is None:
        impl = "kernel" if imgs.is_cuda else "plain"
    if impl == "kernel":
        return apply_augment_kernel(imgs, params)
    if impl == "plain":
        _check_args(imgs, params)
        return apply_augment_reference(imgs, params)
    raise ValueError(f"impl must be None, 'kernel' or 'plain', got {impl!r}")
