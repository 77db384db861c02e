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

REDUCE_BLOCKS = 64  # partial sums per image; must match kReduceBlocks in augment.cu


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
    on anything else. ``kernel_launches`` counts the calls (one per call,
    whatever number of CUDA launches it makes).

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
    if n > 65535 or h * w > 2 ** 24:
        raise ValueError(f"batch {tuple(imgs.shape)} is beyond the kernel's grid")
    perm = params["perm"].to(torch.int32).contiguous()
    factors = params["factors"].to(torch.float32).contiguous()
    flags = torch.stack([params["jitter_apply"], params["gray_apply"],
                         params["blur_apply"]], dim=1).to(torch.int32).contiguous()
    kern = params["blur_kern"].to(torch.float32).contiguous()
    lib = _build.load_library()
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=imgs.device)
    scratch = torch.empty_like(out)  # the pre-blur image of the blurred images
    partials = torch.empty((n, REDUCE_BLOCKS), dtype=torch.float32, device=imgs.device)
    err = lib.stcd_augment_fwd(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), perm.data_ptr(),
        factors.data_ptr(), flags.data_ptr(), kern.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), partials.data_ptr(), n, h, w, imgs.device.index,
        torch.cuda.current_stream(imgs.device).cuda_stream)
    _build.check(lib, err, "stcd_augment_fwd")
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
