"""Eval-time preprocessing (counterpart of the eval part of
stcd_tpu/data/augment.py, :187-202 and :358-359). NHWC in and out, as the
JAX functions; the train-time augmentation comes with the training port."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """ImageNet normalisation over the last (channel) axis."""
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - m) / s


def to_float01(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float input passes through."""
    if not img.is_floating_point():
        return img.to(torch.float32) / 255.0
    return img


def eval_preprocess(img: torch.Tensor) -> torch.Tensor:
    return normalize(to_float01(img))
