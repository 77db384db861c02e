"""Device names as the port's entry points, models and data take them."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` without a card raises: the port never carries on silently on
    the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def indexed_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the calling thread's current
    card, so that caches and replicas keyed on a device never mix two cards
    under one name."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
