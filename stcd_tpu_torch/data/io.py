"""Host-side image and list IO (counterpart of stcd_tpu/data/io.py without
its native decoder and its uint8-transfer switch). PIL and numpy only, PIL
imported where it is used, so that the package imports on hosts without
Pillow."""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """RGB image HWC float32 in [0, 1] (torchvision ToTensor parity)."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr.astype(np.float32) / 255.0


def read_label(path: str) -> np.ndarray:
    """Binary label from the R channel of an RGB-read PNG, binarised as
    ``label >= 1``: (H, W, 1) float32 in {0, 1}."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return (arr[..., 0:1] >= 1).astype(np.float32)


def save_mask_png(mask: np.ndarray, path: str) -> None:
    """Save a {0,1} (or [0,1]) mask as an 8-bit PNG x255."""
    from PIL import Image
    arr = np.asarray(mask)
    if arr.ndim == 3:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def save_jet_png(values: np.ndarray, path: str) -> None:
    """Min-max-normalise a feature or probability map and save it coloured
    with the standard jet ramp (blue, cyan, yellow, red), computed in numpy."""
    from PIL import Image
    arr = np.asarray(values, np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    lo, hi = float(arr.min()), float(arr.max())
    t = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)

    def ramp(c):
        return np.clip(1.5 - np.abs(4.0 * t - c), 0.0, 1.0)

    rgb = np.stack([ramp(3.0), ramp(2.0), ramp(1.0)], axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((rgb * 255).astype(np.uint8)).save(path)


def read_list(path: str) -> list:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def write_list(ids, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i}\n")
