"""Host-side image IO (counterpart of read_image and save_mask_png in
stcd_tpu/data/io.py). PIL only, imported where it is used, so that the
package imports on hosts without Pillow."""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """RGB image HWC float32 in [0, 1] (torchvision ToTensor parity)."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr.astype(np.float32) / 255.0


def save_mask_png(mask: np.ndarray, path: str) -> None:
    """Save a {0,1} (or [0,1]) mask as an 8-bit PNG x255."""
    from PIL import Image
    arr = np.asarray(mask)
    if arr.ndim == 3:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)
