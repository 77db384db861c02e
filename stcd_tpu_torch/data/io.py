"""Host-side image and list IO (counterpart of stcd_tpu/data/io.py).

JPEG/PNG decode goes through the port's native C++ decoder when it builds
(stcd_tpu_torch/native: libjpeg/libpng into numpy buffers, no interpreter
lock); any other format, or a host without the toolchain, reads the file with
PIL. The pixels are the same either way. PIL is imported where it is used, so
that the package imports on hosts without Pillow.

``set_uint8_transfer(True)`` keeps decoded images and labels in uint8, so the
loader moves a quarter of the bytes to the device; the steps scale by 1/255
there (data/augment.py ``to_float01``; train/steps.py casts labels to float).
"""

from __future__ import annotations

import os
import threading
from collections import Counter

import numpy as np

from stcd_tpu_torch import native

_UINT8_TRANSFER = False
_decodes = Counter()  # files read, by decode path ("native" or "pil")
_decodes_lock = threading.Lock()


def set_uint8_transfer(enabled: bool) -> None:
    """Keep decoded images and labels in uint8 on the host (4x fewer bytes to
    the device); the steps convert to float and scale by 1/255 on the device.
    Equal to the float path (n / 255 either way) up to float32 rounding."""
    global _UINT8_TRANSFER
    _UINT8_TRANSFER = bool(enabled)


def decode_counts() -> dict:
    """Files read since the last ``reset_decode_counts()``, by decode path."""
    with _decodes_lock:
        return dict(_decodes)


def reset_decode_counts() -> None:
    with _decodes_lock:
        _decodes.clear()


def _read_rgb_u8(path: str) -> np.ndarray:
    arr = native.decode_rgb(path)
    how = "native"
    if arr is None:  # not JPEG/PNG, a decode error, or no native library
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        how = "pil"
    with _decodes_lock:
        _decodes[how] += 1
    return arr


def read_image(path: str) -> np.ndarray:
    """RGB image HWC: float32 in [0, 1] (torchvision ToTensor parity), or
    uint8 in [0, 255] under ``set_uint8_transfer(True)``."""
    arr = _read_rgb_u8(path)
    if _UINT8_TRANSFER:
        return arr
    return arr.astype(np.float32) / 255.0


def read_label(path: str) -> np.ndarray:
    """Binary label from the R channel of an RGB-read PNG, binarised as
    ``label >= 1``: (H, W, 1) in {0, 1}, float32, or uint8 under
    ``set_uint8_transfer(True)``."""
    lab = _read_rgb_u8(path)[..., 0:1] >= 1
    return lab.astype(np.uint8 if _UINT8_TRANSFER else np.float32)


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
