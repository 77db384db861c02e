"""Debug dump (counterpart of stcd_tpu/utils/debug.py).

``save_to_mat`` mirrors the reference's feature-dump helper
(models/help_funcs.py:189-215): the two input images, the per-level
features of both temporal streams and the final change prediction in one
MATLAB .mat file, under a directory given as a parameter.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def save_to_mat(x1, x2, fx1: Sequence, fx2: Sequence, cp: Sequence,
                file_name: str, out_dir: str = "vis/mat") -> str:
    """Dump inputs, per-level features and the final prediction (``cp[-1]``)
    to ``{out_dir}/{file_name}.mat``. Takes tensors (any device and float
    dtype; floats are saved as float32) or numpy arrays. Returns the path."""
    from scipy.io import savemat

    mdic = {"x1": _numpy(x1), "x2": _numpy(x2), "final_pred": _numpy(cp[-1])}
    for i, (f1, f2) in enumerate(zip(fx1, fx2)):
        mdic[f"fx1_{i}"] = _numpy(f1)
        mdic[f"fx2_{i}"] = _numpy(f2)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, file_name + ".mat")
    savemat(path, mdic)
    return path
