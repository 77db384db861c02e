"""Host-side dataset classes (counterpart of stcd_tpu/data/datasets.py).

The datasets do IO and pairing only and yield HWC images and (H, W, 1)
labels as numpy arrays: float32 in [0, 1], or uint8 under
``data.io.set_uint8_transfer(True)``. The photometric augmentation and the
normalisation run on the device inside the train step (data/augment.py).

File layout (the reference's): ``{root}/{dataset}/{split}/{A, B, A_label,
label, WHU-A, pseudo_label, pseudo_label_WHU, ff_label,
list/{split,changed,reliable_ids,...}.txt}``.

Classes, each with the keys of its JAX counterpart:
- WHUDataset    (image, label)
- CDDataset     (A, B, label) [never augmented]
- FFCDataset    (A, B, label from ff_label/)
- SCDataset     (A, B, s_label_A, s_label_B, c_label [+ CA, CB, CL])
- PSEDataset    (A, B, label from pseudo_label_WHU/)
- LEVIRDataset  (the nine keys of the joint seg + change sampler)
- SyntheticCDDataset: deterministic random pairs for tests and benchmarks.
Every sample also carries its ``name``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from stcd_tpu_torch.data.io import read_image, read_label, read_list


class _Base:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class WHUDataset(_Base):
    """Single-image segmentation pairs (ref data/dataset.py:127-166).

    Yields {image, label}; ids come from list/{split}.txt; length follows
    the A/ file listing (the reference's len() uses files, ids index —
    reproduced)."""

    def __init__(self, root_path: str, dataset: str, train_val: str):
        self.train = train_val
        self.total_path = os.path.join(root_path, dataset, train_val)
        self.files = sorted(glob.glob(self.total_path + "/A/*.*"))
        self.ids = read_list(os.path.join(self.total_path, "list", train_val + ".txt"))
        self.augment = train_val == "train"

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        name = self.ids[index]
        image = read_image(os.path.join(self.total_path, "A", name))
        label = read_label(os.path.join(self.total_path, "A_label", name))
        return {"image": image, "label": label, "name": name}


class CDDataset(_Base):
    """Bi-temporal eval/inference pairs (ref data/dataset.py:169-212).

    ``reliable``∈{None,'reliable','unreliable'} switches the id list.
    Never augmented (the reference applies normalize only)."""

    def __init__(self, root_path: str, dataset: str, train_val: str,
                 reliable: Optional[str] = None):
        self.total_path = os.path.join(root_path, dataset, train_val)
        if reliable == "reliable":
            list_name = "reliable_ids.txt"
        elif reliable == "unreliable":
            list_name = "unreliable_ids.txt"
        else:
            list_name = train_val + ".txt"
        self.ids = read_list(os.path.join(self.total_path, "list", list_name))
        self.augment = False

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        name = self.ids[index]
        a = read_image(os.path.join(self.total_path, "A", name))
        b = read_image(os.path.join(self.total_path, "B", name))
        label = read_label(os.path.join(self.total_path, "label", name))
        return {"A": a, "B": b, "label": label, "name": name}


class FFCDataset(_Base):
    """Pairs labeled by generated ff_label/ (ref data/dataset.py:215-257)."""

    def __init__(self, root_path: str, dataset: str, train_val: str):
        self.total_path = os.path.join(root_path, dataset, train_val)
        self.files = sorted(glob.glob(self.total_path + "/A/*.*"))
        self.augment = train_val == "train"

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        name = os.path.basename(self.files[index])
        a = read_image(os.path.join(self.total_path, "A", name))
        b = read_image(os.path.join(self.total_path, "B", name))
        label = read_label(os.path.join(self.total_path, "ff_label", name))
        return {"A": a, "B": b, "label": label, "name": name}


class PSEDataset(_Base):
    """Pairs labeled by pseudo_label_WHU/ (ref data/dataset.py:379-421);
    feeds train_pse_cd (ref train_pse_cd.py:185-187)."""

    def __init__(self, root_path: str, dataset: str, train_val: str):
        self.total_path = os.path.join(root_path, dataset, train_val)
        self.files = sorted(glob.glob(self.total_path + "/A/*.*"))
        self.augment = train_val == "train"

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        name = os.path.basename(self.files[index])
        a = read_image(os.path.join(self.total_path, "A", name))
        b = read_image(os.path.join(self.total_path, "B", name))
        label = read_label(os.path.join(self.total_path, "pseudo_label_WHU", name))
        return {"A": a, "B": b, "label": label, "name": name}


class SCDataset(_Base):
    """Pseudo-change pair synthesis (ref data/dataset.py:260-376).

    If the tile is in list/changed.txt, B is the diffusion-inpainted
    building-free version from WHU-A/ (.tif -> .png) and the change label
    is the seg label; otherwise B = A with the all-zero label A_label/3.tif.
    ``semi`` adds a real pair (A,B,pseudo_label) when reliable, else (B,B)
    with zero label label/0.tif.
    """

    def __init__(self, root_path: str, dataset: str, train_val: str,
                 semi: bool = False):
        self.total_path = os.path.join(root_path, dataset, train_val)
        self.files = sorted(glob.glob(self.total_path + "/A/*.*"))
        self.change_ids = set(read_list(os.path.join(self.total_path, "list", "changed.txt")))
        self.semi = semi
        if semi:
            self.reliable_ids = set(read_list(
                os.path.join(self.total_path, "list", "reliable_ids.txt")))
        self.augment = train_val == "train"

    def __len__(self):
        return len(self.files)

    def _seg_side(self, name: str):
        image_a_path = os.path.join(self.total_path, "A", name)
        s_label_a = read_label(os.path.join(self.total_path, "A_label", name))
        nc_label = read_label(os.path.join(self.total_path, "A_label", "3.tif"))
        if name in self.change_ids:
            image_b_path = os.path.join(self.total_path, "WHU-A", name.replace("tif", "png"))
            c_label, s_label_b = s_label_a, nc_label
        else:
            image_b_path = image_a_path
            c_label, s_label_b = nc_label, s_label_a
        return (read_image(image_a_path), read_image(image_b_path),
                s_label_a, s_label_b, c_label)

    def __getitem__(self, index):
        name = os.path.basename(self.files[index])
        a, b, sa, sb, cl = self._seg_side(name)
        out = {"A": a, "B": b, "s_label_A": sa, "s_label_B": sb,
               "c_label": cl, "name": name}
        if not self.semi:
            return out
        if name in self.reliable_ids:
            ca = read_image(os.path.join(self.total_path, "A", name))
            cb = read_image(os.path.join(self.total_path, "B", name))
            clabel = read_label(os.path.join(self.total_path, "pseudo_label", name))
        else:
            cb = read_image(os.path.join(self.total_path, "B", name))
            ca = cb
            clabel = read_label(os.path.join(self.total_path, "label", "0.tif"))
        out.update({"CA": ca, "CB": cb, "CL": clabel})
        return out


class LEVIRDataset(_Base):
    """Joint fine-tune sampler (ref data/dataset.py:424-547): the seg side
    always comes from the (hardcoded in the reference) WHU-AB tree with
    index wraparound at 5939; the change side (CA, CB, CL) from
    {dataset}/A,B,pseudo_label_WHU. Length = change-set length.

    ``seg_dataset`` and ``seg_wrap`` promote the reference's hardcoded
    constants to config with identical defaults.
    """

    def __init__(self, root_path: str, dataset: str, train_val: str,
                 seg_dataset: str = "WHU-AB", seg_wrap: int = 5939):
        self.total_path = os.path.join(root_path, seg_dataset, train_val)
        self.files = sorted(glob.glob(self.total_path + "/A/*.*"))
        self.change_ids = set(read_list(os.path.join(self.total_path, "list", "changed.txt")))
        self.total_change_path = os.path.join(root_path, dataset, train_val)
        self.change_files = sorted(glob.glob(self.total_change_path + "/A/*.*"))
        self.seg_wrap = seg_wrap
        self.augment = train_val == "train"

    def __len__(self):
        return len(self.change_files)

    def __getitem__(self, index):
        seg_index = index % self.seg_wrap if index > self.seg_wrap else index
        name = os.path.basename(self.files[seg_index])
        image_a_path = os.path.join(self.total_path, "A", name)
        s_label_a = read_label(os.path.join(self.total_path, "A_label", name))
        nc_label = read_label(os.path.join(self.total_path, "A_label", "3.tif"))
        if name in self.change_ids:
            image_b_path = os.path.join(self.total_path, "WHU-A", name.replace("tif", "png"))
            c_label, s_label_b = s_label_a, nc_label
        else:
            image_b_path = image_a_path
            c_label, s_label_b = nc_label, s_label_a
        change_name = os.path.basename(self.change_files[index])
        ca = read_image(os.path.join(self.total_change_path, "A", change_name))
        cb = read_image(os.path.join(self.total_change_path, "B", change_name))
        cl = read_label(os.path.join(self.total_change_path, "pseudo_label_WHU", change_name))
        return {"A": read_image(image_a_path), "B": read_image(image_b_path),
                "s_label_A": s_label_a, "s_label_B": s_label_b, "c_label": c_label,
                "CA": ca, "CB": cb, "CL": cl, "name": change_name}


class SyntheticCDDataset(_Base):
    """Deterministic random bi-temporal pairs for tests and benchmarks.

    Images are smooth (block-upsampled coarse noise) and the change blob
    alters B's LOCAL STATISTICS (brightness/contrast), so the task is
    learnable by a Siamese encoder: each branch can encode region
    appearance and the difference head compares them. (An earlier iid-noise
    variant was unlearnable — pixel-identity cannot survive a 5-stage
    encoder, so models could only memorize the train split.)
    """

    def __init__(self, length: int = 16, size: int = 64, seed: int = 1337):
        self.length = length
        self.size = size
        self.seed = seed
        self.augment = False

    def __len__(self):
        return self.length

    def _smooth(self, rng, s):
        # ceil, so that the upsampled grid covers s for any size, a
        # multiple of 8 or not
        g = -(-s // 8)
        coarse = rng.uniform(0, 1, size=(g, g, 3))
        img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:s, :s]
        return img.astype(np.float32)

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed + index)
        s = self.size
        a = self._smooth(rng, s)
        label = np.zeros((s, s, 1), np.float32)
        y, x = rng.integers(0, s // 2, 2)
        h, w = rng.integers(s // 8, s // 2, 2)
        label[y:y + h, x:x + w] = 1.0
        changed = np.clip(0.9 - 0.7 * self._smooth(rng, s), 0.0, 1.0)
        b = np.where(label > 0, changed, a).astype(np.float32)
        return {"A": a, "B": b, "label": label, "image": a, "name": f"syn_{index}.png"}
