"""The Oxford-IIIT Pet dataset of smp's binary-segmentation example
(counterpart of stcd_tpu/data/oxford_pet.py).

Reads a local tree in the dataset's layout: ``{root}/images/*.jpg``,
``{root}/annotations/trimaps/*.png`` and the split lists
``annotations/{trainval,test}.txt``; train and valid are taken from
trainval.txt by index modulo 10. Nothing is downloaded. An item is a dict of
numpy arrays: ``image`` (H, W, 3) uint8, ``mask`` float32 (trimap 1 and 3
are the pet, 2 the background), ``trimap`` and ``name``.
``SimpleOxfordPetDataset`` resizes image, mask and trimap to 256x256 and adds
``label`` (the mask, (256, 256, 1)).
"""

from __future__ import annotations

import os

import numpy as np


class OxfordPetDataset:
    def __init__(self, root: str, mode: str = "train"):
        assert mode in {"train", "valid", "test"}
        self.root = root
        self.mode = mode
        self.images_directory = os.path.join(root, "images")
        self.masks_directory = os.path.join(root, "annotations", "trimaps")
        self.filenames = self._read_split()

    def __len__(self):
        return len(self.filenames)

    def _read_split(self):
        split_filename = "test.txt" if self.mode == "test" else "trainval.txt"
        split_filepath = os.path.join(self.root, "annotations", split_filename)
        with open(split_filepath) as f:
            split_data = f.read().strip("\n").split("\n")
        filenames = [x.split(" ")[0] for x in split_data]
        if self.mode == "train":
            filenames = [x for i, x in enumerate(filenames) if i % 10 != 0]
        elif self.mode == "valid":
            filenames = [x for i, x in enumerate(filenames) if i % 10 == 0]
        return filenames

    @staticmethod
    def _preprocess_mask(mask):
        mask = mask.astype(np.float32)
        mask[mask == 2.0] = 0.0
        mask[(mask == 1.0) | (mask == 3.0)] = 1.0
        return mask

    def __getitem__(self, idx):
        from PIL import Image

        filename = self.filenames[idx]
        image = np.asarray(Image.open(
            os.path.join(self.images_directory, filename + ".jpg")).convert("RGB"))
        trimap = np.asarray(Image.open(os.path.join(self.masks_directory, filename + ".png")))
        mask = self._preprocess_mask(trimap)
        return {"image": image, "mask": mask, "trimap": trimap, "name": filename}


class SimpleOxfordPetDataset(OxfordPetDataset):
    def __getitem__(self, idx):
        from PIL import Image

        sample = super().__getitem__(idx)
        image = np.asarray(Image.fromarray(sample["image"]).resize((256, 256), Image.BILINEAR))
        mask = np.asarray(Image.fromarray(sample["mask"]).resize((256, 256), Image.NEAREST))
        trimap = np.asarray(Image.fromarray(sample["trimap"]).resize((256, 256), Image.NEAREST))
        sample["image"] = image
        sample["mask"] = mask[..., None]
        sample["trimap"] = trimap[..., None]
        sample["label"] = sample["mask"]
        return sample


def write_synthetic_tree(root: str, n_trainval: int = 72, n_test: int = 8,
                         min_size: int = 300, max_size: int = 500, seed: int = 0):
    """A seeded stand-in for the dataset under ``root``: JPEG images of mixed
    sizes in [min_size, max_size), each with one elliptical "pet" of its own
    colour on a noisy background; trimaps of 1 (pet), 3 (its border ring) and
    2 (background); trainval.txt and test.txt in the dataset's line format
    (``name class species breed``). Returns the names, trainval first."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations", "trimaps"), exist_ok=True)
    names = [f"Pet_{i}" for i in range(n_trainval + n_test)]
    for name in names:
        h, w = (int(v) for v in rng.integers(min_size, max_size, 2))
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.3) * h, rng.uniform(0.15, 0.3) * w
        yy, xx = np.mgrid[0:h, 0:w]
        r = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        trimap = np.full((h, w), 2, np.uint8)
        trimap[r <= 1.2] = 3
        trimap[r <= 1.0] = 1
        image = rng.integers(0, 120, (h, w, 3)).astype(np.float32)
        image[r <= 1.0] += rng.integers(60, 136, 3)
        Image.fromarray(image.clip(0, 255).astype(np.uint8)).save(
            os.path.join(root, "images", name + ".jpg"), quality=90)
        Image.fromarray(trimap).save(os.path.join(root, "annotations", "trimaps", name + ".png"))
    for split, part in (("trainval", names[:n_trainval]), ("test", names[n_trainval:])):
        with open(os.path.join(root, "annotations", split + ".txt"), "w") as f:
            f.write("".join(f"{name} 1 1 1\n" for name in part))
    return names
