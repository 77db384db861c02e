"""Offline dataset preparation tools (counterpart of stcd_tpu/data/tools.py;
the reference's split.py and seg_label_process.py with their hard-coded paths
and mode booleans as arguments).

- tile_rasters      crop large rasters into CROPxCROP tiles with STRIDE over
                    the subdirs A/A_label/B/B_label/C_label, numbered in order
- split_dataset     a seeded shuffled train/val/test split across the subdirs
                    (5948/743/rest by default)
- select_changed    tiles whose label area sum / 255 < threshold -> changed.txt
- create_list       directory listing -> list/{split}.txt

Run as: python -m stcd_tpu_torch.data.tools <command> [args]
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import shutil
from os.path import basename, join, splitext

import numpy as np

from stcd_tpu_torch.data.io import write_list


def tile_rasters(data_dir: str, out_dir: str, subset: str = "image_data",
                 subdirs=("A", "A_label", "B", "B_label", "C_label"),
                 crop_size: int = 256, stride: int = 256, ext_glob: str = "*.tif"):
    from PIL import Image

    total = 0
    for subdir in subdirs:
        src = join(data_dir, subset, subdir)
        paths = sorted(glob.glob(join(src, ext_glob)))
        out_subdir = join(out_dir, subdir)
        os.makedirs(out_subdir, exist_ok=True)
        counter = 0
        for path in paths:
            _, ext = splitext(basename(path))
            img = np.asarray(Image.open(path))
            h, w = img.shape[:2]
            for i in range(0, h - crop_size + 1, stride):
                for j in range(0, w - crop_size + 1, stride):
                    tile = img[i:i + crop_size, j:j + crop_size]
                    Image.fromarray(tile).save(join(out_subdir, f"{counter}{ext}"))
                    counter += 1
        total += counter
    return total


def split_dataset(data_dir: str, out_dir: str, n_train: int = 5948,
                  n_val: int = 743, seed: int = 0,
                  subdirs=("A", "A_label", "B", "B_label", "C_label"),
                  ext_glob: str = "*.tif"):
    """Random train/val/test split (ref split.py:49-77, whose shuffle is
    unseeded; seeded here, with ``random.Random(seed)`` as in JAX)."""
    rng = random.Random(seed)
    first = sorted(glob.glob(join(data_dir, subdirs[0], ext_glob)))
    order = list(range(len(first)))
    rng.shuffle(order)
    for subdir in subdirs:
        names = sorted(basename(p) for p in glob.glob(join(data_dir, subdir, ext_glob)))
        for i, oi in enumerate(order):
            split = "train" if i < n_train else ("val" if i < n_train + n_val else "test")
            dst = join(out_dir, split, subdir)
            os.makedirs(dst, exist_ok=True)
            # byte-identical, metadata-preserving copy (re-encoding through
            # PIL would drop TIFF tags and recompress)
            shutil.copy2(join(data_dir, subdir, names[oi]), join(dst, names[oi]))


def select_changed(data_dir: str, out_path: str = "changed.txt",
                   threshold: float = 98304.0):
    """Tiles whose 3-channel label sum / 255 < threshold (i.e. <50% changed
    at 256x256) are listed as 'changed' (ref seg_label_process.py:15-40)."""
    from PIL import Image

    files = sorted(glob.glob(data_dir + "/A_label/*.*"))
    selected = []
    for label_path in files:
        name = basename(label_path)
        label = np.asarray(Image.open(label_path).convert("RGB"), np.float64) / 255.0
        if label.sum() < threshold:
            selected.append(name)
    write_list(selected, out_path)
    return selected


def create_list(data_dir: str, list_name: str = "val.txt", subdir: str = "A",
                ext_glob: str = "*.tif"):
    """Directory listing -> list/{name} (ref seg_label_process.py:43-53)."""
    out = join(data_dir, "list", list_name)
    names = [basename(p) for p in sorted(glob.glob(join(data_dir, subdir, ext_glob)))]
    write_list(names, out)
    return names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tile")
    t.add_argument("data_dir"); t.add_argument("out_dir")
    t.add_argument("--subset", default="image_data")
    t.add_argument("--crop_size", type=int, default=256)
    t.add_argument("--stride", type=int, default=256)
    s = sub.add_parser("split")
    s.add_argument("data_dir"); s.add_argument("out_dir")
    s.add_argument("--n_train", type=int, default=5948)
    s.add_argument("--n_val", type=int, default=743)
    s.add_argument("--seed", type=int, default=0)
    c = sub.add_parser("select_changed")
    c.add_argument("data_dir")
    c.add_argument("--out", default="changed.txt")
    c.add_argument("--threshold", type=float, default=98304.0)
    l = sub.add_parser("create_list")
    l.add_argument("data_dir")
    l.add_argument("--name", default="val.txt")
    l.add_argument("--subdir", default="A")
    l.add_argument("--ext", default="*.tif")
    args = p.parse_args(argv)
    if args.cmd == "tile":
        tile_rasters(args.data_dir, args.out_dir, args.subset,
                     crop_size=args.crop_size, stride=args.stride)
    elif args.cmd == "split":
        split_dataset(args.data_dir, args.out_dir, args.n_train, args.n_val, args.seed)
    elif args.cmd == "select_changed":
        select_changed(args.data_dir, args.out, args.threshold)
    elif args.cmd == "create_list":
        create_list(args.data_dir, args.name, args.subdir, args.ext)


if __name__ == "__main__":
    main()
