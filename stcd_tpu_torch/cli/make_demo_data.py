"""Write a miniature synthetic WHU-AB + LEVIR tree with every file-layout
convention of the reference, so that the three stages can run end to end
without the real datasets (counterpart of scripts/make_demo_data.py: for a
seed it writes the same files, byte for byte).

Usage:
  python -m stcd_tpu_torch.cli.make_demo_data <root> [--n 8] [--size 64] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _save(arr, path):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _write_text(path, text):
    with open(path, "w") as f:
        f.write(text)


def make_tree(root: str, n: int = 8, size: int = 64, seed: int = 0):
    """``n`` train and ``max(n // 2, 2)`` val tiles of ``size`` x ``size``
    for each of WHU-AB and LEVIR under ``root``."""
    rng = np.random.default_rng(seed)

    def tile():
        return (rng.uniform(0.2, 0.8, (size, size, 3)) * 255).astype(np.uint8)

    def blob_label():
        lab = np.zeros((size, size), np.uint8)
        y, x = rng.integers(4, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        lab[y:y + h, x:x + w] = 255
        return lab

    for split, count in (("train", n), ("val", max(n // 2, 2))):
        # WHU-AB: the seg pretraining and pseudo-change synthesis side
        whu = os.path.join(root, "WHU-AB", split)
        names = [f"{i}.tif" for i in range(count)]
        for nm in names:
            img = tile()
            lab = blob_label()
            lab3 = np.stack([lab] * 3, -1)
            _save(img, f"{whu}/A/{nm}")
            _save(lab3, f"{whu}/A_label/{nm}")
            # the "inpainted building-free" B of a changed tile
            inp = img.copy()
            inp[lab > 0] = rng.integers(0, 255, 3, dtype=np.uint8)
            _save(inp, f"{whu}/WHU-A/{nm.replace('tif', 'png')}")
            _save(img, f"{whu}/B/{nm}")
            _save(lab3, f"{whu}/label/{nm}")
        _save(np.zeros((size, size, 3), np.uint8), f"{whu}/A_label/3.tif")
        _save(np.zeros((size, size, 3), np.uint8), f"{whu}/label/0.tif")
        os.makedirs(f"{whu}/list", exist_ok=True)
        _write_text(f"{whu}/list/{split}.txt", "\n".join(names))
        _write_text(f"{whu}/list/changed.txt", "\n".join(names[::2]))

        # LEVIR: the CD side (real pairs and pseudo labels)
        lev = os.path.join(root, "LEVIR", split)
        lnames = [f"{i}.png" for i in range(count)]
        for nm in lnames:
            a = tile()
            lab = blob_label()
            b = a.copy()
            b[lab > 0] = rng.integers(0, 255, (int((lab > 0).sum()), 3), dtype=np.uint8)
            lab3 = np.stack([lab] * 3, -1)
            _save(a, f"{lev}/A/{nm}")
            _save(b, f"{lev}/B/{nm}")
            _save(lab3, f"{lev}/label/{nm}")
            _save(lab3, f"{lev}/pseudo_label_WHU/{nm}")
        os.makedirs(f"{lev}/list", exist_ok=True)
        _write_text(f"{lev}/list/{split}.txt", "\n".join(lnames))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    ns = p.parse_args(argv)
    make_tree(ns.root, ns.n, ns.size, ns.seed)
    print("demo tree at", ns.root)


if __name__ == "__main__":
    main()
