"""Whole-scene tiled inference (counterpart of stcd_tpu/data/tiled_inference.py,
without mesh sharding): tile a scene in memory, run the model over fixed-size
tile batches on one device, and stitch the predictions back, averaging
overlaps."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from stcd_tpu_torch.cli.predict import resolve_device


def tile_origins(h: int, w: int, tile: int = 256, stride: int = 256) -> list:
    """Top-left (y, x) corners covering an (h, w) scene. Edge tiles are
    shifted inward so every pixel is covered."""
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if ys[-1] + tile < h:
        ys.append(h - tile)
    if xs[-1] + tile < w:
        xs.append(w - tile)
    return [(y, x) for y in ys for x in xs]


def extract_tiles(image: np.ndarray, tile: int = 256, stride: int = 256
                  ) -> Tuple[np.ndarray, list]:
    """(H, W, C) -> (N, tile, tile, C) + origin list (see tile_origins)."""
    origins = tile_origins(image.shape[0], image.shape[1], tile, stride)
    tiles = [image[y:y + tile, x:x + tile] for y, x in origins]
    return np.stack(tiles), origins


def stitch_tiles(tiles: np.ndarray, origins: list, out_hw: Tuple[int, int]
                 ) -> np.ndarray:
    """Average overlapping tile predictions back into (H, W, C)."""
    if len(tiles) != len(origins):
        raise ValueError(f"{len(tiles)} tile predictions for {len(origins)} origins")
    t = tiles.shape[1]
    c = tiles.shape[-1]
    acc = np.zeros((*out_hw, c), np.float64)
    cnt = np.zeros((*out_hw, 1), np.float64)
    for tile_arr, (y, x) in zip(tiles, origins):
        acc[y:y + t, x:x + t] += tile_arr
        cnt[y:y + t, x:x + t] += 1
    return (acc / np.maximum(cnt, 1)).astype(np.float32)


@torch.inference_mode()
def predict_scene(predict_fn: Callable, image_a: np.ndarray,
                  image_b: Optional[np.ndarray] = None, tile: int = 256,
                  stride: int = 256, batch: int = 4, device="cuda") -> np.ndarray:
    """Run ``predict_fn(tiles_a[, tiles_b]) -> probs`` (NHWC tensors on
    ``device``) over a whole scene. The last short batch is zero-padded to
    ``batch`` and the padding dropped after, so every step has one shape.
    ``device`` defaults to the card; without one the call raises."""
    device = resolve_device(device)
    tiles_a, origins = extract_tiles(image_a, tile, stride)
    tiles_b = extract_tiles(image_b, tile, stride)[0] if image_b is not None else None
    n = tiles_a.shape[0]
    outs = []
    for i in range(0, n, batch):
        parts = [tiles_a[i:i + batch]]
        if tiles_b is not None:
            parts.append(tiles_b[i:i + batch])
        pad = batch - parts[0].shape[0]
        if pad:
            parts = [np.concatenate([p, np.zeros((pad,) + p.shape[1:], p.dtype)])
                     for p in parts]
        pred = predict_fn(*[torch.from_numpy(p).to(device) for p in parts])
        pred = pred.float().cpu().numpy()
        outs.append(pred[:batch - pad])
    return stitch_tiles(np.concatenate(outs), origins, image_a.shape[:2])
