"""Change-detection inference server (counterpart of scripts/serve.py; the
design is in stcd_tpu_torch/serving/server.py).

Builds the model once (same model flags as ``cli.predict``), runs one
warm-up batch, then serves HTTP requests with cross-request tile
micro-batching. ``--int8`` runs the convs in int8 (``serving/quant.py``),
calibrated on the first tile of up to 8 image pairs of ``--calib_dir``, which
it requires: ``A/`` and ``B/`` subdirectories matched by file name, or a flat
directory whose sorted listing pairs consecutive files (0_A, 0_B, 1_A, ...).

Usage:
  python -m stcd_tpu_torch.cli.serve --init_seed 0 --port 8475 \\
      [--load_path runs/STCD | --weights segcd.pt] [--net_G ChangeFormerV6] \\
      [--batch 16 --tile 256 --max_wait_ms 5 --bf16] [--int8 --calib_dir tiles/]
  curl -s localhost:8475/healthz
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from stcd_tpu_torch.cli.predict import (add_model_args, build_model, make_base_fn,
                                        quantize_base_fn)
from stcd_tpu_torch.serving.server import BatchingEngine, serve


def calibration_tiles(calib_dir: str, tile: int, limit: int = 8):
    """The first ``tile`` x ``tile`` tile of each of up to ``limit`` usable
    image pairs of ``calib_dir`` (scripts/serve.py:74-104): pairs from ``A/``
    and ``B/`` matched by name, or consecutive files of the sorted flat
    listing; a scene smaller than the tile is skipped."""
    from stcd_tpu_torch.data.io import read_image
    from stcd_tpu_torch.data.tiled_inference import extract_tiles

    dir_a, dir_b = os.path.join(calib_dir, "A"), os.path.join(calib_dir, "B")
    if os.path.isdir(dir_a) and os.path.isdir(dir_b):
        names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
        pairs = [(os.path.join(dir_a, n), os.path.join(dir_b, n)) for n in names]
    else:
        flat = sorted(glob.glob(os.path.join(calib_dir, "*.*")))
        pairs = list(zip(flat[0::2], flat[1::2]))
    tiles_a, tiles_b = [], []
    for fa, fb in pairs:
        if len(tiles_a) >= limit:
            break
        im_a, im_b = read_image(fa), read_image(fb)
        if min(im_a.shape[:2]) < tile or min(im_b.shape[:2]) < tile:
            print(f"calib: skipping {fa} (< {tile}px)")
            continue
        tiles_a.append(extract_tiles(im_a, tile, tile)[0][0])
        tiles_b.append(extract_tiles(im_b, tile, tile)[0][0])
    if not tiles_a:
        raise SystemExit(f"--calib_dir {calib_dir}: need >= 1 usable pair of images >= "
                         f"{tile}px (A/ and B/ subdirectories or an even sorted flat listing)")
    return np.stack(tiles_a), np.stack(tiles_b)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8475)
    p.add_argument("--batch", type=int, default=16,
                   help="fixed device batch size (partial batches are zero-padded)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="max added latency while filling a batch")
    p.add_argument("--calib_dir", default=None,
                   help="--int8 calibration images: A/ and B/ subdirectories (pairs by "
                        "file name) or a flat directory whose sorted listing pairs "
                        "consecutive files; --int8 requires it")
    args = p.parse_args(argv)
    if args.int8 and not args.calib_dir:
        raise SystemExit("--int8 needs --calib_dir (scene images to calibrate the "
                         "activation scales on)")

    model = build_model(args)
    base_fn = make_base_fn(args, model)
    device = next(model.parameters()).device
    if args.int8:
        ca, cb = (torch.from_numpy(t).to(device)
                  for t in calibration_tiles(args.calib_dir, args.tile))
        base_fn, _ = quantize_base_fn(model, base_fn, ca, cb)
    # warm the one batch shape before accepting traffic
    with torch.inference_mode():
        z = torch.zeros((args.batch, args.tile, args.tile, 3), device=device)
        base_fn(z, z).cpu()
    print(f"warmed batch={args.batch} tile={args.tile} on {device}", flush=True)

    engine = BatchingEngine(base_fn, tile=args.tile, batch=args.batch,
                            max_wait_ms=args.max_wait_ms, device=device)
    httpd = serve(engine, args.host, args.port, args.threshold)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          "(/predict, /healthz, /stats)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()


if __name__ == "__main__":
    main()
