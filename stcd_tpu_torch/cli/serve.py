"""Change-detection inference server (counterpart of scripts/serve.py; the
design is in stcd_tpu_torch/serving/server.py).

Builds the model once (same model flags as ``cli.predict``), puts a replica
of it on each serving card, runs one warm-up batch on every card, then serves
HTTP requests with cross-request tile micro-batching. ``--device cuda``
serves from every visible card, the fixed ``--batch`` split by rows over them
as scripts/serve.py shards it over the mesh's ``data`` axis; ``cuda:N`` or
``--no_shard`` serves from one card, and so does a ``--batch`` that the card
count does not divide (with the JAX script's warning). ``--int8`` runs the
convs in int8 (``serving/quant.py``), one scale table for every card,
calibrated on the first tile of up to 8 image pairs of ``--calib_dir``, which
it requires: ``A/`` and ``B/`` subdirectories matched by file name, or a flat
directory whose sorted listing pairs consecutive files (0_A, 0_B, 1_A, ...).

Usage:
  python -m stcd_tpu_torch.cli.serve --init_seed 0 --port 8475 \\
      [--load_path runs/STCD | --weights segcd.pt] [--net_G ChangeFormerV6] \\
      [--batch 16 --tile 256 --max_wait_ms 5 --bf16] [--int8 --calib_dir tiles/] \\
      [--device cuda:0 | --no_shard]
  curl -s localhost:8475/healthz
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_replicas
from stcd_tpu_torch.parallel.mesh import serving_devices
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


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8475)
    p.add_argument("--batch", type=int, default=16,
                   help="fixed batch size over all the serving devices (partial batches "
                        "are zero-padded)")
    p.add_argument("--no_shard", action="store_true",
                   help="serve from one card even when several are visible (with --bf16 "
                        "or --int8 one card served more tiles/s: PERF.md)")
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
    return args


def build_engine(args) -> BatchingEngine:
    """The model's replicas on the serving cards behind a warmed engine."""
    devices = serving_devices(args.device, args.batch, args.no_shard)
    model = build_model(args)
    calib = None
    if args.int8:
        home = next(model.parameters()).device
        calib = [torch.from_numpy(t).to(home)
                 for t in calibration_tiles(args.calib_dir, args.tile)]
    engine = BatchingEngine(make_replicas(args, model, devices, calib), tile=args.tile,
                            batch=args.batch, max_wait_ms=args.max_wait_ms,
                            devices=devices, quantized=bool(args.int8))
    # warm the one batch shape on every card before accepting traffic
    engine.warm()
    print(f"warmed batch={args.batch} tile={args.tile} on {len(devices)} "
          f"{devices[0].type} device(s)" + (" [mesh-sharded]" if len(devices) > 1 else ""),
          flush=True)
    return engine


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
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
