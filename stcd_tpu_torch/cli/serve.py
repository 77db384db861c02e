"""Change-detection inference server (counterpart of scripts/serve.py; the
design is in stcd_tpu_torch/serving/server.py).

Builds the model once (same model flags as ``cli.predict``), runs one
warm-up batch, then serves HTTP requests with cross-request tile
micro-batching.

Usage:
  python -m stcd_tpu_torch.cli.serve --init_seed 0 --port 8475 \\
      [--weights segcd.pt] [--net_G ChangeFormerV6] \\
      [--batch 16 --tile 256 --max_wait_ms 5 --bf16]
  curl -s localhost:8475/healthz
"""

from __future__ import annotations

import argparse

import torch

from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_base_fn
from stcd_tpu_torch.serving.server import BatchingEngine, serve


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
    args = p.parse_args(argv)

    model = build_model(args)
    base_fn = make_base_fn(args, model)
    device = next(model.parameters()).device
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
