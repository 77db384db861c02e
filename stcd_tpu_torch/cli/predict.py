"""Whole-scene change-map inference from two raster images of any size
(counterpart of scripts/predict.py).

Usage:
  python -m stcd_tpu_torch.cli.predict --image_a t1.png --image_b t2.png \\
      --out change.png (--load_path runs/STCD | --weights segcd.pt | --init_seed 0) \\
      [--encoder resnet50 --decoder_channels 256,128,64,32,16] \\
      [--net_G ChangeFormerV6] \\
      [--tile 256 --stride 128 --threshold 0.5 --prob_out probs.npy --bf16 --int8]

The model is SegCD with ``--encoder`` and ``--decoder_channels`` unless
``--net_G`` names a bespoke-zoo model, as in scripts/predict.py.
``--load_path`` is a run directory of the port's training (``run_training``,
``CheckpointManager``), resolved as scripts/predict.py resolves it: the
``*_best_model``, then ``best_ckpt``, then ``last_ckpt``; or one checkpoint
file. ``--weights`` is a bare state_dict saved with ``torch.save`` under the
original reference's names; ``--init_seed N`` builds seeded random weights
instead (by the model family's rules, as ``CDTrainer.init_state`` does).
The change probability is the sigmoid of a 1-channel change logit (SegCD's
third output), or for a multi-class head the final scale's P(changed) = sum
of the softmax classes 1..C-1. ``--int8`` runs the convs in int8
(``serving/quant.py``), calibrated on the scene's own first tiles.

With ``--device cuda`` the tile batches are split by rows over every visible
card, one replica of the model each (``parallel/mesh.py::serving_devices``),
as scripts/predict.py shards them over the mesh; ``--batch`` defaults to 4 x
the card count. ``cuda:N`` or ``--no_shard`` runs on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os

import numpy as np
import torch

from stcd_tpu_torch.models.factory import NET_G_KEYS
from stcd_tpu_torch.utils.device import indexed_device, resolve_device


def resolve_checkpoint(load_path: str) -> str:
    """The checkpoint file that ``--load_path`` names (scripts/predict.py's
    order): in a run directory the ``*_best_model``, then ``best_ckpt``,
    then ``last_ckpt``; else ``load_path`` itself."""
    if os.path.isdir(load_path):
        from stcd_tpu_torch.train.checkpoint import CheckpointManager
        best = CheckpointManager(load_path).best_path()
        if best is not None:
            return best
        for name in ("best_ckpt", "last_ckpt"):
            if os.path.isfile(os.path.join(load_path, name)):
                return os.path.join(load_path, name)
        raise SystemExit(f"no *_best_model, best_ckpt or last_ckpt under {load_path}")
    if not os.path.isfile(load_path):
        raise SystemExit(f"--load_path {load_path}: no such run directory or file")
    return load_path


def build_model(args) -> torch.nn.Module:
    """The eval-mode model on ``args.device`` with its weights (counterpart
    of build_model_and_state: the module holds its own state).

    On a card, the model's f32 runs in full f32: cuDNN would otherwise run
    f32 convs in TF32, a 10-bit mantissa. ``--bf16`` is the reduced-precision
    route, and the only one."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.net_G:
        from stcd_tpu_torch.models.factory import define_G, init_weights
        # the tile is the zoo's img_size, as in scripts/predict.py; 256, the
        # flag's default, for a Namespace built by hand without it
        model = define_G(args.net_G, n_class=args.n_class, embed_dim=args.embed_dim,
                         img_size=getattr(args, "tile", 256), device=device)
    else:
        from stcd_tpu_torch.models.segcd import SegCD, init_weights
        dec = tuple(int(c) for c in args.decoder_channels.split(","))
        model = SegCD(encoder_name=args.encoder, classes=1, decoder_channels=dec,
                      device=device)
    if getattr(args, "load_path", None):  # a Namespace built by hand may not have it
        path = resolve_checkpoint(args.load_path)
        # every artifact of train/checkpoint.py holds the weights under "model"
        payload = torch.load(path, map_location=device, weights_only=True)
        if not isinstance(payload, dict) or not isinstance(payload.get("model"), dict):
            raise SystemExit(f"{path} is not a checkpoint of the port's training (no "
                             "'model' entry); a bare state_dict goes to --weights")
        model.load_state_dict(payload["model"])
        print(f"loaded {path}")
    elif args.weights:
        sd = torch.load(args.weights, map_location=device, weights_only=True)
        model.load_state_dict(sd)
        print(f"loaded {args.weights}")
    elif args.init_seed is not None:
        init_weights(model, args.init_seed)
        print(f"random weights from --init_seed {args.init_seed}")
    else:
        raise SystemExit("give --load_path <run dir>, --weights <state_dict.pt> or "
                         "--init_seed N")
    return model.eval()


def make_base_fn(args, model: torch.nn.Module):
    """Change-probability forward: (B, t, t, 3) x2 NHWC -> (B, t, t, 1) in
    [0, 1], float32 (scripts/predict.py:90-114)."""
    from stcd_tpu_torch.data.augment import eval_preprocess

    device = next(model.parameters()).device

    def base_fn(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
        xa = eval_preprocess(ta).permute(0, 3, 1, 2)
        xb = eval_preprocess(tb).permute(0, 3, 1, 2)
        amp = (torch.autocast(device.type, dtype=torch.bfloat16) if args.bf16
               else contextlib.nullcontext())
        with amp:
            preds = model(xa, xb)
        if isinstance(preds, (list, tuple)):  # multi-scale: final only; SegCD: change
            preds = preds[-1]
        preds = preds.float().permute(0, 2, 3, 1)
        if preds.shape[-1] > 1:
            # P(changed) = 1 - P(background)
            return torch.softmax(preds, dim=-1)[..., 1:].sum(-1, keepdim=True)
        return torch.sigmoid(preds)

    return base_fn


def quantize_base_fn(model: torch.nn.Module, base_fn, tiles_a: torch.Tensor,
                     tiles_b: torch.Tensor):
    """``base_fn`` with the convs in int8 (``serving/quant.py``), the scales
    calibrated on one batch of tiles on the model's device; prints the count
    of quantized sites."""
    from stcd_tpu_torch.serving.quant import (calibrate_conv_scales, n_quantized_sites,
                                              quantize_fn)
    with torch.inference_mode():
        scales = calibrate_conv_scales(model, base_fn, [(tiles_a, tiles_b)])
    print(f"int8: {n_quantized_sites(scales)}/{scales.shape[0]} conv sites quantized",
          flush=True)
    return quantize_fn(model, base_fn, scales), scales


def make_replicas(args, model: torch.nn.Module, devices, calib=None) -> list:
    """One predict function for each of ``devices``: ``make_base_fn`` over the
    eval model with its weights, copied to that device (the first device
    keeps ``model`` itself where it lies there). Under ``args.int8`` the
    scales are calibrated once, on ``model`` and the tiles ``calib`` (a pair
    of NHWC tensors on its device), and every replica takes the same table, as
    JAX applies one table to its whole sharded step."""
    home = next(model.parameters()).device
    replicas = [model if i == 0 and indexed_device(dev) == home
                else copy.deepcopy(model).to(dev) for i, dev in enumerate(devices)]
    fns = [make_base_fn(args, replica) for replica in replicas]
    if args.int8:
        from stcd_tpu_torch.serving.quant import quantize_fn
        _, scales = quantize_base_fn(model, make_base_fn(args, model), *calib)
        fns = [quantize_fn(replica, fn, scales) for replica, fn in zip(replicas, fns)]
    return fns


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model and weight flags shared by predict, serve and export_model."""
    p.add_argument("--encoder", default="resnet50")
    p.add_argument("--decoder_channels", default="256,128,64,32,16")
    p.add_argument("--net_G", default=None,
                   help="bespoke-zoo model key (models.factory.define_G: "
                        + ", ".join(NET_G_KEYS) + "); overrides the SegCD default, "
                        "--encoder and --decoder_channels are then ignored; --tile is "
                        "its img_size (ChangeGNNV2* size pos_embed by it)")
    p.add_argument("--load_path", default=None,
                   help="run directory of the port's training (its *_best_model, "
                        "then best_ckpt, then last_ckpt) or one checkpoint file")
    p.add_argument("--weights", default=None,
                   help="bare state_dict .pt under the reference's names")
    p.add_argument("--init_seed", type=int, default=None,
                   help="seeded random weights instead of --weights")
    p.add_argument("--n_class", type=int, default=2, help="zoo head classes (with --net_G)")
    p.add_argument("--embed_dim", type=int, default=64,
                   help="zoo embed_dim (with --net_G; ChangeFormerV5, V6 and the ViG "
                        "decoders read it; "
                        "64 as in the JAX package and cli.train_cd, the published V6 "
                        "width is 256)")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--bf16", action="store_true",
                   help="run the model under torch.autocast(bfloat16)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization of the conv compute "
                        "(serving/quant.py); everything around the convs stays float")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")


def main(argv=None):
    from stcd_tpu_torch.data.io import read_image, save_mask_png
    from stcd_tpu_torch.data.tiled_inference import predict_scene

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_a", required=True)
    p.add_argument("--image_b", required=True)
    p.add_argument("--out", required=True, help="output change-mask PNG")
    p.add_argument("--prob_out", default=None, help="optional .npy of probs")
    p.add_argument("--stride", type=int, default=256)
    p.add_argument("--batch", type=int, default=None,
                   help="tiles per step over all the devices (default 4 x the device count)")
    p.add_argument("--no_shard", action="store_true",
                   help="run on one card even when several are visible")
    add_model_args(p)
    args = p.parse_args(argv)

    a = read_image(args.image_a)
    b = read_image(args.image_b)
    if a.shape != b.shape:
        raise SystemExit(f"scene shapes differ: {a.shape} vs {b.shape}")
    from stcd_tpu_torch.parallel.mesh import serving_devices
    devices = serving_devices(args.device, args.batch, args.no_shard)
    model = build_model(args)
    calib = None
    if args.int8:
        from stcd_tpu_torch.data.tiled_inference import tile_origins
        # only the calibration tiles, not the scene's whole tile stack
        t = args.tile
        cal = tile_origins(a.shape[0], a.shape[1], t, args.stride)[:8]
        home = next(model.parameters()).device
        calib = [torch.from_numpy(np.stack([im[y:y + t, x:x + t] for y, x in cal])).to(home)
                 for im in (a, b)]
    fns = make_replicas(args, model, devices, calib)
    probs = predict_scene(fns, a, b, tile=args.tile, stride=args.stride,
                          batch=args.batch, devices=devices)
    mask = (probs[..., 0] > args.threshold).astype(np.uint8)
    save_mask_png(mask, args.out)
    if args.prob_out:
        np.save(args.prob_out, probs)
    print(f"wrote {args.out} ({mask.shape[1]}x{mask.shape[0]}, "
          f"{float(mask.mean()):.2%} changed)")


if __name__ == "__main__":
    main()
