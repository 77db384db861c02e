"""Whole-scene change-map inference from two raster images of any size
(counterpart of scripts/predict.py).

Usage:
  python -m stcd_tpu_torch.cli.predict --image_a t1.png --image_b t2.png \\
      --out change.png (--weights segcd.pt | --init_seed 0) \\
      [--encoder resnet50 --decoder_channels 256,128,64,32,16] \\
      [--net_G ChangeFormerV6] \\
      [--tile 256 --stride 128 --threshold 0.5 --prob_out probs.npy --bf16]

The model is SegCD with ``--encoder`` and ``--decoder_channels`` unless
``--net_G`` names a bespoke-zoo model, as in scripts/predict.py.
``--weights`` is a state_dict saved with ``torch.save`` under the original
reference's names; ``--init_seed N`` builds seeded random weights instead.
The change probability is the sigmoid of a 1-channel change logit (SegCD's
third output), or for a multi-class head the final scale's P(changed) = sum
of the softmax classes 1..C-1.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` without a card raises: the port never carries on silently on
    the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


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
        from stcd_tpu_torch.models.changeformer import init_weights
        from stcd_tpu_torch.models.factory import define_G
        model = define_G(args.net_G, n_class=args.n_class, embed_dim=args.embed_dim,
                         device=device)
    else:
        from stcd_tpu_torch.models.segcd import SegCD, init_weights
        dec = tuple(int(c) for c in args.decoder_channels.split(","))
        model = SegCD(encoder_name=args.encoder, classes=1, decoder_channels=dec,
                      device=device)
    if args.weights:
        sd = torch.load(args.weights, map_location=device, weights_only=True)
        model.load_state_dict(sd)
        print(f"loaded {args.weights}")
    elif args.init_seed is not None:
        init_weights(model, args.init_seed)
        print(f"random weights from --init_seed {args.init_seed}")
    else:
        raise SystemExit("give --weights <state_dict.pt> or --init_seed N")
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


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model and weight flags shared by predict and serve."""
    p.add_argument("--encoder", default="resnet50")
    p.add_argument("--decoder_channels", default="256,128,64,32,16")
    p.add_argument("--net_G", default=None,
                   help="bespoke-zoo model key (models.factory.define_G; only "
                        "ChangeFormerV6 is ported); overrides the SegCD default, "
                        "--encoder and --decoder_channels are then ignored")
    p.add_argument("--weights", default=None,
                   help="state_dict .pt under the reference's names")
    p.add_argument("--init_seed", type=int, default=None,
                   help="seeded random weights instead of --weights")
    p.add_argument("--n_class", type=int, default=2, help="zoo head classes (with --net_G)")
    p.add_argument("--embed_dim", type=int, default=256,
                   help="decoder width (the published V6 width is 256)")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--bf16", action="store_true",
                   help="run the model under torch.autocast(bfloat16)")
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
    p.add_argument("--batch", type=int, default=4, help="tiles per device step")
    add_model_args(p)
    args = p.parse_args(argv)

    a = read_image(args.image_a)
    b = read_image(args.image_b)
    if a.shape != b.shape:
        raise SystemExit(f"scene shapes differ: {a.shape} vs {b.shape}")
    model = build_model(args)
    probs = predict_scene(make_base_fn(args, model), a, b, tile=args.tile,
                          stride=args.stride, batch=args.batch,
                          device=resolve_device(args.device))
    mask = (probs[..., 0] > args.threshold).astype(np.uint8)
    save_mask_png(mask, args.out)
    if args.prob_out:
        np.save(args.prob_out, probs)
    print(f"wrote {args.out} ({mask.shape[1]}x{mask.shape[0]}, "
          f"{float(mask.mean()):.2%} changed)")


if __name__ == "__main__":
    main()
