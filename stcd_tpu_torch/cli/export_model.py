"""Export a change-detection model as a ``torch.export`` program for serving
(counterpart of scripts/export_model.py, which writes a StableHLO artifact).

The program holds the eval forward with the weights baked in, and runs
without the model code: ``torch.export.load(path).module()(a, b)``. Its inputs
are NHWC float32 images in [0, 1], (batch, height, width, 3) each; the
ImageNet normalisation is in the program.

    python -m stcd_tpu_torch.cli.export_model --load_path runs/stcd \\
        --encoder resnet50 --batch_size 8 --out segcd.pt2

    # a define_G zoo model, the serving forward
    python -m stcd_tpu_torch.cli.export_model --load_path runs/V6 \\
        --net_G ChangeFormerV6 --out v6.pt2

    # the int8 serving forward (serving/quant.py), the calibration scales baked in
    python -m stcd_tpu_torch.cli.export_model --load_path runs/stcd --int8 \\
        --calib_npz calib.npz --out segcd_int8.pt2

Signatures: the default SegCD export returns (mask_a, mask_b, change_logits),
NHWC; ``--raw_inputs`` leaves the normalisation out of it. ``--net_G`` and/or
``--int8`` export the serving forward that ``cli.predict`` computes: (B, H, W,
1) probabilities of change. On a card the attention of the ChangeFormer and
BIT models is recorded as calls of the custom op
``torch.ops.stcd.cross_attention_fwd``: the loaded program launches the
hand-written kernel (import ``stcd_tpu_torch.ops.attention`` before loading,
which registers the op). The export raises if it recorded fewer such calls
than an eager forward launches. After writing the file the command loads it
back and runs one batch of zeros.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn


class _Forward(nn.Module):
    """``fn`` as a module that holds ``model``, so that the export lifts the
    model's parameters and buffers into the program."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, a, b):
        return self.fn(a, b)


def segcd_forward(model: nn.Module, normalize: bool = True):
    """SegCD's eval forward on NHWC [0, 1] images: (mask_a, mask_b,
    change_logits), NHWC."""
    from stcd_tpu_torch.data.augment import eval_preprocess

    def forward(a, b):
        if normalize:
            a, b = eval_preprocess(a), eval_preprocess(b)
        outs = model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    return forward


def _attention_calls(program) -> int:
    return sum(node.op == "call_function"
               and node.target == torch.ops.stcd.cross_attention_fwd.default
               for node in program.graph.nodes)


def export_forward(model: nn.Module, fn, height: int, width: int, batch: int):
    """``torch.export`` of ``fn`` on (batch, height, width, 3) float32 inputs on
    the model's device. On a card, the program must call the attention kernel
    as often as an eager forward launches it."""
    from stcd_tpu_torch.ops import attention

    device = next(model.parameters()).device
    # two tensors: one tensor given as both inputs would be traced as one input
    a, b = (torch.zeros((batch, height, width, 3), device=device) for _ in range(2))
    with torch.no_grad():
        before = attention.cross_attention_kernel.kernel_launches
        fn(a, b)
        launches = attention.cross_attention_kernel.kernel_launches - before
        program = torch.export.export(_Forward(model, fn), (a, b), strict=False)
    calls = _attention_calls(program)
    if calls < launches:
        raise RuntimeError(f"the exported program calls the attention kernel {calls} times, "
                           f"an eager forward launches it {launches} times")
    return program


def _calibration_batches(args):
    """--int8's calibration pairs: ``--calib_npz`` arrays 'A' and 'B' of shape
    (n, H, W, 3) in [0, 1]; without it a uniform random pair, with a warning."""
    h, w = args.img_height, args.img_width
    if args.calib_npz:
        data = np.load(args.calib_npz)
        a, b = np.asarray(data["A"], np.float32), np.asarray(data["B"], np.float32)
        if a.shape[1:] != (h, w, 3) or b.shape != a.shape:
            raise SystemExit(f"--calib_npz arrays must be (n, {h}, {w}, 3); got {a.shape} "
                             f"and {b.shape}")
        return a, b
    print("warning: --int8 without --calib_npz calibrates on random inputs; export real "
          "tiles for production scales", flush=True)
    rng = np.random.default_rng(0)
    shape = (max(2, args.batch_size), h, w, 3)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


def main(argv=None):
    from stcd_tpu_torch.cli import predict
    from stcd_tpu_torch.ops import attention  # noqa: F401  (registers the custom ops)

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--raw_inputs", action="store_true",
                   help="leave the ImageNet normalisation out (default SegCD export only)")
    p.add_argument("--calib_npz", default=None,
                   help="npz with 'A' and 'B', (n, H, W, 3) in [0, 1]: calibration tiles "
                        "for --int8")
    predict.add_model_args(p)  # --load_path --net_G --int8 --bf16 --device ...
    args = p.parse_args(argv)
    args.tile = args.img_height

    model = predict.build_model(args)
    device = next(model.parameters()).device
    if args.net_G or args.int8:
        fn = predict.make_base_fn(args, model)
        if args.int8:
            ca, cb = (torch.from_numpy(x).to(device) for x in _calibration_batches(args))
            fn, _ = predict.quantize_base_fn(model, fn, ca, cb)
    else:
        fn = segcd_forward(model, normalize=not args.raw_inputs)
    program = export_forward(model, fn, args.img_height, args.img_width, args.batch_size)
    torch.export.save(program, args.out)
    print(f"wrote {args.out} ({_attention_calls(program)} attention kernel calls)")

    # round trip: load it back and run one batch
    loaded = torch.export.load(args.out).module()
    z = torch.zeros((args.batch_size, args.img_height, args.img_width, 3), device=device)
    with torch.no_grad():
        outs = loaded(z, z)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    print("roundtrip outputs:", [tuple(o.shape) for o in outs])
    return {"program": program, "loaded": loaded, "fn": fn, "model": model, "args": args}


if __name__ == "__main__":
    main()
