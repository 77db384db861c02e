"""Evaluate a run's best weights on a CD dataset: F1, IoU, OA, precision,
recall and mIoU, with an optional dump of the predictions (counterpart of
scripts/evaluate.py).

Usage:
  python -m stcd_tpu_torch.cli.evaluate --root_path data --dataset_name LEVIR \\
      --split val --load_path runs/STCD [--save_preds out_dir] [--device cpu]

The model is SegCD with ``--encoder`` and ``--decoder_channels``; its weights
are the ``*_best_model`` under ``--load_path``. ``--int8`` evaluates the
forward with its convs in int8 (``serving/quant.py``), calibrated on the first
batch of the split, as scripts/evaluate.py:57-80 does.
"""

from __future__ import annotations

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       parse_args, print_primary)


def main(argv=None) -> dict:
    from stcd_tpu_torch.data.datasets import CDDataset
    from stcd_tpu_torch.data.loader import DataLoader
    from stcd_tpu_torch.models.segcd import SegCD
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    from stcd_tpu_torch.train.loops import evaluate, generate_pseudo_labels
    from stcd_tpu_torch.train.state import SGDConfig
    from stcd_tpu_torch.train.steps import make_cd_steps

    p = base_parser("LEVIR", "runs/eval")
    p.add_argument("--split", default="val")
    p.add_argument("--save_preds", default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization of the conv compute "
                        "(serving/quant.py), calibrated on the first batch")
    args = parse_args(p, argv)
    configure_host_transfer(args)

    state = build_state(args, SegCD, tx=SGDConfig(lambda step: 0.0, 0.0, 0.0))
    mgr = CheckpointManager(args.load_path)
    best = mgr.best_path()
    if best is None:
        raise SystemExit(f"no *_best_model checkpoint under {args.load_path}")
    mgr.load_weights(state, best)
    print_primary(f"loaded {best}")

    # the whole split on every rank of a data-parallel launch (cli.pipeline_demo)
    loader = DataLoader(CDDataset(args.root_path, args.dataset_name, args.split),
                        args.batch_size, num_workers=args.n_cpu, drop_last=False,
                        device=args.device, process_index=0, process_count=1)
    _, eval_step = make_cd_steps(augment=False)
    if args.int8:
        eval_step = int8_eval_step(state, loader)
    if args.save_preds:
        metrics = generate_pseudo_labels(eval_step, state, loader, args.save_preds,
                                         args.threshold)
    else:
        metrics = evaluate(eval_step, state, loader)
    for k, v in metrics.items():
        print_primary(f"{k}: {v:.4f}")
    return metrics


def int8_eval_step(state, loader):
    """The eval step of ``make_cd_steps`` with the convs in int8: the
    sigmoid of SegCD's change logit through ``quantize_fn``, calibrated on the
    first batch of ``loader``; prints the count of quantized sites."""
    import torch

    from stcd_tpu_torch.cli.predict import quantize_base_fn
    from stcd_tpu_torch.data.augment import eval_preprocess
    from stcd_tpu_torch.metrics.confusion import confusion_matrix
    from stcd_tpu_torch.train.loops import _device_batch

    model = state.model.eval()

    def base_fn(a, b):
        with state.autocast():
            _, _, diff = model(eval_preprocess(a).permute(0, 3, 1, 2),
                               eval_preprocess(b).permute(0, 3, 1, 2))
        return torch.sigmoid(diff.float()).permute(0, 2, 3, 1)

    first, _ = _device_batch(next(iter(loader)), state.device)
    qfwd, _ = quantize_base_fn(model, base_fn, first["A"], first["B"])

    @torch.no_grad()
    def eval_step(_state, batch):
        probs = qfwd(batch["A"], batch["B"])  # (N, H, W, 1), as the labels
        return {"cm": confusion_matrix(probs > 0.5, batch["label"]), "probs": probs}

    return eval_step


if __name__ == "__main__":
    main()
