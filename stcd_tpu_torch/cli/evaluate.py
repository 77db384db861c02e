"""Evaluate a run's best weights on a CD dataset: F1, IoU, OA, precision,
recall and mIoU, with an optional dump of the predictions (counterpart of
scripts/evaluate.py).

Usage:
  python -m stcd_tpu_torch.cli.evaluate --root_path data --dataset_name LEVIR \\
      --split val --load_path runs/STCD [--save_preds out_dir] [--device cpu]

The model is SegCD with ``--encoder`` and ``--decoder_channels``; its weights
are the ``*_best_model`` under ``--load_path``. int8 evaluation (``--int8``)
is not ported (ROADMAP.md Queue 1 #7).
"""

from __future__ import annotations

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       parse_args)


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
                   help="int8 post-training quantization: not ported (ROADMAP.md Queue 1 #7)")
    args = parse_args(p, argv)
    if args.int8:
        raise NotImplementedError("--int8: int8 evaluation is not ported "
                                  "(ROADMAP.md Queue 1 #7)")
    configure_host_transfer(args)

    state = build_state(args, SegCD, tx=SGDConfig(lambda step: 0.0, 0.0, 0.0))
    mgr = CheckpointManager(args.load_path)
    best = mgr.best_path()
    if best is None:
        raise SystemExit(f"no *_best_model checkpoint under {args.load_path}")
    mgr.load_weights(state, best)
    print(f"loaded {best}")

    loader = DataLoader(CDDataset(args.root_path, args.dataset_name, args.split),
                        args.batch_size, num_workers=args.n_cpu, drop_last=False,
                        device=args.device)
    _, eval_step = make_cd_steps(augment=False)
    if args.save_preds:
        metrics = generate_pseudo_labels(eval_step, state, loader, args.save_preds,
                                         args.threshold)
    else:
        metrics = evaluate(eval_step, state, loader)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
