"""Stage 1: supervised building-segmentation pretraining (counterpart of
scripts/train_sup.py).

UnetSeg on ``{dataset}/A`` + ``A_label`` (WHUDataset) with BCE + Dice on the
sigmoid output, Adam(1e-3) with a per-iteration Poly(0.9), an eval with the
confusion-matrix metrics each epoch, the best checkpoint by class-1 IoU,
snapshots at n/3, 2n/3 and n. The photometric augmentation runs on the
device inside the step (the CUDA kernel on a card).

Usage:
  python -m stcd_tpu_torch.cli.train_sup --root_path data --dataset_name WHU-AB \\
      --save_name runs/seg [--encoder resnet50 --batch_size 4 --n_epochs 60 --bf16] \\
      [--device cpu]
"""

from __future__ import annotations

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       load_model, make_loaders, parse_args,
                                       resume_and_guard, train_generator)


def main(argv=None) -> dict:
    from stcd_tpu_torch.data.datasets import WHUDataset
    from stcd_tpu_torch.models.segcd import UnetSeg
    from stcd_tpu_torch.train.loops import run_training
    from stcd_tpu_torch.train.steps import make_seg_steps

    args = parse_args(base_parser("WHU-AB", "runs/WHU-Seg"), argv)
    configure_host_transfer(args)
    print(args)
    train_loader, val_loader = make_loaders(
        args, WHUDataset(args.root_path, args.dataset_name, "train"),
        WHUDataset(args.root_path, args.dataset_name, "val"))
    state = build_state(args, UnetSeg, len(train_loader))
    if args.load_model:
        load_model(args, state)
    train_step, eval_step = make_seg_steps(augment=True, remat=args.remat,
                                           accum_steps=args.accum_steps)
    state, run_kwargs = resume_and_guard(args, state)
    state, best, history = run_training(
        train_step, eval_step, state, train_loader, val_loader,
        n_epochs=args.n_epochs, save_dir=args.save_name, rng=train_generator(args),
        **run_kwargs)
    print(f"best IoU: {best:.4f}")
    return {"state": state, "best": best, "history": history}


if __name__ == "__main__":
    main()
