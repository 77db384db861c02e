"""The FFC-pair fine-tune, the reference's alternate ``train_ffctl`` loop
(counterpart of scripts/train_ffctl.py).

A plain CD loop over FFCDataset pairs, images from A/ and B/ labelled by the
generated ``ff_label/`` maps, loss = BCE + Dice on sigmoid(change logit)
only, per-iteration Poly LR, an eval on real CD pairs each epoch, the best
checkpoint by change IoU. The model is FFCTLCD (feature-level differences at
every encoder level) unless ``--net segcd``; both return (seg_A, seg_B,
change) and the loop uses only the change.

Usage:
  python -m stcd_tpu_torch.cli.train_ffctl --root_path data --dataset_name LEVIR \\
      --CDdataset_name LEVIR --save_name runs/ffctl [--net ffctlcd|segcd] [--device cpu]
"""

from __future__ import annotations

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       load_model, make_loaders, make_mesh, parse_args,
                                       pick_steps, place_state, print_primary,
                                       resume_and_guard, train_generator)


def main(argv=None) -> dict:
    from stcd_tpu_torch.data.datasets import CDDataset, FFCDataset
    from stcd_tpu_torch.models.segcd import FFCTLCD, SegCD
    from stcd_tpu_torch.train.loops import run_training
    from stcd_tpu_torch.train.steps import make_cd_steps

    p = base_parser("LEVIR", "runs/LEVIR-FFCTL")
    p.add_argument("--net", choices=["ffctlcd", "segcd"], default="ffctlcd")
    args = parse_args(p, argv)
    mesh = make_mesh(args)
    configure_host_transfer(args)
    print_primary(args)
    train_loader, val_loader = make_loaders(
        args, FFCDataset(args.root_path, args.dataset_name, "train"),
        CDDataset(args.root_path, args.CDdataset_name, "val"))
    state = build_state(args, {"ffctlcd": FFCTLCD, "segcd": SegCD}[args.net],
                        len(train_loader))
    train_step, eval_step = pick_steps(mesh, lambda: make_cd_steps(
        augment=True, remat=args.remat, accum_steps=args.accum_steps,
        space=mesh.space), args)
    if args.load_model:  # warm start from the stage-2 checkpoint
        load_model(args, state)
    state, run_kwargs = resume_and_guard(args, state)
    state = place_state(mesh, state)
    state, best, history = run_training(
        train_step, eval_step, state, train_loader, val_loader,
        n_epochs=args.n_epochs, save_dir=args.save_name, rng=train_generator(args),
        **run_kwargs)
    print_primary(f"best cd IoU: {best:.4f}")
    return {"state": state, "best": best, "history": history}


if __name__ == "__main__":
    main()
