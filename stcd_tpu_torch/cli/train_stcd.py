"""Stage 3: the STCD fine-tune (counterpart of scripts/train_stcd.py).

LEVIRDataset yields joint seg + change samples: synthesized pseudo-change
pairs from the WHU-AB tree and real pairs with ``pseudo_label_WHU/``; both
halves go through one SegCD forward, loss = seg loss of A + change loss +
contrastive loss. The gated passes are stage 2's: ``--select_data``, and
``--generate_label`` at threshold 0.5 into ``pseudo_label/``, with
``--vis_feature`` saving the jet-coloured probability maps too (into
``--vis_dir``, default ``<CDdataset>/train/val_pred_temp``).

Usage:
  python -m stcd_tpu_torch.cli.train_stcd --root_path data --dataset_name LEVIR \\
      --CDdataset_name LEVIR --save_name runs/stcd --load_model --load_path runs/psecd \\
      [--device cpu]
"""

from __future__ import annotations

import os

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       generate_label, load_model, make_loaders, make_mesh,
                                       parse_args, pick_steps, place_state, print_primary,
                                       resume_and_guard, select_data, train_generator)


def main(argv=None) -> dict:
    from stcd_tpu_torch.data.datasets import CDDataset, LEVIRDataset
    from stcd_tpu_torch.models.segcd import SegCD
    from stcd_tpu_torch.train.loops import run_training
    from stcd_tpu_torch.train.steps import make_semi_cd_steps

    args = parse_args(base_parser("LEVIR", "runs/STCD"), argv)
    mesh = make_mesh(args)
    configure_host_transfer(args)
    print_primary(args)
    train_loader, val_loader = make_loaders(
        args, LEVIRDataset(args.root_path, args.dataset_name, "train"),
        CDDataset(args.root_path, args.CDdataset_name, "val"))
    state = build_state(args, SegCD, len(train_loader))
    train_step, eval_step = pick_steps(mesh, lambda: make_semi_cd_steps(
        augment=True, remat=args.remat, accum_steps=args.accum_steps,
        space=mesh.space), args)
    if args.load_model:
        load_model(args, state, " (WHU-pseudo-change equivalent)")
    if args.select_data:
        ranked = select_data(args, state, eval_step,
                             lambda: build_state(args, SegCD, len(train_loader)))
        return {"state": state, "reliability": ranked}
    if args.generate_label:
        # the reference passes reliable='lunreliable' here, a disabled toggle that
        # falls through to the full train list
        vis_dir = None
        if args.vis_feature:
            vis_dir = args.vis_dir or os.path.join(
                args.root_path, args.CDdataset_name, "train", "val_pred_temp")
        return {"state": state, "metrics": generate_label(
            args, state, eval_step, "pseudo_label", 0.5, vis_dir=vis_dir)}

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
