"""Stage 2: pseudo-change CD pretraining (counterpart of
scripts/train_pse_cd.py).

SegCD on PSEDataset pairs labelled by ``pseudo_label_WHU/``, BCE + Dice on
sigmoid(change logit), validated on CDDataset pairs. Two gated passes
instead of training: ``--select_data`` ranks the train pairs by the
agreement of three epoch snapshots with the current weights into
``list/reliable_ids.txt`` and ``unreliable_ids.txt``; ``--generate_label``
writes the change maps at threshold 0.7 into ``ff_label/``.

Usage:
  python -m stcd_tpu_torch.cli.train_pse_cd --root_path data --dataset_name LEVIR \\
      --CDdataset_name LEVIR --save_name runs/psecd \\
      [--load_model --load_path runs/psecd (--select_data | --generate_label)] \\
      [--device cpu]
"""

from __future__ import annotations

from stcd_tpu_torch.cli.common import (base_parser, build_state, configure_host_transfer,
                                       generate_label, load_model, make_loaders, make_mesh,
                                       parse_args, pick_steps, place_state, print_primary,
                                       resume_and_guard, select_data, train_generator)


def main(argv=None) -> dict:
    from stcd_tpu_torch.data.datasets import CDDataset, PSEDataset
    from stcd_tpu_torch.models.segcd import SegCD
    from stcd_tpu_torch.train.loops import run_training
    from stcd_tpu_torch.train.steps import make_cd_steps

    args = parse_args(base_parser("LEVIR", "runs/LEVIR-PseCD"), argv)
    mesh = make_mesh(args)
    configure_host_transfer(args)
    print_primary(args)
    train_loader, val_loader = make_loaders(
        args, PSEDataset(args.root_path, args.dataset_name, "train"),
        CDDataset(args.root_path, args.CDdataset_name, "val"))
    state = build_state(args, SegCD, len(train_loader))
    train_step, eval_step = pick_steps(mesh, lambda: make_cd_steps(
        augment=True, remat=args.remat, accum_steps=args.accum_steps,
        space=mesh.space), args)
    if args.load_model:
        load_model(args, state)
    if args.select_data:
        ranked = select_data(args, state, eval_step,
                             lambda: build_state(args, SegCD, len(train_loader)))
        return {"state": state, "reliability": ranked}
    if args.generate_label:
        return {"state": state,
                "metrics": generate_label(args, state, eval_step, "ff_label", 0.7)}

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
