"""Shared plumbing of the stage CLIs (counterpart of scripts/common.py).

The flag surface is the JAX scripts' (the reference's argparse, its
hard-coded booleans ``load_model`` / ``select_data`` / ``generate_label`` as
flags), plus ``--device``. One card: ``--data_axis``, ``--space_axis`` and
``--model_axis`` other than 1 raise (data parallel is ROADMAP.md Queue 1 #10;
spatial and tensor parallel #11), and so ``make_mesh``, ``pick_steps`` and
``place_state`` have no counterpart yet.

The helpers below the JAX ones build what every stage CLI builds the same way:
the seeded model and train state, the loaders, the augmentation generator,
``--load_model``, and the two gated passes of stages 2 and 3.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from stcd_tpu_torch.cli.predict import resolve_device


def base_parser(dataset_default: str, save_default: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--epoch", type=int, default=0, help="epoch to start training from")
    p.add_argument("--n_epochs", type=int, default=60, help="number of epochs of training")
    p.add_argument("--root_path", type=str, default="data/", help="root path")
    p.add_argument("--dataset_name", type=str, default=dataset_default)
    p.add_argument("--CDdataset_name", type=str, default=dataset_default)
    p.add_argument("--save_name", type=str, default=save_default, help="experiments name")
    p.add_argument("--batch_size", type=int, default=4, help="size of the batches")
    p.add_argument("--n_cpu", type=int, default=4, help="host decode threads")
    p.add_argument("--img_height", type=int, default=256,
                   help="accepted for the JAX surface; the models take any size "
                        "divisible by 32")
    p.add_argument("--img_width", type=int, default=256, help="as --img_height")
    p.add_argument("--load_path", type=str, default="resume/", help="load path")
    # the reference's hard-coded booleans, as flags
    p.add_argument("--load_model", action="store_true",
                   help="start from the best weights under --load_path")
    p.add_argument("--select_data", action="store_true",
                   help="reliability ranking -> list files")
    p.add_argument("--generate_label", action="store_true", help="write pseudo labels")
    p.add_argument("--vis_feature", action="store_true",
                   help="jet-coloured probability maps during --generate_label")
    p.add_argument("--vis_dir", type=str, default=None,
                   help="output dir for --vis_feature (default: <dataset>/train/val_pred_temp)")
    # the reference's hard-coded hyperparameters (its defaults)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=1337,
                   help="seeds the weights and the augmentation generator")
    p.add_argument("--encoder", type=str, default="resnet50")
    p.add_argument("--encoder_weights", type=str, default=None,
                   help="a torch state_dict of the encoder under torchvision's names: "
                        "its path, or 'imagenet' to resolve {encoder}.pth under "
                        "$STCD_PRETRAINED_DIR (missing weights raise; nothing is "
                        "downloaded)")
    p.add_argument("--decoder_channels", type=str, default="256,128,64,32,16",
                   help="comma-separated unet decoder widths")
    p.add_argument("--float_transfer", action="store_true",
                   help="send float32 images to the device instead of the default "
                        "uint8 (uint8 moves 4x fewer bytes; the 1/255 scale and the "
                        "normalisation run on the device)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 autocast")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward (bigger batches)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step (batch_size must "
                        "divide)")
    p.add_argument("--resume", action="store_true",
                   help="full resume (weights, optimizer, epoch, best) from "
                        "<save_name>/last_ckpt, which every epoch and a SIGTERM write; "
                        "unlike --load_model (weights only) this continues the "
                        "interrupted run exactly")
    p.add_argument("--no_preempt", action="store_true",
                   help="do not install the SIGTERM handler that saves a full resume "
                        "point before exiting")
    p.add_argument("--data_axis", type=int, default=None,
                   help="data-parallel size; the port runs on one card (1)")
    p.add_argument("--space_axis", type=int, default=1,
                   help="spatial-partitioning size; the port runs on one card (1)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel size; the port runs on one card (1)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, and refuse what the port does not run: a mesh of more than one
    device, or a card that is not there."""
    args = parser.parse_args(argv)
    if args.data_axis not in (None, 1):
        raise NotImplementedError(
            f"--data_axis {args.data_axis}: data parallel is not ported "
            "(ROADMAP.md Queue 1 #10)")
    for flag in ("space_axis", "model_axis"):
        if getattr(args, flag) != 1:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: spatial and tensor parallel are not "
                "ported (ROADMAP.md Queue 1 #11)")
    resolve_device(args.device)
    return args


def resume_and_guard(args, state):
    """Optionally restore the full ``last_ckpt`` resume point (``--resume``)
    and install the SIGTERM guard (default on; ``--no_preempt`` opts out).
    Returns ``(state, kwargs)``, the kwargs for ``run_training``."""
    kwargs = {}
    if getattr(args, "resume", False):
        from stcd_tpu_torch.train.checkpoint import CheckpointManager
        restored = CheckpointManager(args.save_name).restore_last(state)
        if restored is None:
            print(f"--resume: no last_ckpt under {args.save_name}; starting fresh")
        else:
            state, epoch_id, best, best_epoch = restored
            kwargs.update(start_epoch=epoch_id + 1, best=best, best_epoch=best_epoch)
            print(f"resumed full state from {args.save_name}/last_ckpt "
                  f"(epoch {epoch_id}, best {best:.4f} @ {best_epoch})")
    if not getattr(args, "no_preempt", False):
        from stcd_tpu_torch.train.preemption import PreemptionGuard
        kwargs["preemption"] = PreemptionGuard()
    return state, kwargs


def configure_host_transfer(args) -> None:
    """uint8 images and labels to the device by default; ``--float_transfer``
    sends float32."""
    from stcd_tpu_torch.data.io import set_uint8_transfer
    set_uint8_transfer(not getattr(args, "float_transfer", False))


def decoder_channels(args) -> tuple:
    return tuple(int(c) for c in args.decoder_channels.split(","))


def build_state(args, model_cls, iters_per_epoch: int = 1, tx=None):
    """``model_cls(args.encoder, decoder_channels)`` with seeded random weights
    (seed ``--seed``), wrapped into a train state on ``--device`` with Adam
    and the reference's Poly schedule over ``--n_epochs`` x
    ``iters_per_epoch`` (or ``tx``)."""
    from stcd_tpu_torch.models.segcd import init_weights
    from stcd_tpu_torch.train.state import adam_poly, create_train_state

    model = init_weights(model_cls(args.encoder, classes=1,
                                   decoder_channels=decoder_channels(args)), seed=args.seed)
    if tx is None:
        tx = adam_poly(args.lr, args.n_epochs, max(iters_per_epoch, 1))
    return create_train_state(model, tx, device=args.device, bf16=args.bf16,
                              encoder_weights=args.encoder_weights)


def make_loaders(args, train_ds, val_ds):
    """The stage's train loader (shuffled by ``--seed``, whole batches) and
    its val loader (twice the batch)."""
    from stcd_tpu_torch.data.loader import DataLoader

    train = DataLoader(train_ds, args.batch_size, shuffle=True, num_workers=args.n_cpu,
                       seed=args.seed, drop_last=True, device=args.device)
    val = DataLoader(val_ds, args.batch_size * 2, num_workers=args.n_cpu,
                     device=args.device)
    return train, val


def train_generator(args) -> torch.Generator:
    """The one generator on ``--device`` that the train steps draw their
    augmentation from, seeded by ``--seed``."""
    return torch.Generator(device=args.device).manual_seed(args.seed)


def load_model(args, state, note: str = "") -> None:
    """``--load_model``: the best weights under ``--load_path``, in place."""
    from stcd_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(args.load_path)
    best = mgr.best_path()
    if best:
        mgr.load_weights(state, best)
        print(f"resumed weights from {best}{note}")
    else:
        print("Will start from scratch")


def snapshot_paths(load_path: str) -> list:
    """The epoch snapshots the reliability ranking uses, in the JAX CLIs'
    order: ``sorted`` names, so lexicographic (``10.00_model`` comes before
    ``2.00_model``), without the ``*_best_model`` that ``*_model`` also
    matches, the first three."""
    return sorted(p for p in glob.glob(os.path.join(load_path, "*_model"))
                  if not p.endswith("_best_model"))[:3]


def select_data(args, state, eval_step, make_state):
    """``--select_data``: the reliability ranking of the ``--CDdataset_name``
    train pairs by the three epoch snapshots and the current weights. Each
    snapshot is loaded into a state of its own from ``make_state()``:
    ``CheckpointManager.load_weights`` loads in place, so loading them all into
    one state would give four aliases of one model."""
    from stcd_tpu_torch.data.datasets import CDDataset
    from stcd_tpu_torch.data.loader import DataLoader
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    from stcd_tpu_torch.train.loops import select_reliable

    mgr = CheckpointManager(args.load_path)
    states = []
    for path in snapshot_paths(args.load_path):
        snap = make_state()
        mgr.load_weights(snap, path)
        states.append(snap)
    states.append(state)
    loader = DataLoader(CDDataset(args.root_path, args.CDdataset_name, "train"), 1,
                        num_workers=args.n_cpu, device=args.device)
    return select_reliable([eval_step] * len(states), states, loader,
                           os.path.join(args.root_path, args.CDdataset_name, "train", "list"))


def generate_label(args, state, eval_step, out_name: str, threshold: float,
                   vis_dir=None):
    """``--generate_label``: thresholded change maps of the
    ``--CDdataset_name`` train pairs into ``train/{out_name}/``."""
    from stcd_tpu_torch.data.datasets import CDDataset
    from stcd_tpu_torch.data.loader import DataLoader
    from stcd_tpu_torch.train.loops import generate_pseudo_labels

    loader = DataLoader(CDDataset(args.root_path, args.CDdataset_name, "train"), 1,
                        num_workers=args.n_cpu, drop_last=False, device=args.device)
    metrics = generate_pseudo_labels(
        eval_step, state, loader,
        os.path.join(args.root_path, args.CDdataset_name, "train", out_name),
        threshold=threshold, vis_dir=vis_dir)
    print("pseudo-label metrics:", metrics)
    return metrics
