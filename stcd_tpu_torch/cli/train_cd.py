"""The define_G zoo's training CLI (counterpart of scripts/train_cd.py): args
-> TrainerConfig -> CDTrainer.train_models -> CDEvaluator's scores and masks on
the val split.

Data layout: {root}/{dataset}/{train,val}/{A,B,label,list/{split}.txt}
(``data.datasets.CDDataset``); ``--dataset_name synthetic`` runs on the
in-memory ``SyntheticCDDataset`` instead. Training resumes from
{checkpoint_dir}/last_ckpt when one exists (``CDTrainer.train_models``).

Usage:
  python -m stcd_tpu_torch.cli.train_cd --net_G ChangeFormerV6 --root_path data \\
      --dataset_name LEVIR-CD --max_epochs 100 --loss ce --optimizer sgd \\
      --checkpoint_dir runs/V6 [--augment] [--bf16] [--device cpu]
  python -m stcd_tpu_torch.cli.train_cd --net_G ChangeFormerV6 --checkpoint_dir runs/V6 \\
      --eval_only [--eval_ckpt last_ckpt] [--vis_dir runs/V6/vis]

``--pp_stages``, ``--pp_microbatches`` and ``--tp_axis`` other than 1 (0) raise:
the port runs on one card (ROADMAP.md Queue 1 #11).
"""

from __future__ import annotations

import argparse
import os

import torch

from stcd_tpu_torch.cli.predict import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--net_G", default="base_transformer_pos_s4_dd8",
                   help="define_G key (models.factory.define_G)")
    p.add_argument("--n_class", type=int, default=2)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--optimizer", default="sgd", choices=("sgd", "adam", "adamw"))
    p.add_argument("--lr_policy", default="linear", choices=("linear", "step", "exponential"))
    p.add_argument("--lr_decay_iters", type=int, default=50)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--loss", default="ce",
                   choices=("ce", "bce", "cd_loss", "fl", "miou", "mmiou"))
    p.add_argument("--multi_scale_train", action="store_true")
    p.add_argument("--multi_scale_infer", action="store_true")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--vis_dir", default=None,
                   help="prediction dump dir (default {checkpoint_dir}/vis)")
    p.add_argument("--root_path", default="data/")
    p.add_argument("--dataset_name", default="LEVIR-CD",
                   help="'synthetic' runs an in-memory smoke dataset")
    p.add_argument("--synthetic_length", type=int, default=8)
    p.add_argument("--n_cpu", type=int, default=4, help="host decode threads")
    p.add_argument("--augment", action="store_true",
                   help="on-device photometric train augmentation (ColorJitter, "
                        "grayscale, blur; the CUDA kernel on a card)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 autocast (parameters and BatchNorm statistics stay fp32)")
    p.add_argument("--pp_stages", type=int, default=1,
                   help="pipeline stages; the port runs on one card (1)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="pipeline microbatches; the port runs on one card (0)")
    p.add_argument("--tp_axis", type=int, default=1,
                   help="tensor-parallel size; the port runs on one card (1)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training; CDEvaluator on --eval_ckpt")
    p.add_argument("--eval_ckpt", default="best_ckpt", choices=("best_ckpt", "last_ckpt"))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    return p


def make_loaders(args) -> dict:
    from stcd_tpu_torch.data.datasets import CDDataset, SyntheticCDDataset
    from stcd_tpu_torch.data.loader import DataLoader

    if args.dataset_name == "synthetic":
        train_ds = SyntheticCDDataset(length=args.synthetic_length, size=args.img_size)
        val_ds = SyntheticCDDataset(length=max(args.synthetic_length // 2, 2),
                                    size=args.img_size, seed=1)
    else:
        train_ds = CDDataset(args.root_path, args.dataset_name, "train")
        val_ds = CDDataset(args.root_path, args.dataset_name, "val")
    train = DataLoader(train_ds, args.batch_size, shuffle=True, num_workers=args.n_cpu,
                       seed=args.seed, drop_last=True, device=args.device)
    val = DataLoader(val_ds, args.batch_size, num_workers=args.n_cpu, device=args.device)
    return {"train": train, "val": val}


def main(argv=None) -> dict:
    from stcd_tpu_torch.train.trainer import CDEvaluator, CDTrainer, TrainerConfig

    args = build_parser().parse_args(argv)
    if args.pp_stages != 1 or args.pp_microbatches != 0 or args.tp_axis != 1:
        raise NotImplementedError(
            f"--pp_stages {args.pp_stages} --pp_microbatches {args.pp_microbatches} "
            f"--tp_axis {args.tp_axis}: pipeline and tensor parallelism are not ported "
            "(ROADMAP.md Queue 1 #11)")
    resolve_device(args.device)
    print(args)
    cfg = TrainerConfig(
        net_G=args.net_G, n_class=args.n_class, embed_dim=args.embed_dim,
        img_size=args.img_size, lr=args.lr, optimizer=args.optimizer,
        lr_policy=args.lr_policy, lr_decay_iters=args.lr_decay_iters,
        max_epochs=args.max_epochs, loss=args.loss,
        multi_scale_train=args.multi_scale_train,
        multi_scale_infer=args.multi_scale_infer, batch_size=args.batch_size,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        vis_dir=args.vis_dir or os.path.join(args.checkpoint_dir, "vis"),
        dtype=torch.bfloat16 if args.bf16 else None, augment=args.augment,
        device=args.device)
    loaders = make_loaders(args)

    trainer = state = None
    if not args.eval_only:
        trainer = CDTrainer(cfg, loaders)
        state = trainer.train_models()
        print(f"training done; best val mF1 {trainer.best_val_acc:.4f} "
              f"@ epoch {trainer.best_epoch_id}")

    scores = CDEvaluator(cfg, loaders["val"]).eval_models(args.eval_ckpt)
    print("val scores: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(scores.items())))
    return {"trainer": trainer, "state": state, "scores": scores}


if __name__ == "__main__":
    main()
