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
  python -m stcd_tpu_torch.cli.train_cd --net_G SNUNet --checkpoint_dir runs/SNUNet
  python -m stcd_tpu_torch.cli.train_cd --net_G IFNet --n_class 1 --loss bce  # a 1-channel head

Under ``torchrun --nproc_per_node W`` the W ranks train one model on a
``data`` x ``model`` x ``stage`` grid (``CDTrainer``): ``--tp_axis T`` splits
the attention, MLP and wide-conv parameters over T ranks
(``parallel/tensor.py``), ``--pp_stages S`` pipelines the
BIT ``_dd8`` decoder, the ChangeFormer V4-V6 MiT encoder (S = its stage
count: 5 for V4, else 4) or the ChangeVIG-family encoder (S = 4) over S
ranks with ``--pp_microbatches`` microbatches a step (0: S), and D = W / (T S)
data shards each load ``--batch_size / D`` rows of the global batch. One card
a rank under NCCL; ``--device cuda:0`` puts every rank on one card under
gloo; ``--device cpu`` runs gloo on the host:

  torchrun --nproc_per_node 4 -m stcd_tpu_torch.cli.train_cd --net_G ChangeFormerV6 \\
      --pp_stages 4 --dataset_name synthetic --checkpoint_dir runs/V6pp
  torchrun --nproc_per_node 4 -m stcd_tpu_torch.cli.train_cd --pp_stages 2  # BIT, data 2
  torchrun --nproc_per_node 4 -m stcd_tpu_torch.cli.train_cd --tp_axis 2 --pp_stages 2
"""

from __future__ import annotations

import argparse
import os

import torch

from stcd_tpu_torch.utils.device import resolve_device
from stcd_tpu_torch.models.factory import NET_G_KEYS
from stcd_tpu_torch.parallel import distributed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--net_G", default="base_transformer_pos_s4_dd8",
                   help="define_G key (models.factory.define_G): " + ", ".join(NET_G_KEYS))
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
                   help="pipeline stages over the launch's ranks (torchrun); 1: none")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="pipeline microbatches a step (0: --pp_stages)")
    p.add_argument("--tp_axis", type=int, default=1,
                   help="tensor-parallel size: ranks of the launch (torchrun) that split "
                        "the attention, MLP and wide-conv parameters; 1: none")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training; CDEvaluator on --eval_ckpt")
    p.add_argument("--eval_ckpt", default="best_ckpt", choices=("best_ckpt", "last_ckpt"))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    return p


def make_loaders(args, n_data: int = 1) -> dict:
    """The train and val loaders of this rank: ``--batch_size / n_data`` rows of
    each global batch (the default process split of ``data.loader``)."""
    from stcd_tpu_torch.data.datasets import CDDataset, SyntheticCDDataset
    from stcd_tpu_torch.data.loader import DataLoader

    if args.dataset_name == "synthetic":
        train_ds = SyntheticCDDataset(length=args.synthetic_length, size=args.img_size)
        val_ds = SyntheticCDDataset(length=max(args.synthetic_length // 2, 2),
                                    size=args.img_size, seed=1)
    else:
        train_ds = CDDataset(args.root_path, args.dataset_name, "train")
        val_ds = CDDataset(args.root_path, args.dataset_name, "val")
    local = args.batch_size // n_data
    train = DataLoader(train_ds, local, shuffle=True, num_workers=args.n_cpu,
                       seed=args.seed, drop_last=True, device=args.device)
    val = DataLoader(val_ds, local, num_workers=args.n_cpu, device=args.device)
    return {"train": train, "val": val}


def main(argv=None) -> dict:
    from stcd_tpu_torch.train.trainer import CDEvaluator, CDTrainer, TrainerConfig

    from stcd_tpu_torch.parallel.mesh import create_mesh

    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    args.device = str(distributed.initialize(args.device))
    mesh = create_mesh(model=args.tp_axis, stage=args.pp_stages)
    if args.batch_size % mesh.data:
        raise ValueError(f"--batch_size {args.batch_size} is the global batch: the "
                         f"{mesh.data} data shards must divide it")
    distributed.print_primary(args)
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
        pp_stages=args.pp_stages, pp_microbatches=args.pp_microbatches,
        tp_axis=args.tp_axis, device=args.device)
    loaders = make_loaders(args, mesh.data)

    trainer = state = None
    if not args.eval_only:
        trainer = CDTrainer(cfg, loaders)
        state = trainer.train_models()
        distributed.print_primary(f"training done; best val mF1 {trainer.best_val_acc:.4f} "
                                  f"@ epoch {trainer.best_epoch_id}")

    scores = CDEvaluator(cfg, loaders["val"]).eval_models(args.eval_ckpt)
    distributed.print_primary("val scores: " + " ".join(f"{k}={v:.4f}"
                                                         for k, v in sorted(scores.items())))
    return {"trainer": trainer, "state": state, "scores": scores}


if __name__ == "__main__":
    main()
