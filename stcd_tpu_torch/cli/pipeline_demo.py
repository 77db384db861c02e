"""The three-stage STCD pipeline on a synthetic mini dataset, end to end
(counterpart of scripts/run_pipeline_demo.sh):

  the demo tree (make_demo_data) -> stage 1 segmentation pretraining (WHU-AB)
  -> stage 2 pseudo-change CD (LEVIR pairs) -> its reliability ranking
  (--select_data) -> its pseudo labels into ff_label/ (--generate_label)
  -> stage 3 STCD fine-tune from stage 2's best -> evaluation on LEVIR val.

Each step is a CLI's ``main(argv)`` in this process, with the flags the
shell script gives it. The run directories go under ``<root>/runs``.

Usage:
  python -m stcd_tpu_torch.cli.pipeline_demo <root> [--device cpu] \\
      [--n 8 --size 64 --encoder resnet18 --decoder_channels 32,24,16,12,8 \\
       --batch_size 4 --n_epochs 6 --bf16]
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> dict:
    """Runs the steps in order; returns ``{step: {"seconds", "result"}}``, the
    result being what the step's ``main`` returned."""
    from stcd_tpu_torch.cli import (evaluate, make_demo_data, train_pse_cd, train_stcd,
                                    train_sup)
    from stcd_tpu_torch.cli.predict import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--n", type=int, default=8, help="train tiles a dataset")
    p.add_argument("--size", type=int, default=64, help="tile side")
    p.add_argument("--encoder", default="resnet18")
    p.add_argument("--decoder_channels", default="32,24,16,12,8")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--n_epochs", type=int, default=6)
    p.add_argument("--bf16", action="store_true", help="bfloat16 autocast in the stages")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card: raise before anything is written

    data, runs = os.path.join(args.root, "data"), os.path.join(args.root, "runs")
    size = ["--img_height", str(args.size), "--img_width", str(args.size)]
    model = ["--encoder", args.encoder, "--decoder_channels", args.decoder_channels,
             "--batch_size", str(args.batch_size), "--device", args.device]
    common = (["--root_path", data, *size, *model, "--n_epochs", str(args.n_epochs)]
              + (["--bf16"] if args.bf16 else []))
    levir = ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"]
    psecd = [*levir, "--save_name", f"{runs}/psecd", "--load_model", "--load_path",
             f"{runs}/psecd"]
    steps = [
        ("demo data", make_demo_data.main,
         [data, "--n", str(args.n), "--size", str(args.size)]),
        ("stage 1: supervised segmentation pretrain (WHU-AB)", train_sup.main,
         [*common, "--dataset_name", "WHU-AB", "--save_name", f"{runs}/seg"]),
        ("stage 2: pseudo-change CD pretrain (LEVIR pairs)", train_pse_cd.main,
         [*common, *levir, "--save_name", f"{runs}/psecd"]),
        ("stage 2 util: reliability ranking -> reliable_ids.txt", train_pse_cd.main,
         [*common, *psecd, "--select_data"]),
        ("stage 2 util: pseudo-label generation -> ff_label/", train_pse_cd.main,
         [*common, *psecd, "--generate_label"]),
        ("stage 3: STCD fine-tune (seg + CD + contrastive)", train_stcd.main,
         [*common, *levir, "--save_name", f"{runs}/stcd", "--load_model", "--load_path",
          f"{runs}/psecd"]),
        ("final evaluation", evaluate.main,
         ["--root_path", data, "--dataset_name", "LEVIR", "--split", "val", "--load_path",
          f"{runs}/stcd", *model, *size]),
    ]
    results = {}
    for title, step_main, step_argv in steps:
        print(f"=== {title} ===", flush=True)
        t0 = time.monotonic()
        result = step_main(step_argv)
        results[title] = {"seconds": time.monotonic() - t0, "result": result}
    print("PIPELINE DEMO COMPLETE", flush=True)
    return results


if __name__ == "__main__":
    main()
