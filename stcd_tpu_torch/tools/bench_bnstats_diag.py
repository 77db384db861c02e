"""Diagnostic for the conv + BatchNorm-statistics feasibility question: where
does the gap between ``matmul_stats`` and the library's product come from?
(Counterpart of benchmarks/bench_bnstats_diag.py.)

Variants per shape, each timed as a ratio of ``torch.matmul``:

  matmul_bf16        the hand-written product, no statistics epilogue: the
                     quality of the product itself
  matmul_stats_rows  the fused kernel with a block owning its rows across all
                     N: the cost of the decomposition
  matmul_stats_mma   the sums through a ones-row contraction on the tensor
                     cores instead of the CUDA cores: the epilogue's cost

and, as a sanity check, the largest difference between the sums of the two
fused variants.

Usage, from the root of a checkout, on a machine with a CUDA card:

  python -m stcd_tpu_torch.tools.bench_bnstats_diag

Times are medians of CUDA events over 20 launches after 3 warm-up launches.
``--device cpu --rows M`` runs the plain versions at M rows and gives no
times; without a card and without ``--device cpu`` the tool raises. ``main``
returns its rows as a list of dicts.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from stcd_tpu_torch.utils.device import resolve_device
from stcd_tpu_torch.ops import matmul_stats as ops
from stcd_tpu_torch.tools.bench_conv_bn_epilogue import (SEED, add_args, bound_ms,
                                                         describe_device, fmt, operands,
                                                         time_ms)

SHAPES = [
    (128 * 64 * 64, 64, 256),
    (128 * 32 * 32, 512, 128),
    (128 * 32 * 32, 128, 512),
]
VARIANTS = (("matmul_bf16", ops.matmul_bf16), ("matmul_stats_rows", ops.matmul_stats_rows),
            ("matmul_stats_mma", ops.matmul_stats_mma))


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"bench_bnstats_diag on {describe_device(device)}; torch {torch.__version__}; "
          f"inputs: torch.Generator({device.type}) seeds {SEED} (x) and {SEED + 1} "
          f"(w), standard normal, bf16; kernel geometry: {ops.GEOMETRY}", flush=True)
    rows = []
    for m, k, n in SHAPES:
        m = args.rows or m
        x, w = operands(m, k, n, device)
        # sanity: the fused variants agree with each other and with the product alone
        y_mm = ops.matmul_bf16(x, w)
        y_a, a1, a2 = ops.matmul_stats_rows(x, w)
        y_b, b1, b2 = ops.matmul_stats_mma(x, w)
        row = {
            "m": m, "k": k, "n": n, "impl": "kernel" if device.type == "cuda" else "plain",
            "cross_variant_err": (a1 - b1).abs().max().item() + (a2 - b2).abs().max().item(),
            "cross_variant_rel_err": max(((a1 - b1).abs().max() / a1.abs().max()).item(),
                                         ((a2 - b2).abs().max() / a2.abs().max()).item()),
            "y_equal": bool(torch.equal(y_mm, y_a) and torch.equal(y_a, y_b)),
            "bound_ms": bound_ms(m, k, n),
            "dot_ms": time_ms(lambda: torch.matmul(x, w), device),
        }
        for name, fn in VARIANTS:
            row[f"{name}_ms"] = t = time_ms(lambda: fn(x, w), device)
            ratio = ("" if t is None
                     else f" ({t / row['dot_ms']:.2f}x of dot={fmt(row['dot_ms'])})")
            print(f"M={m} K={k} N={n} {name}: {fmt(t)}{ratio}", flush=True)
        print(f"  cross-variant stats err: {row['cross_variant_err']:.2e} "
              f"({row['cross_variant_rel_err']:.2e} of the largest sum); y of the three "
              f"variants {'bit-equal' if row['y_equal'] else 'DIFFERS'}; bound "
              f"{row['bound_ms']:.4f}ms", flush=True)
        rows.append(row)
        del x, w, y_mm, y_a, y_b
    return rows


if __name__ == "__main__":
    main()
