"""Microbenchmark: the BatchNorm statistics pass, alone, at the SegCD
ResNet-50 activation shapes of a 64-pair train step (counterpart of
benchmarks/bench_bnstats.py).

Variants per shape, x standard normal in bf16, channels-last (N, H, W, C):

  stats_plain  s1 = sum(x.float()), s2 = sum(x.float() ** 2) over (N, H, W):
               the JAX tool's stats_jnp, in plain PyTorch
  bn_stats     ops.bn_stats: the hand-written kernel, one launch
  stats_gram2  s1 = ones(8, M) . X summed, s2 = diag(X^T X): two products
               contracting over the M rows, bf16 operands, f32 results
  stats_gramA  one product: X with 8 columns of ones appended, s1 its ones
               row, s2 its diagonal (pays for materializing the concatenation)
  apply        relu(x * w + b): the elementwise normalize-apply pass, a
               bandwidth yardstick (reads and writes x once)

The two matrix-product formulations are yardsticks that the port never
calls on a path. Each variant's sums are held against stats_plain: the
largest difference over sqrt(elements), the JAX tool's scale (``*_err``), and
relative to the sum of the terms' magnitudes, sum |x| and sum x^2, the scale of
a float32 sum's rounding (``*_rel_err``). The bound is
x read once at 3.35 TB/s (the apply pass's: read and written once).

Times are medians of 20 replays of a CUDA graph of one call, by CUDA events.
The JAX tool's chained_timeit (one fori_loop of data-dependent calls) and its
``null`` row (the loop's carry-add pass, subtracted from every time) have no
counterpart: a graph replay runs the call alone, with no carry to add.

Usage, from the root of a checkout, on a machine with a CUDA card:

  python -m stcd_tpu_torch.tools.bench_bnstats

``--device cpu --rows M`` runs the plain versions on (M, 1, 1, C) inputs and
gives no times (a CPU run measures no device); without a card and without
``--device cpu`` the tool raises. ``main`` returns its rows as a list of
dicts.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

from stcd_tpu_torch.cli.predict import resolve_device
from stcd_tpu_torch.ops import bn_stats as ops
from stcd_tpu_torch.tools.bench_conv_bn_epilogue import (HBM_BYTES_PER_S, SEED, add_args,
                                                         describe_device, fmt)
from stcd_tpu_torch.tools.bench_kernels import graph_ms

# 64 pairs make 128 folded images; SegCD ResNet-50 conv-output shapes
SHAPES = [
    (128, 64, 64, 256),     # stage 2 conv3 out
    (128, 128, 128, 64),    # stem / stage 1
    (128, 32, 32, 512),     # stage 3 conv3 out
    (128, 16, 16, 1024),    # stage 4 conv3 out
    (128, 256, 256, 16),    # decoder, full resolution
    (128, 128, 128, 32),    # decoder, half resolution
]
Stats = Tuple[torch.Tensor, torch.Tensor]


def stats_plain(x: torch.Tensor) -> Stats:
    xf = x.float()
    return xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b of bf16 operands with float32 accumulation and a float32 result
    (JAX's preferred_element_type): on a card the product's own f32 output,
    on the CPU, which has no such kernel, the product of the exact upcasts."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def stats_gram2(x: torch.Tensor) -> Stats:
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    ones = torch.ones((8, x2.shape[0]), dtype=x.dtype, device=x.device)
    return _mm_f32(ones, x2)[0], torch.diagonal(_mm_f32(x2.t(), x2))


def stats_gramA(x: torch.Tensor) -> Stats:
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    ones = torch.ones((x2.shape[0], 8), dtype=x.dtype, device=x.device)
    xa = torch.cat([x2, ones], dim=1)
    g = _mm_f32(xa.t(), xa)
    return g[-1, :c], torch.diagonal(g)[:c]


def make_apply(c: int, device: torch.device):
    w = torch.full((c,), 1.01, dtype=torch.bfloat16, device=device)
    b = torch.full((c,), 0.02, dtype=torch.bfloat16, device=device)
    return lambda x: torch.relu(x * w + b)


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    def timed(fn):
        """Graph replays on the card; on the CPU one untimed call."""
        if on_card:
            return graph_ms(torch, fn)
        fn()
        return None
    print(f"bench_bnstats on {describe_device(device)}; torch {torch.__version__}; inputs: "
          f"torch.Generator({device.type}) seed {SEED}, standard normal, bf16", flush=True)
    rows = []
    for shape in SHAPES:
        if args.rows:
            shape = (args.rows, 1, 1, shape[-1])
        c = shape[-1]
        elts = shape[0] * shape[1] * shape[2] * c
        gen = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn(shape, generator=gen, device=device).bfloat16()
        apply = make_apply(c, device)
        variants = {"stats_plain": stats_plain, "bn_stats": ops.bn_stats,
                    "stats_gram2": stats_gram2, "stats_gramA": stats_gramA}
        want = stats_plain(x)
        # the sums of the terms' magnitudes: the scale of a float32 sum's rounding
        scale = (x.float().abs().sum((0, 1, 2)), want[1])
        row = {"shape": list(shape), "c": c, "impl": "kernel" if on_card else "plain",
               "bound_ms": elts * 2 / HBM_BYTES_PER_S * 1e3,
               "apply_bound_ms": 2 * elts * 2 / HBM_BYTES_PER_S * 1e3}
        for name, fn in variants.items():
            got = fn(x)
            row[f"{name}_err"] = max((g - w).abs().max().item()
                                     for g, w in zip(got, want)) / elts ** 0.5
            row[f"{name}_rel_err"] = max(((g - w).abs() / m.clamp_min(1.0)).max().item()
                                         for g, w, m in zip(got, want, scale))
            row[f"{name}_ms"] = timed(lambda: fn(x))
            del got
        row["apply_ms"] = timed(lambda: apply(x))
        t_plain = row["stats_plain_ms"]
        ratios = {name: ("" if t_plain is None or row[f"{name}_ms"] is None
                         else f" ({row[f'{name}_ms'] / t_plain:.2f}x)")
                  for name in variants}
        print(f"{tuple(shape)}: stats_plain={fmt(t_plain)} "
              f"bn_stats={fmt(row['bn_stats_ms'])}{ratios['bn_stats']} "
              f"[err {row['bn_stats_err']:.1e}] "
              f"gram2={fmt(row['stats_gram2_ms'])}{ratios['stats_gram2']} "
              f"[err {row['stats_gram2_err']:.1e}] "
              f"gramA={fmt(row['stats_gramA_ms'])}{ratios['stats_gramA']} "
              f"[err {row['stats_gramA_err']:.1e}] apply={fmt(row['apply_ms'])} "
              f"(bound: read {row['bound_ms']:.4f}ms, apply {row['apply_bound_ms']:.4f}ms)",
              flush=True)
        rows.append(row)
        del x, want, scale
        if on_card:
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
