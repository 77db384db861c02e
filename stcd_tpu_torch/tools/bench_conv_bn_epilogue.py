"""Feasibility microbenchmark: a hand-written 1x1-conv (matmul) kernel with a
fused BatchNorm-statistics epilogue against the library's product with
separate statistics passes (counterpart of benchmarks/bench_conv_bn_epilogue.py).

A ResNet-50 bottleneck is two thirds 1x1 convolutions, which are plain matrix
products, so the question is: can a product that emits sum(y) and sum(y^2)
while the output tile is on chip match the library's conv plus its statistics
passes at those shapes? Variants per shape (bf16 in and out, f32 accumulation):

  dot            y = torch.matmul(x, w)                      (lower bound)
  dot+stats      y, then sum and sum of squares of y.float() in plain PyTorch
  conv4d+stats   a real 1x1 F.conv2d on a channels_last (1, M/128, 128, K)
                 view and the same sums: what the model does today
  dot+bn_stats   torch.matmul and torch.batch_norm_stats, the library's pair
  matmul_stats   ops.matmul_stats: one kernel giving y and both sums

and the error of matmul_stats against dot+stats on the scales that matter to
BatchNorm: |d mean| / std, |d var| / var, |d y| / max std.

Usage, from the root of a checkout, on a machine with a CUDA card:

  python -m stcd_tpu_torch.tools.bench_conv_bn_epilogue

Times are medians of CUDA events over 20 launches after 3 warm-up launches;
x is drawn from torch.Generator seed 0 and w from seed 1. ``--device cpu
--rows M`` runs the plain versions at M rows and gives no times (a CPU run
measures no device); without a card and without ``--device cpu`` the tool
raises. ``main`` returns its rows as a list of dicts.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from stcd_tpu_torch.utils.device import resolve_device
from stcd_tpu_torch.ops import matmul_stats as ops

# (M, K, N): SegCD resnet50 bottleneck 1x1 shapes at 64 pairs (the Siamese fold
# makes 128 images); M = images x H x W at the stage's resolution.
SHAPES = [
    (128 * 64 * 64, 64, 256),    # stage2 expand
    (128 * 64 * 64, 256, 64),    # stage2 reduce
    (128 * 32 * 32, 512, 128),   # stage3 reduce
    (128 * 32 * 32, 128, 512),   # stage3 expand
    (128 * 16 * 16, 1024, 256),  # stage4 reduce
]
RUNS = 20  # timed launches per variant
SEED = 0  # x from this seed, w from SEED + 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rows", type=int, default=None,
                   help="replace every shape's M (for a small run on the CPU)")


def operands(m: int, k: int, n: int, device: torch.device, seed: int = SEED):
    """Standard-normal bf16 x (M, K) and w (K, N) from torch.Generator(device)
    seeded with ``seed`` and ``seed + 1``."""
    out = []
    for shape, s in (((m, k), seed), ((k, n), seed + 1)):
        gen = torch.Generator(device=device).manual_seed(s)
        out.append(torch.randn(shape, generator=gen, device=device).bfloat16())
    return out


def time_ms(fn: Callable, device: torch.device) -> Optional[float]:
    """Median over RUNS launches, each timed with CUDA events; None on the
    CPU, where there is no device to time."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound_ms(m: int, k: int, n: int) -> float:
    """The least time an H100 could take: x, w read and y written once over
    the memory rate, or 2 M K N operations over the bf16 tensor-core rate."""
    nbytes = 2 * (m * k + k * n + m * n)
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS) * 1e3


def bn_scaled_error(m: int, want, got) -> float:
    """max of |d mean| / std, |d var| / var and |d y| / max std between two
    (y, sum, sumsq) triples, mean and var formed from the sums over m rows."""
    (y0, s1a, s2a), (y1, s1b, s2b) = want, got
    s1a, s2a, s1b, s2b = (t.double() for t in (s1a, s2a, s1b, s2b))
    ma, va = s1a / m, s2a / m - (s1a / m) ** 2
    mb, vb = s1b / m, s2b / m - (s1b / m) ** 2
    std = va.clamp_min(1e-6).sqrt()
    return max(((ma - mb).abs() / std).max().item(),
               ((va - vb).abs() / va.clamp_min(1e-6)).max().item(),
               (y0.float() - y1.float()).abs().max().item() / std.max().item())


def plain_sums(y: torch.Tensor):
    yf = y.float()
    return yf.sum(0), (yf * yf).sum(0)


def describe_device(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (plain versions, no times)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def fmt(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f}ms"


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    print(f"bench_conv_bn_epilogue on {describe_device(device)}; torch {torch.__version__}; "
          f"inputs: torch.Generator({device.type}) seeds {SEED} (x) and {SEED + 1} "
          f"(w), standard normal, bf16; kernel geometry: {ops.GEOMETRY}", flush=True)
    rows = []
    for m, k, n in SHAPES:
        m = args.rows or m
        x, w = operands(m, k, n, device)
        width = 128 if m % 128 == 0 else 1
        x4 = x.view(1, m // width, width, k).permute(0, 3, 1, 2)  # NCHW, channels_last
        w4 = w.t().reshape(n, k, 1, 1).contiguous(memory_format=torch.channels_last)

        def dot_stats():
            y = torch.matmul(x, w)
            return (y, *plain_sums(y))

        def conv4d_stats():
            y = F.conv2d(x4, w4)
            yf = y.float()
            return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))

        def dot_bn_stats():
            y = torch.matmul(x, w)
            return y, torch.batch_norm_stats(y.view(1, m // width, width, n)
                                             .permute(0, 3, 1, 2), 1e-5)

        want, got = dot_stats(), ops.matmul_stats(x, w)
        y4 = conv4d_stats()[0].permute(0, 2, 3, 1).reshape(m, n)
        row = {
            "m": m, "k": k, "n": n, "impl": "kernel" if on_card else "plain",
            "relerr": bn_scaled_error(m, want, got),
            "conv4d_y_err": (y4.float() - want[0].float()).abs().max().item(),
            "bound_ms": bound_ms(m, k, n),
            "dot_ms": time_ms(lambda: torch.matmul(x, w), device),
            "dot_stats_ms": time_ms(dot_stats, device),
            "conv4d_stats_ms": time_ms(conv4d_stats, device),
            # torch.batch_norm_stats has no CPU kernel
            "dot_bn_stats_ms": time_ms(dot_bn_stats, device) if on_card else None,
            "matmul_stats_ms": time_ms(lambda: ops.matmul_stats(x, w), device),
        }
        rows.append(row)
        notes = [f"relerr {row['relerr']:.2e}"]
        if on_card:
            notes = [f"dot-stats overhead {100 * (row['dot_stats_ms'] / row['dot_ms'] - 1):.0f}%",
                     f"conv4d vs dot+stats {row['conv4d_stats_ms'] / row['dot_stats_ms']:.2f}x",
                     f"matmul_stats {row['matmul_stats_ms'] / row['dot_ms']:.2f}x of dot and "
                     f"{row['matmul_stats_ms'] / row['conv4d_stats_ms']:.2f}x of CONV4d+stats",
                     *notes]
        print(f"M={m} K={k} N={n}: dot={fmt(row['dot_ms'])} "
              f"dot+stats={fmt(row['dot_stats_ms'])} "
              f"CONV4d+stats={fmt(row['conv4d_stats_ms'])} "
              f"dot+bn_stats={fmt(row['dot_bn_stats_ms'])} "
              f"matmul_stats={fmt(row['matmul_stats_ms'])} "
              f"bound={row['bound_ms']:.4f}ms ({', '.join(notes)})", flush=True)
        del x, w, x4, w4, want, got, y4
    return rows


if __name__ == "__main__":
    main()
