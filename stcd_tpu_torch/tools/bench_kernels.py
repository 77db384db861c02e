"""Times the matmul kernels, the BatchNorm sums, the augmentation kernel and
the float32 attention kernels of a checkout on one CUDA card, beside one
PyTorch call for the same function and the bound, so that two checkouts can be
compared in one run on one card.

Usage, on a machine with a CUDA card:

    python stcd_tpu_torch/tools/bench_kernels.py [--root DIR] [--label NAME] [--out FILE]
        [--only SECTION,...]

``--root`` is the checkout whose ``stcd_tpu_torch`` is imported and timed
(default: the one this file lies in); another checkout (an unpacked ``git
archive`` of an earlier commit, say) builds its own kernels under its own
``build/``. Run it as a file, not with ``-m``, so that the package is taken
from ``--root`` alone. To compare two checkouts, run old, new, new, old.

What it times, every kernel as the median of 20 replays of a CUDA graph of
one call (a kernel of tens of microseconds is then not timed by the host's
pace of launching it), an autograd backward as profiler device time:

- ``matmul_bf16`` and ``matmul_stats_mma`` (the product with the column sums
  of its f32 accumulator and of its square, formed on the tensor cores) at
  the three shapes of ``tools/bench_bnstats_diag.py``, beside
  ``torch.matmul``; bound: x, w read and y (and the two f32[N] sums) written
  once at 3.35 TB/s, or 2 M K N operations at 989 TFLOP/s;
- ``matmul_stats`` (the same sums, formed on the CUDA cores) at the five
  shapes of ``tools/bench_conv_bn_epilogue.py``, beside ``matmul_bf16``,
  ``matmul_stats_mma`` and ``torch.matmul`` at the same shapes; the same bound;
- ``matmul_stats_rows`` (section ``matmul_stats_rows``) at the three shapes of
  ``tools/bench_bnstats_diag.py`` (its total) and at ``ROWS_OTHER_SHAPES``,
  one whose w does not stay resident and one that TMA cannot describe,
  beside ``matmul_stats``; the same bound;
- ``bn_stats`` (section ``bn_stats``) at the six shapes of
  ``tools/bench_bnstats.py``, bf16 and f32, beside ``torch.batch_norm_stats``,
  with the kernels one call launches (torch.profiler); bound: x read and the
  sums written once at 3.35 TB/s;
- the augmentation at the train step's shape (128 images of 256x256, uint8)
  with the sampler's draws, with every gate on and with every gate off, also
  as CUDA events around one eager call (the wrapper's host time included),
  and the device time of each kernel one call launches (torch.profiler);
  bound: the images read and the output written once at 3.35 TB/s, or the
  f32 operations the gates ask for at 67 TFLOP/s;
- the float32 attention forward at the four SRA shapes of a serving batch
  (16 tile pairs of 256x256) and of the ChangeFormerV6 train step (8 pairs of
  512x512), beside ``F.scaled_dot_product_attention`` in float32 (TF32 off);
  bound: q, k, v read and o written once, or 4 N M D + 5 N M operations a
  head at 67 TFLOP/s;
- the float32 attention backward at the train shapes, beside the backward of
  ``F.scaled_dot_product_attention``; bound: q, k, v, g read and dq, dk, dv
  written once, or 10 N M D + 8 N M operations a head.

``--only`` picks sections (``matmul``: ``matmul_bf16`` and
``matmul_stats_mma``; ``matmul_stats``; ``matmul_stats_rows``; ``bn_stats``;
``augment``; ``attention``), to time what a change touched. A checkout with no ``routes`` on
``matmul_stats_rows_kernel`` (an earlier commit) gives its rows without the
route. Each kernel's output is also held against its plain
version (the largest difference is printed). The result is one JSON line on stdout, and in
``--out`` if given. Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
SERVING_SHAPES = ((32, 1, 4096, 64, 64), (32, 2, 1024, 64, 64), (32, 4, 256, 64, 80),
                  (32, 8, 64, 64, 64))
TRAIN_SHAPES = ((16, 1, 16384, 256, 64), (16, 2, 4096, 256, 64), (16, 4, 1024, 256, 80),
                (16, 8, 256, 256, 64))
SRA_DEPTHS = (3, 3, 4, 3)  # SRA calls a ChangeFormerV6 encoder makes at each stage
SECTIONS = ("matmul", "matmul_stats", "matmul_stats_rows", "bn_stats", "augment", "attention")
# matmul_stats_rows besides its tool's shapes: w too wide to stay resident in
# shared memory (bench_conv_bn_epilogue's last shape); N no multiple of 8
ROWS_OTHER_SHAPES = ((32768, 1024, 256), (32768, 1000, 250))


def graph_ms(torch, fn, runs: int = 20) -> float:
    """Median of ``runs`` replays of a CUDA graph of one call, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def profiled_ms(torch, fn, runs: int = 10) -> float:
    """Device time of one call from torch.profiler, summed over its kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages())
    if total_us <= 0:
        raise RuntimeError("torch.profiler saw no device time")
    return total_us / runs / 1e3


def eager_ms(torch, fn, runs: int = 20) -> float:
    """Median of ``runs`` eager calls, each between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


# f32 operations per pixel of each stage of the augmentation (counted from
# data/augment.py: multiplies, adds, divides, compares and selects)
AUG_OPS = {"to_float": 3, "jitter": 9 + 17 + 22 + 75, "gray": 5, "blur": 2 * 11 * 2 * 3,
           "normalize": 6}
AUG_SHAPE = (128, 256, 256, 3)  # A||B of the batch-64 train step


def augment_bound_ms(imgs, params) -> tuple:
    """(bound_ms, bound_by) of one augmentation call on these inputs: each
    input read once and the output written once over the memory rate,
    against the operations these gates ask for over the f32 rate."""
    n, h, w, _ = imgs.shape
    nbytes = imgs.numel() * imgs.element_size() + imgs.numel() * 4
    nbytes += sum(v.numel() * v.element_size() for v in params.values())
    per_image = AUG_OPS["normalize"] + (AUG_OPS["to_float"] if imgs.dtype.itemsize == 1
                                        else 0)
    ops = h * w * (n * per_image
                   + int(params["jitter_apply"].sum()) * AUG_OPS["jitter"]
                   + int(params["gray_apply"].sum()) * AUG_OPS["gray"]
                   + int(params["blur_apply"].sum()) * AUG_OPS["blur"])
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attention_bound_ms(shape, backward: bool) -> float:
    b, h, n, m, d = shape
    rows, products, softmax = (3 * n + 4 * m, 10, 8) if backward else (2 * n + 2 * m, 4, 5)
    by_bytes = b * h * rows * d * 4 / HBM_BYTES_PER_S
    by_ops = b * h * n * m * (products * d + softmax) / F32_FLOPS
    return max(by_bytes, by_ops) * 1e3


def bench_matmul(torch, ops, shapes):
    rows = []
    for m, k, n in shapes:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        got, want = ops.matmul_bf16(x, w), ops.matmul_bf16(x, w, impl="plain")
        err = (got.float() - want.float()).abs().max().item()
        y, s1, s2 = ops.matmul_stats_mma(x, w)
        acc = (x.float() @ w.float()).double()  # the sums against float64, on BatchNorm's scale
        mean = acc.sum(0) / m
        var = ((acc * acc).sum(0) / m - mean ** 2).clamp_min(1e-6)
        stats_err = max(((s1.double() / m - mean).abs() / var.sqrt()).max().item(),
                        ((s2.double() / m - (s1.double() / m) ** 2 - var).abs() / var).max().item())
        nbytes = 2 * (m * k + k * n + m * n)
        rows.append({"shape": [m, k, n], "max_abs_err": err,
                     "ms": graph_ms(torch, lambda: ops.matmul_bf16(x, w)),
                     "stats_mma_ms": graph_ms(torch, lambda: ops.matmul_stats_mma(x, w)),
                     "stats_mma_y_equal": bool(torch.equal(y, got)),
                     "stats_mma_bn_scaled_err": stats_err,
                     "library_ms": graph_ms(torch, lambda: torch.matmul(x, w)),
                     "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                     2 * m * k * n / BF16_FLOPS) * 1e3,
                     "stats_bound_ms": max((nbytes + 8 * n) / HBM_BYTES_PER_S,
                                           2 * m * k * n / BF16_FLOPS) * 1e3})
        print(f"matmul {(m, k, n)}: {rows[-1]}", flush=True)
        del x, w, got, want, y, s1, s2, acc
    return rows


def bn_scaled_err(torch, x, w, s1, s2) -> float:
    """The sums against float64 on BatchNorm's scales: |d mean| / std, |d var| / var."""
    m = x.shape[0]
    acc = (x.float() @ w.float()).double()
    mean = acc.sum(0) / m
    var = ((acc * acc).sum(0) / m - mean ** 2).clamp_min(1e-6)
    return max(((s1.double() / m - mean).abs() / var.sqrt()).max().item(),
               ((s2.double() / m - (s1.double() / m) ** 2 - var).abs() / var).max().item())


def bench_matmul_stats(torch, ops, shapes):
    """matmul_stats beside matmul_bf16, matmul_stats_mma and torch.matmul."""
    rows = []
    for m, k, n in shapes:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        y, s1, s2 = ops.matmul_stats(x, w)
        y_plain = ops.matmul_bf16(x, w, impl="plain")
        nbytes = 2 * (m * k + k * n + m * n) + 8 * n
        row = {"shape": [m, k, n],
               "max_abs_err": (y.float() - y_plain.float()).abs().max().item(),
               "bn_scaled_err": bn_scaled_err(torch, x, w, s1, s2),
               "y_equal_matmul_bf16": bool(torch.equal(y, ops.matmul_bf16(x, w))),
               "route": None,
               "ms": graph_ms(torch, lambda: ops.matmul_stats(x, w)),
               "matmul_bf16_ms": graph_ms(torch, lambda: ops.matmul_bf16(x, w)),
               "stats_mma_ms": graph_ms(torch, lambda: ops.matmul_stats_mma(x, w)),
               "library_ms": graph_ms(torch, lambda: torch.matmul(x, w)),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS) * 1e3}
        if hasattr(ops.matmul_stats_kernel, "routes"):  # a checkout whose matmul_stats has routes
            before = dict(ops.matmul_stats_kernel.routes)
            ops.matmul_stats(x, w)
            row["route"] = [r for r, c in ops.matmul_stats_kernel.routes.items()
                            if c != before.get(r, 0)][0]
        print(f"matmul_stats {(m, k, n)}: {row}", flush=True)
        rows.append(row)
        del x, w, y, s1, s2, y_plain
        torch.cuda.empty_cache()
    return rows


BN_SHAPES = ((128, 64, 64, 256), (128, 128, 128, 64), (128, 32, 32, 512), (128, 16, 16, 1024),
             (128, 256, 256, 16), (128, 128, 128, 32))  # bench_bnstats.SHAPES


def bench_bn_stats(torch, bn_ops):
    """bn_stats at the six SegCD-r50 shapes, bf16 and f32, beside
    torch.batch_norm_stats; bound: x read once and the sums written once at
    3.35 TB/s. Each row lists the kernels one call launches (torch.profiler)."""
    rows = []
    gen = torch.Generator(device="cpu").manual_seed(6)
    for shape in BN_SHAPES:
        base = torch.randn(shape, generator=gen) * 2.0 + 0.5
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to("cuda", dtype)
            got, want = bn_ops.bn_stats(x), bn_ops.bn_stats(x, impl="plain")
            nchw = x.permute(0, 3, 1, 2)
            row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                   "rel_err": max(((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
                                  for g, w in zip(got, want)),
                   "ms": graph_ms(torch, lambda: bn_ops.bn_stats(x)),
                   "kernels_ms": device_kernels_ms(torch, lambda: bn_ops.bn_stats(x)),
                   "library_ms": graph_ms(torch, lambda: torch.batch_norm_stats(nchw, 1e-5)),
                   "bound_ms": (x.numel() * x.element_size() + 8 * c) / HBM_BYTES_PER_S * 1e3}
            print(f"bn_stats {shape} {row['dtype']}: {row}", flush=True)
            rows.append(row)
            del x, got, want, nchw
        del base
        torch.cuda.empty_cache()
    return rows


def bench_matmul_stats_rows(torch, ops, shapes):
    """matmul_stats_rows beside matmul_stats at the same shapes."""
    rows = []
    for m, k, n in shapes:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        y, s1, s2 = ops.matmul_stats_rows(x, w)
        nbytes = 2 * (m * k + k * n + m * n) + 8 * n
        row = {"shape": [m, k, n], "bn_scaled_err": bn_scaled_err(torch, x, w, s1, s2),
               "y_equal_matmul_bf16": bool(torch.equal(y, ops.matmul_bf16(x, w))),
               "route": None,
               "ms": graph_ms(torch, lambda: ops.matmul_stats_rows(x, w)),
               "matmul_stats_ms": graph_ms(torch, lambda: ops.matmul_stats(x, w)),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS) * 1e3}
        if hasattr(ops.matmul_stats_rows_kernel, "routes"):  # a checkout with rows' routes
            before = dict(ops.matmul_stats_rows_kernel.routes)
            ops.matmul_stats_rows(x, w)
            row["route"] = [r for r, c in ops.matmul_stats_rows_kernel.routes.items()
                            if c != before.get(r, 0)][0]
        print(f"matmul_stats_rows {(m, k, n)}: {row}", flush=True)
        rows.append(row)
        del x, w, y, s1, s2
        torch.cuda.empty_cache()
    return rows


def device_kernels_ms(torch, fn, runs: int = 5) -> dict:
    """Device time of each kernel that one call of ``fn`` launches, from
    torch.profiler, averaged over ``runs`` calls: {kernel name: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total / runs / 1e3
    return out


def bench_augment(torch, root_modules):
    """The augmentation at the train step's shape: the sampler's draws, every
    gate on, every gate off."""
    augment, data_augment = root_modules
    gen = torch.Generator(device="cpu").manual_seed(0)
    imgs = torch.randint(0, 256, AUG_SHAPE, generator=gen, dtype=torch.uint8).to("cuda")
    n = AUG_SHAPE[0]
    draws = data_augment.params_to(data_augment.sample_augment_params(gen, n, 0.5), "cuda")
    gates = ("jitter_apply", "gray_apply", "blur_apply")
    cases = {"train_step": draws,
             "every_gate_on": {**draws, **{g: torch.ones(n, dtype=torch.bool, device="cuda")
                                           for g in gates}},
             "every_gate_off": {**draws, **{g: torch.zeros(n, dtype=torch.bool, device="cuda")
                                            for g in gates}}}
    rows = {}
    for name, params in cases.items():
        got = augment.apply_augment_batch(imgs, params, impl="kernel")
        want = augment.apply_augment_batch(imgs, params, impl="plain")
        bound, by = augment_bound_ms(imgs, params)
        rows[name] = {"shape": list(AUG_SHAPE), "max_abs_err": (got - want).abs().max().item(),
                      "ms": graph_ms(torch, lambda: augment.apply_augment_batch(imgs, params)),
                      "eager_ms": eager_ms(torch, lambda: augment.apply_augment_batch(imgs,
                                                                                      params)),
                      "kernels_ms": device_kernels_ms(
                          torch, lambda: augment.apply_augment_batch(imgs, params)),
                      "bound_ms": bound, "bound_by": by,
                      "gates": {g: int(params[g].sum()) for g in gates}}
        print(f"augment {name}: {rows[name]}", flush=True)
        del got, want
    return rows


def bench_attention(torch, attention, shapes, backward: bool):
    import torch.nn.functional as F
    rows = []
    gen = torch.Generator(device="cpu").manual_seed(11)
    for shape in shapes:
        b, h, n, m, d = shape
        q, k, v, g = (torch.randn(b, h, rows_, d, generator=gen).to("cuda")
                      for rows_ in (n, m, m, n))
        scale = d ** -0.5
        out, lse = attention.launch_forward(q, k, v, scale, 0.0, None, True)
        plain = attention.attention_plain(q, k, v, scale)
        row = {"shape": list(shape),
               "max_abs_err": (out - plain).abs().max().item(),
               "ms": graph_ms(torch, lambda: attention.cross_attention(q, k, v, scale)),
               "library_ms": graph_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale)),
               "bound_ms": attention_bound_ms(shape, False)}
        del plain
        if backward:
            row["bwd_ms"] = graph_ms(torch, lambda: attention.launch_backward(
                q, k, v, out, lse, g, scale, 0.0, None), runs=10)
            leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)
            row["bwd_library_ms"] = profiled_ms(torch, lambda: torch.autograd.grad(
                sdpa, leaves, g, retain_graph=True))
            row["bwd_bound_ms"] = attention_bound_ms(shape, True)
            del leaves, sdpa
        print(f"attention f32 {shape}: {row}", flush=True)
        rows.append(row)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose stcd_tpu_torch is timed")
    p.add_argument("--label", default=None, help="a name for this run in the JSON line")
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    p.add_argument("--only", default=",".join(SECTIONS),
                   help=f"comma-separated sections to time, of {', '.join(SECTIONS)} "
                        f"(default: all)")
    args = p.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        p.error(f"--only takes sections of {SECTIONS}, got {args.only}")
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from stcd_tpu_torch.data import augment as data_augment
    from stcd_tpu_torch.ops import attention, augment
    from stcd_tpu_torch.ops import bn_stats as bn_ops
    from stcd_tpu_torch.ops import matmul_stats as ops
    from stcd_tpu_torch.tools.bench_bnstats_diag import SHAPES
    from stcd_tpu_torch.tools.bench_conv_bn_epilogue import SHAPES as CONV_SHAPES
    if not Path(attention.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"stcd_tpu_torch came from {attention.__file__}, not {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"bench_kernels: {root} on {card}; torch {torch.__version__}", flush=True)
    result = {"label": args.label or root.name, "root": str(root), "card": card}
    if "matmul" in only:
        matmul = bench_matmul(torch, ops, SHAPES)
        result.update({"matmul_bf16": matmul, "matmul_bf16_ms": sum(r["ms"] for r in matmul),
                       "matmul_stats_mma_ms": sum(r["stats_mma_ms"] for r in matmul),
                       "matmul_bf16_library_ms": sum(r["library_ms"] for r in matmul)})
    if "matmul_stats" in only:
        stats = bench_matmul_stats(torch, ops, CONV_SHAPES)
        result.update({"matmul_stats": stats, "matmul_stats_ms": sum(r["ms"] for r in stats),
                       "matmul_stats_bound_ms": sum(r["bound_ms"] for r in stats)})
    if "matmul_stats_rows" in only:
        stats_rows = bench_matmul_stats_rows(torch, ops, tuple(SHAPES) + ROWS_OTHER_SHAPES)
        tool_rows = stats_rows[:len(SHAPES)]
        result.update({"matmul_stats_rows": stats_rows,
                       "matmul_stats_rows_ms": sum(r["ms"] for r in tool_rows),
                       "matmul_stats_rows_bound_ms": sum(r["bound_ms"] for r in tool_rows)})
    if "bn_stats" in only:
        bn = bench_bn_stats(torch, bn_ops)
        for dtype in ("bfloat16", "float32"):
            picked = [r for r in bn if r["dtype"] == dtype]
            result[f"bn_stats_{dtype}_ms"] = sum(r["ms"] for r in picked)
            result[f"bn_stats_{dtype}_library_ms"] = sum(r["library_ms"] for r in picked)
            result[f"bn_stats_{dtype}_bound_ms"] = sum(r["bound_ms"] for r in picked)
        result["bn_stats"] = bn
    if "augment" in only:
        result["augment"] = bench_augment(torch, (augment, data_augment))
    if "attention" in only:
        serving = bench_attention(torch, attention, SERVING_SHAPES, backward=False)
        train = bench_attention(torch, attention, TRAIN_SHAPES, backward=True)
        result.update({
            "attention_serving": serving,
            "attention_serving_batch_ms": sum(depth * r["ms"]
                                              for depth, r in zip(SRA_DEPTHS, serving)),
            "attention_serving_batch_library_ms": sum(
                depth * r["library_ms"] for depth, r in zip(SRA_DEPTHS, serving)),
            "attention_train": train,
            "attention_train_bwd_ms": sum(r["bwd_ms"] for r in train),
            "attention_train_bwd_library_ms": sum(r["bwd_library_ms"] for r in train)})
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
