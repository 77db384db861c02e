#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stcd_tpu_torch) on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from ops/csrc with nvcc.
3. kernel against plain: the SRA attention kernel against its plain
   PyTorch version at the four ChangeFormerV6 SRA shapes of a 16-pair batch
   of 256x256 tiles, plus a ragged shape; f32 and bf16, dropout 0 and 0.1.
4. serving: the full-width ChangeFormerV6 (seeded random weights) behind the
   micro-batching engine (batch 16, tile 256), driven by concurrent 512x512
   requests. Checks the outputs, that every device batch launched the
   attention kernel 13 times, that the stitched probabilities match the same
   weights run with the plain attention, and that a bf16 request is finite.

The last line is one JSON object: {"ok": true, "device": {...}}. The line
before it lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

F32_ATOL = 2e-5  # summation order and expf against the plain f32 softmax
BF16_ATOL = 1e-2  # one bf16 ulp of the output near 1
PROBS_ATOL = 1e-3  # stitched P(changed), kernel against plain attention
BATCH, TILE, SCENE = 16, 256, 512
ROUNDS = 6  # rounds of 4 concurrent requests; the first one is not timed
SRA_DEPTHS = (3, 3, 4, 3)  # SRA calls per encoder stage


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sra_shapes(batch: int = BATCH, tile: int = TILE):
    """(B, H, N, M, D) of the 4 SRA stages for a batch of tile pairs: the
    Siamese encoder folds A||B into 2*batch images."""
    b = 2 * batch
    out = []
    for s, (dim, heads, sr) in enumerate(zip((64, 128, 320, 512), (1, 2, 4, 8),
                                             (8, 4, 2, 1))):
        side = tile // (4 * 2 ** s)
        out.append((b, heads, side * side, (side // sr) ** 2, dim // heads))
    return out


def time_ms(fn, runs: int = 20) -> float:
    """Median over ``runs`` launches, each timed with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def phase_kernels(torch, attention):
    cross_attention = attention.cross_attention
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(shape, True) for shape in sra_shapes()] + [((2, 2, 1000, 37, 80), False)]
    max_err = 0.0
    stage_ms = {}
    for (b, h, n, m, d), on_path in cases:
        for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
            q, k, v = (torch.randn(b, h, rows, d, generator=gen).to("cuda", dtype)
                       for rows in (n, m, m))
            for rate in (0.0, 0.1):
                seed = 1234 if rate else None

                def run(impl):
                    return cross_attention(q, k, v, dropout_rate=rate,
                                           dropout_seed=seed, impl=impl)

                got, want = run("kernel"), run("plain")
                torch.cuda.synchronize()
                require(got.dtype == dtype and got.shape == q.shape,
                        f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                t_kernel = time_ms(lambda: run("kernel"))
                t_plain = time_ms(lambda: run("plain"))
                name = str(dtype).replace("torch.", "")
                print(f"attention (B,H,N,M,D)={(b, h, n, m, d)} {name} dropout={rate}: "
                      f"max|err|={err:.3e} (atol {atol}) kernel {t_kernel:.4f} ms "
                      f"plain {t_plain:.4f} ms", flush=True)
                require(err <= atol, f"kernel disagrees with plain by {err} > {atol}")
                max_err = max(max_err, err)
                if on_path and dtype == torch.float32 and rate == 0.0:
                    stage_ms[(b, h, n, m, d)] = (t_kernel, t_plain)
    per_batch = [sum(depth * stage_ms[s][i] for depth, s in zip(SRA_DEPTHS, sra_shapes()))
                 for i in (0, 1)]
    print(f"attention per device batch (13 SRA calls, f32): kernel {per_batch[0]:.4f} ms, "
          f"plain {per_batch[1]:.4f} ms", flush=True)
    return max_err, per_batch[0], per_batch[1]


def drive(engine, scenes):
    """One round: each scene pair as a concurrent predict_pair call."""
    results = [None] * len(scenes)
    errors = []

    def worker(i):
        try:
            results[i] = engine.predict_pair(*scenes[i])
        except Exception as exc:  # re-raised below, in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(scenes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        require(not t.is_alive(), "a predict_pair call did not finish in 600 s")
    if errors:
        raise errors[0]
    return results


def phase_serving(torch, np, attention, gpu_label):
    from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_base_fn
    from stcd_tpu_torch.data.tiled_inference import predict_scene
    from stcd_tpu_torch.models import changeformer
    from stcd_tpu_torch.serving.server import BatchingEngine
    from stcd_tpu_torch.tools.profile_step import plain_attention

    parser = argparse.ArgumentParser()
    add_model_args(parser)
    args = parser.parse_args(["--init_seed", "0", "--device", "cuda",
                              "--tile", str(TILE)])
    model = build_model(args)
    base_fn = make_base_fn(args, model)
    with torch.inference_mode():  # warm one batch shape, as cli.serve does
        z = torch.zeros((BATCH, TILE, TILE, 3), device="cuda")
        base_fn(z, z).cpu()
    torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(0)
    rounds = [[tuple(rng.uniform(0, 1, (SCENE, SCENE, 3)).astype(np.float32)
                     for _ in range(2)) for _ in range(4)] for _ in range(ROUNDS)]
    kernel = attention.cross_attention_kernel
    engine = BatchingEngine(base_fn, tile=TILE, batch=BATCH, max_wait_ms=50.0,
                            device="cuda")
    try:
        kernel.kernel_launches = 0
        results = [drive(engine, rounds[0])]
        t0 = time.monotonic()
        for scenes in rounds[1:]:
            results.append(drive(engine, scenes))
        timed_s = time.monotonic() - t0
        launches = kernel.kernel_launches
        stats = engine.stats_snapshot()
    finally:
        engine.close()

    for res in results:
        for probs in res:
            require(probs.shape == (SCENE, SCENE, 1), f"probs shape {probs.shape}")
            require(bool(np.isfinite(probs).all()), "non-finite probabilities")
            require(probs.min() >= 0.0 and probs.max() <= 1.0, "probs outside [0, 1]")
    n_req = 4 * ROUNDS
    require(stats["requests"] == n_req and stats["errors"] == 0,
            f"engine stats {stats}")
    require(launches == 13 * stats["batches"] and launches > 0,
            f"{launches} kernel launches for {stats['batches']} device batches")
    tiles_per_s = 4 * (SCENE // TILE) ** 2 * (ROUNDS - 1) / timed_s
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serving: {n_req} requests, {stats['tiles']} tiles in {stats['batches']} "
          f"device batches (occupancy {stats['mean_batch_occupancy']:.3f}); "
          f"attention kernel launches {launches} = 13 x {stats['batches']}", flush=True)
    print(f"serving /stats on {gpu_label}, fp32 with TF32 off as cli.serve runs it "
          f"(a smoke reading, n = {stats['batches']} steps and {n_req} requests): "
          f"step_ms p50 {stats['step_ms']['p50']} p99 {stats['step_ms']['p99']}; "
          f"request_latency_ms p50 {stats['request_latency_ms']['p50']} "
          f"p99 {stats['request_latency_ms']['p99']}; "
          f"{tiles_per_s:.2f} tiles/s over rounds 2-{ROUNDS}; "
          f"peak device memory {peak_gib:.2f} GiB", flush=True)
    print("serving /stats json: " + json.dumps(stats), flush=True)

    # the same weights with the plain attention, on request 0 of round 0
    sra = [m for m in model.modules() if isinstance(m, changeformer.SRAttention)]
    require(len(sra) == 13, f"{len(sra)} SRA blocks")
    before = kernel.kernel_launches
    with plain_attention():
        plain = predict_scene(base_fn, *rounds[0][0], tile=TILE, stride=TILE,
                              batch=BATCH, device="cuda")
    require(kernel.kernel_launches == before, "the plain run launched the kernel")
    err = float(np.abs(plain - results[0][0]).max())
    print(f"full model, kernel against plain attention: max|dP|={err:.3e} "
          f"(atol {PROBS_ATOL})", flush=True)
    require(err <= PROBS_ATOL, f"stitched probabilities differ by {err}")

    bf16_args = parser.parse_args(["--init_seed", "0", "--device", "cuda",
                                   "--tile", str(TILE), "--bf16"])
    engine = BatchingEngine(make_base_fn(bf16_args, model), tile=TILE, batch=BATCH,
                            device="cuda")
    try:
        before = kernel.kernel_launches
        bf16 = engine.predict_pair(*rounds[0][0])
        bf16_batches = engine.stats_snapshot()["batches"]
    finally:
        engine.close()
    require(bool(np.isfinite(bf16).all()) and bf16.min() >= 0 and bf16.max() <= 1,
            "bf16 request gave non-finite or out-of-range probabilities")
    require(kernel.kernel_launches - before == 13 * bf16_batches,
            "the bf16 request did not go through the attention kernel")
    print(f"bf16 autocast request: finite, {kernel.kernel_launches - before} kernel "
          f"launches; max|dP| against fp32 "
          f"{float(np.abs(bf16 - results[0][0]).max()):.3e}", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from stcd_tpu_torch.ops import _build, attention

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    gpu_label = smi.splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2: build
    t0 = time.monotonic()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.monotonic() - t0:.1f} s -> {lib_path}", flush=True)

    # phase 3: kernel against plain version
    max_err, ms, plain_ms = phase_kernels(torch, attention)

    # phase 4: serving
    launches = phase_serving(torch, np, attention, gpu_label)

    print(json.dumps({"kernels": [{
        "name": "cross_attention", "route": "cuda",
        "source": "stcd_tpu_torch/ops/csrc/cross_attention.cu",
        "replaces": "stcd_tpu/ops/attention.py:77",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
