#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stcd_tpu_torch) on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from ops/csrc with nvcc.
3. kernels against plain: the SRA attention kernel against its plain
   PyTorch version at the four ChangeFormerV6 SRA shapes of a 16-pair batch
   of 256x256 tiles, plus a ragged shape; f32 and bf16, dropout 0 and 0.1;
   F.scaled_dot_product_attention is timed beside it as a yardstick. Then the
   augmentation kernel against its plain version at the train step's shape
   (128 images of 256x256, uint8 and float32), with every gate on, every
   gate off, a ragged size, and the contrast op first, in the middle and last.
4. serving: the full-width ChangeFormerV6 (seeded random weights) behind the
   micro-batching engine (batch 16, tile 256), driven by concurrent 512x512
   requests. Checks the outputs, that every device batch launched the
   attention kernel 13 times, that the stitched probabilities match the same
   weights run with the plain attention, and that a bf16 request is finite.
5. training: the SegCD stage-2 train step through create_train_state and
   make_cd_steps: ResNet-50 encoder, decoder (256, 128, 64, 32, 16), 256x256
   pairs, batch 64, augmentation on, bf16 autocast, seeded weights and data.
   Checks finite falling losses, moving BatchNorm statistics, the confusion
   counts, and one augmentation kernel launch per step. Then one fp32 step at
   batch 8 with the kernel and one with the plain augmentation on the same
   draws: the same loss and counts.
6. SegCD serving: one round of 512x512 requests through the engine with the
   full-width SegCD.

The last line is one JSON object: {"ok": true, "device": {...}}. The line
before it lists the kernels with their launches, errors, times and bounds.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
ROUNDS = 4  # rounds of 4 concurrent requests; the first one is not timed
SRA_DEPTHS = (3, 3, 4, 3)  # SRA calls per encoder stage
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 64, 3, 10
STEP_LOSS_ATOL = 1e-4  # one fp32 train step, kernel against plain augmentation
STEP_CM_PIXELS = 64  # of 8 x 256 x 256: pixels whose probability sits at the threshold


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


def attention_bound_ms(shape, itemsize: int) -> tuple:
    """(bound_ms, bound_by) of one attention call: q, k, v read and o written
    once over the memory rate, against the two products and the softmax over
    the f32 rate of the CUDA cores (the kernel's math is f32)."""
    b, h, n, m, d = shape
    nbytes = b * h * (2 * n + 2 * m) * d * itemsize
    ops = b * h * n * m * (4 * d + 5)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_kernels(torch, attention):
    import torch.nn.functional as F

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
                if on_path and rate == 0.0:
                    # the one PyTorch call for the same function: a yardstick
                    # timed here, never on the port's path
                    t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                    bound, by = attention_bound_ms((b, h, n, m, d), q.element_size())
                    print(f"attention (B,H,N,M,D)={(b, h, n, m, d)} {name}: "
                          f"F.scaled_dot_product_attention {t_sdpa:.4f} ms; "
                          f"bound {bound:.4f} ms ({by})", flush=True)
                    if dtype == torch.float32:
                        stage_ms[(b, h, n, m, d)] = (t_kernel, t_plain, t_sdpa, bound, by)
    per_batch = [sum(depth * stage_ms[s][i] for depth, s in zip(SRA_DEPTHS, sra_shapes()))
                 for i in range(4)]
    print(f"attention per device batch (13 SRA calls, f32): kernel {per_batch[0]:.4f} ms, "
          f"plain {per_batch[1]:.4f} ms, F.scaled_dot_product_attention "
          f"{per_batch[2]:.4f} ms, bound {per_batch[3]:.4f} ms", flush=True)
    kinds = {stage_ms[s][4] for s in sra_shapes()}
    return {"max_abs_err": max_err, "ms": per_batch[0], "plain_ms": per_batch[1],
            "library_ms": per_batch[2], "bound_ms": per_batch[3],
            "bound_by": kinds.pop() if len(kinds) == 1 else "operations"}


AUG_ATOL = 2e-5  # the JAX kernel's own tolerance against its reference
AUG_BATCH = 128  # A||B of the bs-64 train step
# f32 operations per pixel of each stage of the augmentation (counted from
# data/augment.py: multiplies, adds, divides, compares and selects)
AUG_OPS = {"to_float": 3, "jitter": 9 + 17 + 22 + 75, "gray": 5, "blur": 2 * 11 * 2 * 3,
           "normalize": 6}


def augment_bound_ms(imgs, params) -> tuple:
    """(bound_ms, bound_by) of one augmentation call on these inputs: each
    input read once and the output written once over the memory rate,
    against the operations these flags ask for over the f32 rate."""
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


def phase_augment_kernel(torch):
    """The augmentation kernel against its plain version on the card."""
    from stcd_tpu_torch.data.augment import (eval_preprocess, params_to,
                                             sample_augment_params)
    from stcd_tpu_torch.ops.augment import apply_augment_batch

    gen = torch.Generator(device="cpu").manual_seed(0)

    def images(shape, dtype):
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        return (u8 if dtype == torch.uint8 else u8.float() / 255.0).to("cuda")

    def draws(n, **forced):
        p = params_to(sample_augment_params(gen, n, 0.5), "cuda")
        for key, value in forced.items():
            p[key] = torch.full((n,), value, dtype=torch.bool, device="cuda")
        return p

    def with_contrast_at(p, slot):
        order = [0, 2, 3]
        order.insert(slot, 1)
        return {**p, "perm": torch.tensor(order, device="cuda").expand(len(p["perm"]), 4)
                .contiguous()}

    full = (AUG_BATCH, TILE, TILE, 3)
    on = dict(jitter_apply=True, gray_apply=True, blur_apply=True)
    off = dict(jitter_apply=False, gray_apply=False, blur_apply=False)
    cases = [("train-step shape, uint8", images(full, torch.uint8), draws(AUG_BATCH)),
             ("train-step shape, float32", images(full, torch.float32), draws(AUG_BATCH)),
             ("every gate on", images(full, torch.uint8), draws(AUG_BATCH, **on)),
             ("every gate off", images(full, torch.uint8), draws(AUG_BATCH, **off)),
             ("ragged", images((3, 100, 75, 3), torch.uint8),
              draws(3, jitter_apply=True, blur_apply=True))]
    for slot, where in ((0, "first"), (2, "in the middle"), (3, "last")):
        cases.append((f"contrast {where}", images((4, 100, 75, 3), torch.float32),
                      with_contrast_at(draws(4, jitter_apply=True), slot)))
    max_err, main = 0.0, None
    for name, imgs, params in cases:
        got = apply_augment_batch(imgs, params, impl="kernel")
        again = apply_augment_batch(imgs, params, impl="kernel")
        want = apply_augment_batch(imgs, params, impl="plain")
        torch.cuda.synchronize()
        require(got.shape == imgs.shape and got.dtype == torch.float32,
                f"augment kernel output {got.dtype} {tuple(got.shape)}")
        require(bool(torch.equal(got, again)), f"augment {name}: two runs differ")
        err = (got - want).abs().max().item()
        t_kernel = time_ms(lambda: apply_augment_batch(imgs, params, impl="kernel"))
        t_plain = time_ms(lambda: apply_augment_batch(imgs, params, impl="plain"))
        bound, by = augment_bound_ms(imgs, params)
        print(f"augment {name} {tuple(imgs.shape)}: max|err|={err:.3e} (atol {AUG_ATOL}) "
              f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms bound {bound:.4f} ms "
              f"({by})", flush=True)
        require(err <= AUG_ATOL, f"augment kernel disagrees with plain by {err} ({name})")
        if name == "every gate off":
            off_err = (got - eval_preprocess(imgs)).abs().max().item()
            require(off_err <= 2e-6, f"gates off is not normalize only: {off_err}")
        max_err = max(max_err, err)
        if main is None:
            main = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound, "bound_by": by}
    return {**main, "max_abs_err": max_err}


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
    args = parser.parse_args(["--net_G", "ChangeFormerV6", "--init_seed", "0",
                              "--device", "cuda", "--tile", str(TILE)])
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

    bf16_args = parser.parse_args(["--net_G", "ChangeFormerV6", "--init_seed", "0",
                                   "--device", "cuda", "--tile", str(TILE), "--bf16"])
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


def phase_training(torch, augment_kernel, gpu_label):
    """The SegCD-r50 stage-2 train step at batch 64, then kernel against
    plain augmentation inside one fp32 step. Returns the kernel's launches on
    the bf16 run."""
    from stcd_tpu_torch.data.augment import params_to, sample_pair_params
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps

    def new_state(bf16):
        model = init_weights(SegCD("resnet50", classes=1,
                                   decoder_channels=(256, 128, 64, 32, 16)), seed=0)
        return create_train_state(model, adam_poly(1e-3, 60, 1000), device="cuda",
                                  bf16=bf16)

    train_step, _ = make_cd_steps(augment=True)
    state = new_state(bf16=True)
    data = seeded_cd_batch(TRAIN_BATCH, TILE, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    bn_mean0 = state.model.encoder.bn1.running_mean.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    augment_kernel.kernel_launches = 0
    outs, events = [], []
    for _ in range(TRAIN_WARM + TRAIN_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        outs.append(train_step(state, data, gen))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    launches = augment_kernel.kernel_launches
    n_steps = TRAIN_WARM + TRAIN_STEPS
    losses = [float(o["loss"]) for o in outs]
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall on a fixed batch: {losses}")
    for o in outs:
        require(int(o["cm"].sum()) == TRAIN_BATCH * TILE * TILE,
                f"confusion counts sum to {int(o['cm'].sum())}")
    require(state.step == n_steps, f"{state.step} updates for {n_steps} steps")
    require(launches == n_steps, f"{launches} augment launches for {n_steps} steps")
    moved = (state.model.encoder.bn1.running_mean - bn_mean0).abs().max().item()
    require(moved > 0, "the BatchNorm running means did not move")
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events[TRAIN_WARM:])
    step_ms = times[len(times) // 2]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training: SegCD resnet50 (256,128,64,32,16), batch {TRAIN_BATCH}, "
          f"{TILE}x{TILE}, augment on, bf16 autocast, {n_steps} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; augment kernel launches {launches}",
          flush=True)
    print(f"training on {gpu_label} (a smoke reading, median of {TRAIN_STEPS} steps by "
          f"CUDA events): step {step_ms:.3f} ms; {TRAIN_BATCH / step_ms * 1e3:.2f} "
          f"pairs/s; peak device memory {peak_gib:.2f} GiB", flush=True)
    del state, outs
    torch.cuda.empty_cache()

    # one fp32 step (TF32 is off) from the same init on the same draws, with the
    # kernel and with the plain augmentation
    small = {k: v[:8] for k, v in data.items()}
    draws = tuple(params_to(p, "cuda") for p in
                  sample_pair_params(torch.Generator().manual_seed(3), 8))
    got = {}
    for impl in ("kernel", "plain"):
        out = train_step(new_state(bf16=False), small, aug_params=draws, augment_impl=impl)
        got[impl] = (float(out["loss"]), out["cm"].cpu())
    require(augment_kernel.kernel_launches == launches + 1,
            "the plain-augmentation step launched the kernel")
    d_loss = abs(got["kernel"][0] - got["plain"][0])
    d_cm = int((got["kernel"][1] - got["plain"][1]).abs().sum()) // 2
    print(f"one fp32 train step at batch 8, kernel against plain augmentation: loss "
          f"{got['kernel'][0]:.6f} vs {got['plain'][0]:.6f} (|d|={d_loss:.2e}, atol "
          f"{STEP_LOSS_ATOL}); confusion counts differ in {d_cm} pixels "
          f"(at most {STEP_CM_PIXELS})", flush=True)
    require(d_loss <= STEP_LOSS_ATOL, f"step losses differ by {d_loss}")
    require(d_cm <= STEP_CM_PIXELS, f"confusion counts differ in {d_cm} pixels")
    return launches


def phase_segcd_serving(torch, np):
    """One round of requests through the engine with the full-width SegCD."""
    from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_base_fn
    from stcd_tpu_torch.serving.server import BatchingEngine

    parser = argparse.ArgumentParser()
    add_model_args(parser)
    args = parser.parse_args(["--init_seed", "0", "--device", "cuda", "--tile", str(TILE)])
    require(args.net_G is None and args.encoder == "resnet50", "SegCD is not the default")
    model = build_model(args)
    rng = np.random.default_rng(1)
    scenes = [tuple(rng.uniform(0, 1, (SCENE, SCENE, 3)).astype(np.float32)
                    for _ in range(2)) for _ in range(4)]
    engine = BatchingEngine(make_base_fn(args, model), tile=TILE, batch=BATCH,
                            max_wait_ms=50.0, device="cuda")
    try:
        results = drive(engine, scenes)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    for probs in results:
        require(probs.shape == (SCENE, SCENE, 1), f"probs shape {probs.shape}")
        require(bool(np.isfinite(probs).all()), "non-finite probabilities")
        require(probs.min() >= 0.0 and probs.max() <= 1.0, "probs outside [0, 1]")
    require(stats["requests"] == 4 and stats["errors"] == 0, f"engine stats {stats}")
    print(f"SegCD serving: 4 requests, {stats['tiles']} tiles in {stats['batches']} "
          f"device batches, finite and in [0, 1]; step_ms p50 {stats['step_ms']['p50']}",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from stcd_tpu_torch.ops import _build, attention, augment

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

    # phase 3: kernels against their plain versions
    attn = phase_kernels(torch, attention)
    aug = phase_augment_kernel(torch)

    # phase 4: serving
    attn["launches"] = phase_serving(torch, np, attention, gpu_label)

    # phase 5: training
    aug["launches"] = phase_training(torch, augment.apply_augment_kernel, gpu_label)
    aug["library_ms"] = None  # no single PyTorch call computes this function

    # phase 6: SegCD serving
    phase_segcd_serving(torch, np)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": "cross_attention", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/cross_attention.cu",
         "replaces": "stcd_tpu/ops/attention.py:77", **{k: attn[k] for k in keys}},
        {"name": "augment", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/augment.cu",
         "replaces": "stcd_tpu/ops/augment_kernel.py:44", **{k: aug[k] for k in keys}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
