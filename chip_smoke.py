#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stcd_tpu_torch) on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from ops/csrc with nvcc.
3. kernels against plain: the SRA attention kernel against its plain
   PyTorch version at the four ChangeFormerV6 SRA shapes of a 16-pair batch
   of 256x256 tiles, plus ragged shapes that cross the edges of its three
   variants (M of 1, 8, 9, 255, 257; D of 36, 40, 72, 128; N no multiple of a
   tile; one head); f32 and bf16, dropout 0 and 0.1;
   F.scaled_dot_product_attention is timed beside it as a yardstick. Then the
   augmentation kernel against its plain version at the train step's shape
   (128 images of 256x256, uint8 and float32), with every gate on, every
   gate off, a ragged size, and the contrast op first, in the middle and last;
   two runs bit-identical, the device activities of one call counted by
   torch.profiler (the two launches of augment_plan, no conversion kernel),
   timed as CUDA-graph replays and as events around one eager call.
   Then the attention backward kernel against autograd through the plain
   version at the four SRA shapes of the V6 train step (batch 8 at 512x512,
   M = 256), at BIT's decoder shape (M = 4) and at the ragged shapes, f32 and
   bf16, dropout 0 and 0.1, two runs bit-identical, with the backward of
   F.scaled_dot_product_attention as the yardstick; the forward kernel is
   held against the plain version at these shapes too (output and the rows'
   log-sum-exp) and timed; every on-path kernel, f32 and bf16, must read at or
   above its bound. Then the bn_stats kernel against its plain
   version and a float64 sum at the six SegCD-r50 activation shapes, bf16 and
   f32, and at an odd C and a pointer off a 16-byte boundary: two runs and
   two CUDA-graph replays bit-identical, one CUDA launch a call
   (torch.profiler), two graphs replayed at once on two streams, its VJP against
   autograd, timed as graph replays with torch.batch_norm_stats as the
   yardstick and each shape's share of its bound. Then the four matmul kernels
   (the product alone; with the BatchNorm sums on the CUDA cores; in a row
   decomposition; on the tensor cores) against their plain version and a
   float64 sum of its f32 accumulator, bf16, at the five ResNet-50 bottleneck
   shapes of their tools, three ragged shapes and one of four 256-column
   passes, two runs bit-identical, with torch.matmul as the yardstick; the
   product alone, with the CUDA-core sums and with the tensor-core sums each
   on the route matmul_plan picks (wgmma with TMA wherever TMA can describe
   the operands; the wmma tiles at (333, 37, 91) and N < 64), the row
   decomposition on matmul_stats' route, y bit-equal to matmul_bf16's on the
   wgmma route; timed as CUDA-graph replays.
4. serving: the full-width ChangeFormerV6 (seeded random weights) behind the
   micro-batching engine (batch 16, tile 256), driven by concurrent 512x512
   requests. Checks the outputs, that every device batch launched the
   attention kernel 13 times, that the stitched probabilities match the same
   weights run with the plain attention, and that a bf16 request is finite.
5. training: the SegCD stage-2 train step through create_train_state and
   make_cd_steps (stage_setup of tools/profile_step.py): ResNet-50 encoder,
   decoder (256, 128, 64, 32, 16), 256x256 pairs, batch 64, augmentation on,
   bf16 autocast, seeded weights and data.
   Checks finite falling losses, moving BatchNorm statistics, the confusion
   counts, and one augmentation kernel launch per step. Then one fp32 step at
   batch 8 with the kernel and one with the plain augmentation on the same
   draws: the same loss and counts.
6. SegCD serving: one round of 512x512 requests through the engine with the
   full-width SegCD.
7. ChangeFormerV6 training: CDTrainer.train_step at full width (embed 256),
   512x512 pairs, batch 8, bf16 autocast, AdamW 1e-4, multi-scale
   cross-entropy, dropout live, seeded weights and data. Checks a finite
   falling loss and 13 forward and 13 backward attention launches a step, all
   of the tensor-core variant; then
   one fp32 step with the kernels and one with the plain attention from one
   seed: the same loss. Then the fp32 step (TF32 off, the trainer's default
   precision) at full width and batch 8: 2 warm and 5 timed steps with the
   kernels (13 + 13 launches a step, all f32_cuda) and the same with the plain
   attention; step ms, pairs/s and peak memory of both.
8. BIT training: base_transformer_pos_s4_dd8 with the TrainerConfig defaults
   (sgd, lr 0.01), 256x256 pairs, batch 32, fp32: the same checks with 16
   forward and 16 backward launches a step, all of the M <= 8 variant.
9. stage-1 training: the UnetSeg step (make_seg_steps), ResNet-50 encoder,
   decoder (256, 128, 64, 32, 16), 256x256 images, batch 64, augmentation on,
   bf16 autocast: the checks of phase 5.
10. stage-3 training: the SegCD fine-tune step (make_semi_cd_steps) on 32
   synthesized and 32 real pairs, one forward over 64 pairs: the checks of
   phase 5, the three loss terms finite, one augmentation launch over the 128
   images of a step.
11. the loop: run_training for 2 epochs of 3 seeded batches of 16 pairs at full
   width into a temporary directory; the best model, last_ckpt, a snapshot and
   the scalar log exist, and restore_last gives back the step, the weights
   and the Adam moments.
12. the tools: bench_conv_bn_epilogue and bench_bnstats_diag, the entry points
   of the four matmul kernels, and bench_bnstats, that of bn_stats, through
   their main(); their rows are printed, every matmul_stats launch of
   bench_conv_bn_epilogue and every matmul_bf16, matmul_stats_rows and
   matmul_stats_mma launch of bench_bnstats_diag took the wgmma route, and
   bench_bnstats' bn_stats agrees with its plain version.
13. the pipeline from the command line: cli.pipeline_demo.main, whose first step
   (cli.make_demo_data) writes 16 train and 8 val tiles of 256x256 for WHU-AB and
   LEVIR into a temporary directory, runs stage 1, stage 2, its --select_data and
   --generate_label passes, stage 3 and evaluate, each through its CLI's main, on
   the card at full width (resnet50, decoder (256, 128, 64, 32, 16), bf16, batch 8,
   3 epochs). Requires each stage's best model, last_ckpt and three snapshots, the
   reliable and unreliable id lists, ff_label/ for every train pair, evaluate's
   metrics, reliabilities that are not all equal, every stage's parameters and
   every loader batch on the card with images and labels as uint8, and one
   augmentation kernel launch for each of the 18 train steps. Prints whether the
   native decoder built, the files decoded by path, each step's seconds, each
   stage's images or samples per second by epoch, and the loader's decode rate.
14. cli.train_cd at full width: ChangeFormerV6 (embed 256), 256x256, batch 8,
   fp32, --augment, synthetic data, 2 epochs of 2 steps; then --eval_only; then
   a third epoch that resumes at epoch 2; then one epoch of the default
   base_transformer_pos_s4_dd8. Requires 13 forward and 13 backward f32_cuda
   attention launches and one augmentation launch a train step (13 forward
   launches an eval batch; BIT: 16 small_m), a finite loss, best_ckpt,
   last_ckpt, both curves and the masks in vis_dir.
15. ChangeFormer V1-V5 at their published widths (V5 embed 256): one fp32 eval
   forward of 8 pairs of 256x256 tiles each, P(changed) with the kernel against
   the plain attention within PROBS_ATOL, 16 (V1-V3), 25 (V4) or 28 (V5) f32_cuda
   launches a forward; one fp32 CDTrainer step each with as many backward
   launches. The attention kernels are held to their plain versions at V4's and
   V5's new (B, H, N, M, D) shapes in phase 3's backward check (forward and
   backward, f32 and bf16, dropout 0 and 0.1).
16. int8 on phase 13's SegCD-r50: cli.evaluate --int8 against the float
   evaluation of phase 13 (F1 within INT8_F1_TOL, the JAX gate), the float and
   int8 ms of one batch, cli.predict --int8 writing a mask, and cli.serve --int8
   --calib_dir answering requests in a subprocess.
17. cli.export_model: SegCD-r50 of phase 13 (the default export), ChangeFormerV6
   at embed 256 (the serving forward) and SegCD --int8 --calib_npz, each written,
   loaded back and held against the eager forward within EXPORT_ATOL; the loaded
   V6 program launches the attention kernel 13 times a call.
18. the rest of the define_G zoo: Unet, SiamUnet_sub/_abs/_conc/_cross_conc, SNUNet,
   DTCDSCN, IFNet, ChangeGNNV1, ChangeGNNV2, ChangeGNNV2_sub/_abs/_conc and GNN at the
   widths of the JAX CLI defaults (embed_dim 64; the ViG encoder 80/160/400/640):
   each through CDTrainer (sgd 0.01, ce; IFNet bce with n_class 1), fp32, augment
   on, 6 steps of 8 pairs of 256x256 tiles (finite losses, one augmentation call a
   step, the median ms of the last 5 and the peak memory), and one eval forward of 2 pairs on
   the card against the same weights on the CPU within ZOO_ATOL (the ViG keys on the
   card's KNN indices, with ZOO_NEIGHBOUR_SHARE of the CPU's own equal to them); then
   cli.train_cd --augment and cli.predict --load_path for SNUNet and ChangeGNNV2.

The last line is one JSON object: {"ok": true, "device": {...}}. The line
before it lists the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

F32_ATOL = 2e-5  # summation order and expf against the plain f32 softmax
# bf16 outputs, times max(1, max |plain|): one bf16 ulp is 2^-8 to 2^-7 of the value, so
# 1e-2 of the largest output covers one ulp anywhere. The tensor-core variant rounds p to
# bf16 before p v, which moves the f32 result by at most 2^-9 sum_j p_j |v_j| (half an
# ulp of an output of that size): the kernel's and the plain version's bf16 outputs then
# differ by at most one ulp, where before they differed in the f32 summation order only
BF16_ATOL = 1e-2
PROBS_ATOL = 1e-3  # stitched P(changed), kernel against plain attention
BATCH, TILE, SCENE = 16, 256, 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
ROUNDS = 4  # rounds of 4 concurrent requests; the first one is not timed
SRA_DEPTHS = (3, 3, 4, 3)  # SRA calls per encoder stage
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 64, 3, 10
LOOP_BATCH, LOOP_BATCHES = 16, 3  # the epoch loop: pairs a batch, batches an epoch
STEP_LOSS_ATOL = 1e-4  # one fp32 train step, kernel against plain augmentation
STEP_CM_PIXELS = 64  # of 8 x 256 x 256: pixels whose probability sits at the threshold
# backward, max |kernel - plain| <= atol * max(1, max |plain|) on dq, dk, dv: dk and dv
# are sums over up to 16384 rows and reach 100 at BIT's shape, so the bound scales
BWD_F32_ATOL = 2e-5  # summation order of the products and of the sum over Q tiles
BWD_BF16_ATOL = 2e-2  # bf16 roundings of g, of the saved output and of the result
# the forward at the training shapes, max |kernel - plain| <= F32_ATOL or BF16_ATOL times
# max(1, max |plain|): over M = 4 keys an output reaches 4, where one bf16 ulp is 1.6e-2
LSE_ATOL = 2e-5  # rows' log-sum-exp (about 6, f32 whatever the inputs) against torch.logsumexp
BN_REL_TOL = 1e-5  # bn_stats against a float64 sum, relative to max(1, |sum|)
V6_TRAIN = dict(batch=8, size=512, warm=2, steps=10, launches=13, variant="mma_bf16")
V6_FP32_TRAIN = dict(batch=8, size=512, warm=2, steps=5, launches=13)
BIT_TRAIN = dict(batch=32, size=256, warm=2, steps=10, launches=16, variant="small_m")
ATTN_STEP_LOSS_ATOL = 1e-4  # one fp32 train step, kernels against plain attention
BIT_SHAPE = (32, 8, 4096, 4, 64)  # (B, H, N, M, D) of one decoder block at batch 32
BIT_SCALE = 32 ** -0.5  # BIT scales by the model dim, not the head dim
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# (B, H, N, M, D) across the edges of the attention variants: M = 8 | 9 (small_m |
# tensor cores or f32), one key, M = 255 | 257 around the 256 keys of a backward pass,
# D with and without whole 16-byte pieces and whole 16-column k-steps, N no multiple of
# a tile, a single head. Held to atol x max(1, max |plain|), as the training shapes are.
RAGGED_SHAPES = ((1, 1, 77, 9, 36), (2, 2, 333, 1, 40), (2, 1, 300, 8, 128),
                 (2, 1, 200, 255, 40), (1, 2, 130, 257, 72), (1, 1, 260, 300, 128))
# the four matmul kernels, bf16 operands: y against the plain version within one bf16
# ulp of the largest output (the two sum K products in another order, so an f32
# accumulator at a rounding boundary may fall to either side)
MM_Y_ATOL = 1e-2  # times max(1, max |plain|)
# their sums against a float64 sum of the plain f32 accumulator, on BatchNorm's scales
# (|d mean| / std, |d var| / var): f32 sums over up to 524288 rows in tiles of 128
MM_BN_TOL = 1e-4
MM_RAGGED = (1000, 72, 200)  # no dimension a multiple of its tile; K, N multiples of 8
MM_RAGGED_ODD = (333, 37, 91)  # nothing a multiple of 8: the element-wise loads and stores
MM_NARROW = (1000, 72, 56)  # N < 64: the wmma tiles with 16-byte loads and stores
MM_WIDE = (4096, 64, 1024)  # four 256-column passes a group with the CUDA-core sums
BN_SHAPES = ((128, 64, 64, 256), (128, 128, 128, 64), (128, 32, 32, 512),
             (128, 16, 16, 1024), (128, 256, 256, 16), (128, 128, 128, 32))
# 1-channel loads: an odd C, and a C of whole 16 bytes at a pointer off a 16-byte boundary
BN_ODD_SHAPES = ((1001, 3), (7, 13, 24))


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


def time_ms(fn, runs: int = 20, graph: bool = False) -> float:
    """Median over ``runs`` launches, each timed with CUDA events. With
    ``graph`` the call is captured once into a CUDA graph and the replays are
    timed (tools/bench_kernels.py's graph_ms): a kernel of a few tens of
    microseconds is then not timed by the host's pace of launching it."""
    import torch
    if graph:
        from stcd_tpu_torch.tools.bench_kernels import graph_ms
        return graph_ms(torch, fn, runs)
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


PROFILE_TRIES = 3  # profiler windows tried before a call counts as having no device activity


def device_events(fn, runs: int):
    """The device events (kernels, copies, fills) of ``runs`` calls of ``fn``,
    from torch.profiler, after warm-up calls. The profiler there at times
    records no device activity at all for a window; such a window is taken
    again, at most PROFILE_TRIES times, and the call fails if none records any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events
        print(f"torch.profiler recorded no device activity in a window of {runs} calls; "
              f"taking it again", flush=True)
    raise RuntimeError(f"torch.profiler saw no device activity in {PROFILE_TRIES} windows")


def profiled_ms(fn, runs: int = 10) -> float:
    """Device time of one call, from torch.profiler: the kernels' time summed
    over ``runs`` calls. For a call that goes through the autograd engine, which
    a CUDA graph cannot capture apart from its forward."""
    total_us = sum(e.device_time_total for e in device_events(fn, runs))
    require(total_us > 0, "torch.profiler saw no device time")
    return total_us / runs / 1e3


def device_launches(fn) -> list:
    """The names of the device activities (kernels, copies, fills) that one call
    of ``fn`` starts, from torch.profiler."""
    return [e.name for e in device_events(fn, 1)]


def _attention_bound(shape, dtype, rows_moved, products, softmax_ops) -> tuple:
    """(bound_ms, bound_by): ``rows_moved`` rows of D values of ``dtype`` over
    the memory rate, against ``products`` and ``softmax_ops`` operations per
    (row, key) pair. float32: both at the f32 rate of the CUDA cores. bfloat16:
    the products at the dense bf16 tensor-core rate, the softmax at the f32 rate."""
    import torch
    b, h, n, m, d = shape
    by_bytes = b * h * rows_moved * d * dtype.itemsize / HBM_BYTES_PER_S * 1e3
    product_rate = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    by_ops = b * h * n * m * (products * d / product_rate + softmax_ops / F32_FLOPS) * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attention_bound_ms(shape, dtype) -> tuple:
    """(bound_ms, bound_by) of one attention call: q, k, v read and o written
    once, against the two products (4 N M D) and the softmax (5 N M)."""
    _, _, n, m, _ = shape
    return _attention_bound(shape, dtype, 2 * n + 2 * m, 4, 5)


def phase_kernels(torch, attention):
    import torch.nn.functional as F

    cross_attention = attention.cross_attention
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(shape, True, False) for shape in sra_shapes()]
    cases += [((2, 2, 1000, 37, 80), False, False)]
    cases += [(shape, False, True) for shape in RAGGED_SHAPES]
    max_err = 0.0
    stage_ms = {}
    for (b, h, n, m, d), on_path, scaled in cases:
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
                relative = scaled or dtype == torch.bfloat16
                bound = atol * (max(1.0, want.float().abs().max().item()) if relative else 1.0)
                t_kernel = time_ms(lambda: run("kernel"), graph=True)
                t_plain = time_ms(lambda: run("plain"), graph=True)
                name = str(dtype).replace("torch.", "")
                print(f"attention (B,H,N,M,D)={(b, h, n, m, d)} {name} dropout={rate} "
                      f"[{attention.select_variant(dtype, m)}]: max|err|={err:.3e} "
                      f"(atol {atol}{' x max(1, max|plain|)' if relative else ''}) kernel "
                      f"{t_kernel:.4f} ms plain {t_plain:.4f} ms", flush=True)
                require(err <= bound, f"kernel disagrees with plain by {err} > {bound}")
                max_err = max(max_err, err)
                if on_path and rate == 0.0:
                    # the one PyTorch call for the same function: a yardstick
                    # timed here, never on the port's path
                    t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                     graph=True)
                    bound, by = attention_bound_ms((b, h, n, m, d), dtype)
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


def phase_augment_kernel(torch):
    """The augmentation kernel against its plain version on the card."""
    from stcd_tpu_torch.data.augment import (eval_preprocess, params_to,
                                             sample_augment_params)
    from stcd_tpu_torch.ops.augment import apply_augment_batch, augment_plan
    from stcd_tpu_torch.tools.bench_kernels import augment_bound_ms

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
        # the device activities of one call: the wrapper's conversions would show here
        names = device_launches(lambda: apply_augment_batch(imgs, params, impl="kernel"))
        require(len(names) == augment_plan(*imgs.shape[:3])["launches"],
                f"augment {name}: one call started {len(names)} device activities {names}")
        # CUDA-graph replays, and events around one eager call (the wrapper's host time
        # included), the way the parent's time was taken
        t_kernel = time_ms(lambda: apply_augment_batch(imgs, params, impl="kernel"), graph=True)
        t_eager = time_ms(lambda: apply_augment_batch(imgs, params, impl="kernel"))
        t_plain = time_ms(lambda: apply_augment_batch(imgs, params, impl="plain"))
        bound, by = augment_bound_ms(imgs, params)
        print(f"augment {name} {tuple(imgs.shape)}: max|err|={err:.3e} (atol {AUG_ATOL}) "
              f"kernel {t_kernel:.4f} ms (graph replay; eager, event-timed {t_eager:.4f} ms) "
              f"plain {t_plain:.4f} ms bound {bound:.4f} ms ({by}); CUDA launches per call "
              f"{len(names)}: {names}", flush=True)
        require(err <= AUG_ATOL, f"augment kernel disagrees with plain by {err} ({name})")
        if name == "every gate off":
            off_err = (got - eval_preprocess(imgs)).abs().max().item()
            require(off_err <= 2e-6, f"gates off is not normalize only: {off_err}")
        max_err = max(max_err, err)
        if main is None:
            main = {"ms": t_kernel, "eager_ms": t_eager, "plain_ms": t_plain, "bound_ms": bound,
                    "bound_by": by, "cuda_launches_per_call": len(names)}
    return {**main, "max_abs_err": max_err}


def attention_bwd_bound_ms(shape, dtype) -> tuple:
    """(bound_ms, bound_by) of one attention backward: q, k, v, g read and
    dq, dk, dv written once, against five products (10 N M D) and the softmax
    and its transpose (8 N M)."""
    _, _, n, m, _ = shape
    return _attention_bound(shape, dtype, 3 * n + 4 * m, 10, 8)


def phase_attention_backward(torch, attention):
    """The backward kernel against autograd through the plain version, and the
    forward kernel at the training shapes: its output against the plain
    version, its log-sum-exp against torch.logsumexp of the plain scores, and
    its times. ``fwd_max_abs_err`` in the result is the forward's."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cpu").manual_seed(5)
    v6 = sra_shapes(V6_TRAIN["batch"], V6_TRAIN["size"])
    cases = [(shape, None, True) for shape in v6] + [(BIT_SHAPE, BIT_SCALE, True)]
    cases += [(shape, None, False) for shape in RAGGED_SHAPES + ((2, 2, 1000, 37, 80),)
              + CF_NEW_SHAPES]
    max_err = fwd_max_err = 0.0
    table = {}
    for (b, h, n, m, d), scale, on_path in cases:
        scale = d ** -0.5 if scale is None else scale
        for dtype, atol, fwd_atol in ((torch.float32, BWD_F32_ATOL, F32_ATOL),
                                      (torch.bfloat16, BWD_BF16_ATOL, BF16_ATOL)):
            q, k, v, g = (torch.randn(b, h, rows, d, generator=gen).to("cuda", dtype)
                          for rows in (n, m, m, n))
            name = str(dtype).replace("torch.", "")
            for rate in (0.0, 0.1):
                seed = 4321 if rate else None

                def graph(impl):
                    leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
                    out = attention.cross_attention(*leaves, scale=scale, dropout_rate=rate,
                                                    dropout_seed=seed, impl=impl)
                    return out, leaves

                def run(impl):
                    out, leaves = graph(impl)
                    return out.detach(), torch.autograd.grad(out, leaves, g)

                (out, got), (_, again), (out_plain, want) = (run("kernel"), run("kernel"),
                                                             run("plain"))
                # the forward kernel at this shape: its output and the rows' log-sum-exp
                # that it hands to the backward
                out, lse = attention.launch_forward(q, k, v, scale, rate, seed, want_lse=True)
                lse_plain = torch.logsumexp(torch.einsum(
                    "bhnd,bhmd->bhnm", q.float(), k.float()) * scale, dim=-1)
                torch.cuda.synchronize()
                require(out.dtype == dtype and out.shape == q.shape,
                        f"forward output {out.dtype} {tuple(out.shape)}")
                fwd_err = (out.float() - out_plain.float()).abs().max().item()
                fwd_bound = fwd_atol * max(1.0, out_plain.float().abs().max().item())
                require(fwd_err <= fwd_bound, f"forward disagrees with plain by {fwd_err} > "
                        f"{fwd_bound} at {(b, h, n, m, d)} {name} dropout={rate}")
                lse_err = (lse - lse_plain).abs().max().item()
                require(lse.shape == (b, h, n) and lse_err <= LSE_ATOL,
                        f"log-sum-exp disagrees with torch.logsumexp by {lse_err} > "
                        f"{LSE_ATOL} at {(b, h, n, m, d)} {name}")
                fwd_max_err = max(fwd_max_err, fwd_err, lse_err)
                for which, a, c, w in zip(("dq", "dk", "dv"), got, again, want):
                    require(a.dtype == dtype and a.shape == w.shape,
                            f"{which} is {a.dtype} {tuple(a.shape)}")
                    require(bool(torch.equal(a, c)), f"{which}: two backward runs differ")
                    err = (a.float() - w.float()).abs().max().item()
                    bound = atol * max(1.0, w.float().abs().max().item())
                    require(err <= bound, f"{which} disagrees with autograd through the "
                            f"plain version by {err} > {bound} at {(b, h, n, m, d)} {name}")
                    max_err = max(max_err, err)
                errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
                # the backward kernel through its wrapper, replayed from a CUDA graph; the
                # plain version's backward is autograd's: device time from the profiler
                times = {"kernel": time_ms(lambda: attention.launch_backward(
                    q, k, v, out, lse, g, scale, rate, seed), runs=10, graph=True)}
                del out, out_plain, lse, lse_plain
                if on_path:
                    plain_out, leaves = graph("plain")
                    times["plain"] = profiled_ms(lambda: torch.autograd.grad(
                        plain_out, leaves, g, retain_graph=True))
                    del plain_out, leaves
                t_fwd = time_ms(lambda: attention.cross_attention(
                    q, k, v, scale=scale, dropout_rate=rate, dropout_seed=seed), runs=10,
                    graph=True)
                print(f"attention backward (B,H,N,M,D)={(b, h, n, m, d)} {name} "
                      f"dropout={rate} [{attention.select_variant(dtype, m)}]: max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
                      f"{errs[2]:.3e} (atol {atol} x max(1, max|plain|)), two runs "
                      f"identical; forward output {fwd_err:.3e} (atol {fwd_atol} x "
                      f"max(1, max|plain|)), log-sum-exp {lse_err:.3e} (atol {LSE_ATOL}); "
                      f"kernel {times['kernel']:.4f} ms"
                      + (f" plain {times['plain']:.4f} ms" if on_path else "")
                      + f"; forward kernel {t_fwd:.4f} ms", flush=True)
                row = {"ms": times["kernel"], "plain_ms": times.get("plain"), "fwd_ms": t_fwd}
                if rate == 0.0 and on_path:
                    # the one PyTorch call for the same function: a yardstick
                    # timed here, never on the port's path
                    leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
                    out = F.scaled_dot_product_attention(*leaves, scale=scale)
                    row["library_ms"] = profiled_ms(lambda: torch.autograd.grad(
                        out, leaves, g, retain_graph=True))
                    t_plain_fwd = time_ms(lambda: attention.cross_attention(
                        q, k, v, scale=scale, impl="plain"), runs=10, graph=True)
                    t_sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=scale), runs=10, graph=True)
                    del out, leaves
                    bound, by = attention_bwd_bound_ms((b, h, n, m, d), dtype)
                    fbound, fby = attention_bound_ms((b, h, n, m, d), dtype)
                    row.update(bound_ms=bound, bound_by=by, fwd_bound_ms=fbound,
                               fwd_plain_ms=t_plain_fwd, fwd_library_ms=t_sdpa_fwd)
                    require(row["ms"] >= bound and t_fwd >= fbound,
                            f"a {name} kernel reads above its bound at {(b, h, n, m, d)}: "
                            f"backward {row['ms']} ms against {bound}, forward {t_fwd} against "
                            f"{fbound}")
                    print(f"attention backward (B,H,N,M,D)={(b, h, n, m, d)} {name}: "
                          f"backward of F.scaled_dot_product_attention "
                          f"{row['library_ms']:.4f} ms; bound {bound:.4f} ms ({by}); "
                          f"forward: plain {t_plain_fwd:.4f} ms, "
                          f"F.scaled_dot_product_attention {t_sdpa_fwd:.4f} ms, bound "
                          f"{fbound:.4f} ms ({fby})", flush=True)
                table[((b, h, n, m, d), name, rate)] = row
            del q, k, v, g
            torch.cuda.empty_cache()

    # one V6 train step is 3/3/4/3 backward launches with dropout 0.1, in bf16 under
    # autocast or in f32 (the trainer's default precision)
    def per_step(key, rate, dtype="bfloat16"):
        return sum(depth * table[(s, dtype, rate)][key]
                   for depth, s in zip(SRA_DEPTHS, v6))

    kinds = {table[(s, "bfloat16", 0.0)]["bound_by"] for s in v6}
    bit = table[(BIT_SHAPE, "float32", 0.0)]
    bit_calls = BIT_TRAIN["launches"]
    res = {"max_abs_err": max_err, "fwd_max_abs_err": fwd_max_err,
           "ms": per_step("ms", 0.1),
           "plain_ms": per_step("plain_ms", 0.1), "library_ms": per_step("library_ms", 0.0),
           "bound_ms": per_step("bound_ms", 0.0),
           "bound_by": kinds.pop() if len(kinds) == 1 else "operations",
           # a step's launches at their shapes: V6 in bf16 with dropout 0.1, BIT in f32
           "ms_by_path": {"bf16_v6_train_step": per_step("ms", 0.1),
                          "fp32_v6_train_step": per_step("ms", 0.1, "float32"),
                          "bit_step": bit_calls * bit["ms"]},
           "fwd_ms_by_path": {"bf16_v6_train_step": per_step("fwd_ms", 0.1),
                              "fp32_v6_train_step": per_step("fwd_ms", 0.1, "float32"),
                              "bit_step": bit_calls * bit["fwd_ms"]},
           "f32_v6_shapes": [{"shape": list(s), **{k: table[(s, "float32", 0.0)][k] for k in
                                                   ("ms", "plain_ms", "library_ms", "bound_ms")}}
                             for s in v6]}
    print(f"attention backward per V6 train step (13 launches, bf16, dropout 0.1): kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, backward of "
          f"F.scaled_dot_product_attention (dropout 0) {res['library_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms; forward kernel {per_step('fwd_ms', 0.1):.4f} ms "
          f"(dropout 0: {per_step('fwd_ms', 0.0):.4f} ms, plain "
          f"{per_step('fwd_plain_ms', 0.0):.4f} ms, F.scaled_dot_product_attention "
          f"{per_step('fwd_library_ms', 0.0):.4f} ms, bound {per_step('fwd_bound_ms', 0.0):.4f} "
          f"ms)", flush=True)
    print(f"attention backward per fp32 V6 train step (13 launches, f32_cuda, dropout 0.1): "
          f"kernel {per_step('ms', 0.1, 'float32'):.4f} ms, plain "
          f"{per_step('plain_ms', 0.1, 'float32'):.4f} ms; dropout 0: kernel "
          f"{per_step('ms', 0.0, 'float32'):.4f} ms, backward of "
          f"F.scaled_dot_product_attention {per_step('library_ms', 0.0, 'float32'):.4f} ms, "
          f"bound {per_step('bound_ms', 0.0, 'float32'):.4f} ms", flush=True)
    print(f"attention per BIT train step ({bit_calls} + {bit_calls} launches, f32, M = 4): "
          f"forward kernel {bit_calls * bit['fwd_ms']:.4f} ms (plain "
          f"{bit_calls * bit['fwd_plain_ms']:.4f}, bound "
          f"{bit_calls * bit['fwd_bound_ms']:.4f}), backward kernel "
          f"{bit_calls * bit['ms']:.4f} ms (plain {bit_calls * bit['plain_ms']:.4f}, "
          f"bound {bit_calls * bit['bound_ms']:.4f})", flush=True)
    return res


def bn_rel_err(got, want) -> float:
    """The largest of |got - want| / max(1, |want|) over the two sums."""
    return max(((g.double() - w).abs() / w.abs().clamp_min(1.0)).max().item()
               for g, w in zip(got, want))


def phase_bn_stats(torch):
    """The bn_stats kernel against its plain version and a float64 sum, at the
    six SegCD-r50 shapes in bf16 and f32 and at two shapes that take 1-channel
    loads (an odd C; a pointer off a 16-byte boundary): two runs and two
    replays of a CUDA graph bit-identical, one CUDA launch a call, timed as
    graph replays beside the plain version and torch.batch_norm_stats; two
    graphs replayed at once on two streams; then its VJP against autograd."""
    from stcd_tpu_torch.ops.bn_stats import bn_stats, bn_stats_plan

    gen = torch.Generator(device="cpu").manual_seed(6)
    max_err = 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by_shape = []
    f32_total = {"ms": 0.0, "bound_ms": 0.0}
    cases = [(shape, dtype, 0) for shape in BN_SHAPES for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, dtype, 1) for shape in BN_ODD_SHAPES
              for dtype in (torch.bfloat16, torch.float32)]
    for shape, dtype, offset in cases:
        base = torch.randn(shape, generator=gen) * 2.0 + 0.5
        n = base.numel()
        flat = torch.empty(n + offset, dtype=dtype, device="cuda")
        x = flat[offset:].view(shape)  # offset 1: off a 16-byte boundary
        x.copy_(base.to("cuda", dtype))
        c = shape[-1]
        plan = bn_stats_plan(n // c, c, x.element_size(), x.data_ptr() % 16 == 0)
        require(offset == 0 or plan["vec"] == 1, f"bn_stats {shape}: vec {plan['vec']}")
        got, again = bn_stats(x), bn_stats(x)
        plain = bn_stats(x, impl="plain")
        x64 = x.reshape(-1, c).double()
        want = (x64.sum(0), (x64 * x64).sum(0))
        del x64
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            captured = bn_stats(x)
        replays = []
        for _ in range(2):
            graph.replay()
            replays.append([t.clone() for t in captured])
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, again)):
            require(a.dtype == torch.float32 and a.shape == (c,),
                    f"bn_stats output {a.dtype} {tuple(a.shape)}")
            require(bool(torch.equal(a, b)), f"bn_stats {shape}: two runs differ")
            require(all(torch.equal(a, r[i]) for r in replays),
                    f"bn_stats {shape}: a graph replay differs from the eager call")
        del graph, captured, replays
        err, plain_err = bn_rel_err(got, want), bn_rel_err(plain, want)
        launches = device_launches(lambda: bn_stats(x))
        require(len(launches) == 1, f"bn_stats {shape}: one call launched {launches}")
        t_kernel = time_ms(lambda: bn_stats(x), graph=True)
        t_plain = time_ms(lambda: bn_stats(x, impl="plain"), graph=True)
        # the one PyTorch call that computes BatchNorm's statistics: a yardstick
        nchw = (x if x.dim() == 4 else x.reshape(1, 1, -1, c)).permute(0, 3, 1, 2)
        t_lib = time_ms(lambda: torch.batch_norm_stats(nchw, 1e-5), graph=True)
        bound = (n * x.element_size() + 8 * c) / HBM_BYTES_PER_S * 1e3
        name = str(dtype).replace("torch.", "")
        print(f"bn_stats {shape} {name}{' (off a 16-byte boundary)' if offset else ''}: "
              f"{plan['scheme']} vec {plan['vec']} blocks {plan['blocks']} x "
              f"{plan['col_tiles']}; rel err against float64 {err:.3e} (tol {BN_REL_TOL}; "
              f"plain {plain_err:.3e}); two runs and two graph replays bit-identical; one "
              f"launch ({launches[0][:40]}); kernel {t_kernel:.4f} ms "
              f"({100 * bound / t_kernel:.0f} % of the bound), plain {t_plain:.4f} ms, "
              f"torch.batch_norm_stats {t_lib:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
        require(err <= BN_REL_TOL, f"bn_stats is off by {err} at {shape}")
        max_err = max(max_err, err)
        by_shape.append({"shape": list(shape), "dtype": name, "aligned": not offset,
                         "vec": plan["vec"], "blocks": plan["blocks"],
                         "scheme": plan["scheme"], "bytes_in_flight": plan["bytes_in_flight"],
                         "ms": t_kernel,
                         "plain_ms": t_plain, "library_ms": t_lib, "bound_ms": bound})
        if dtype == torch.float32 and not offset:
            f32_total["ms"] += t_kernel
            f32_total["bound_ms"] += bound
        if dtype == torch.bfloat16 and not offset:  # what a bf16 SegCD step would hand it
            for key, t in (("ms", t_kernel), ("plain_ms", t_plain), ("library_ms", t_lib),
                           ("bound_ms", bound)):
                total[key] += t
        del x, flat, got, again, plain, want
        torch.cuda.empty_cache()

    # two graphs, both captured on the shared capture stream, replayed at once on
    # two streams: each captured call has tickets of its own
    xs = [torch.randn(shape, generator=gen).to("cuda", torch.bfloat16) for shape in BN_SHAPES[2:4]]
    eager = [bn_stats(x) for x in xs]
    graphs, outs = [], []
    torch.cuda.synchronize()
    for x in xs:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append(bn_stats(x))
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    for _ in range(100):
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
    torch.cuda.synchronize()
    overlapped = all(torch.equal(o, e) for out, want in zip(outs, eager) for o, e in zip(out, want))
    after = all(torch.equal(o, e) for x, want in zip(xs, eager) for o, e in zip(bn_stats(x), want))
    print(f"bn_stats: two graphs at {BN_SHAPES[2:4]} replayed 100 times at once on two streams "
          f"give the eager sums bit for bit: {overlapped}; eager calls after them: {after}",
          flush=True)
    require(overlapped and after, "bn_stats: graphs replayed at once on two streams differ")
    del xs, eager, graphs, outs

    # the VJP, dx = g_sum + 2 x g_sumsq, against autograd through the plain version
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)):
        x = (torch.randn(BN_SHAPES[2], generator=gen)).to("cuda", dtype)
        w1, w2 = (torch.randn(x.shape[-1], generator=gen).to("cuda") for _ in range(2))
        dx = []
        for impl in ("kernel", "plain"):
            leaf = x.clone().requires_grad_()
            s1, s2 = bn_stats(leaf, impl=impl)
            dx.append(torch.autograd.grad((s1 * w1).sum() + (s2 * w2).sum(), leaf)[0])
        err = ((dx[0].float() - dx[1].float()).abs()
               / dx[1].float().abs().clamp_min(1.0)).max().item()
        print(f"bn_stats VJP {BN_SHAPES[2]} {str(dtype).replace('torch.', '')}: rel err "
              f"against autograd of the plain version {err:.3e} (tol {tol:.1e})", flush=True)
        require(dx[0].dtype == dtype and err <= tol, f"bn_stats VJP is off by {err}")
    print(f"bn_stats over the six SegCD-r50 shapes in bf16: kernel {total['ms']:.4f} ms "
          f"({100 * total['bound_ms'] / total['ms']:.0f} % of the bound), "
          f"plain {total['plain_ms']:.4f} ms, torch.batch_norm_stats "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (graph replays); "
          f"in f32: kernel {f32_total['ms']:.4f} ms, bound {f32_total['bound_ms']:.4f} ms",
          flush=True)
    return {**total, "max_abs_err": max_err, "bound_by": "bytes",
            "scheme": ", ".join(sorted({r["scheme"] for r in by_shape})),
            "f32_ms": f32_total["ms"], "f32_bound_ms": f32_total["bound_ms"],
            "by_shape": by_shape}


def matmul_bound_ms(m: int, k: int, n: int, stats: bool) -> tuple:
    """(bound_ms, bound_by) of one product: x, w read and y (and the two f32[N]
    sums) written once over the memory rate, against 2 M K N operations over the
    dense bf16 tensor-core rate."""
    nbytes = 2 * (m * k + k * n + m * n) + (8 * n if stats else 0)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * m * k * n / BF16_TENSOR_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_matmul_stats(torch):
    """The four matmul kernels against their plain version and a float64 sum
    of the plain f32 accumulator, at the shapes their tools run and four other
    ones. Returns {function name: result}."""
    from stcd_tpu_torch.ops import matmul_stats as ops
    from stcd_tpu_torch.tools import bench_bnstats_diag, bench_conv_bn_epilogue

    kernels = {"matmul_stats": (ops.matmul_stats, bench_conv_bn_epilogue.SHAPES),
               "matmul_bf16": (ops.matmul_bf16, bench_bnstats_diag.SHAPES),
               "matmul_stats_rows": (ops.matmul_stats_rows, bench_bnstats_diag.SHAPES),
               "matmul_stats_mma": (ops.matmul_stats_mma, bench_bnstats_diag.SHAPES)}
    # each function's counter of launches by route, and its plan
    routed = {name: (wrapper, functools.partial(ops.matmul_plan, epilogue=epilogue))
              for name, wrapper, epilogue in (
                  ("matmul_stats", ops.matmul_stats_kernel, "cuda_cores"),
                  ("matmul_bf16", ops.matmul_bf16_kernel, "none"),
                  ("matmul_stats_rows", ops.matmul_stats_rows_kernel, "cuda_cores"),
                  ("matmul_stats_mma", ops.matmul_stats_mma_kernel, "tensor_cores"))}
    res = {name: {"max_abs_err": 0.0, "max_bn_scaled_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": 0.0 if name == "matmul_bf16" else None,
                  "bound_by": set(), "routes_checked": {}} for name in kernels}
    cases = [(shape, True) for shape in bench_conv_bn_epilogue.SHAPES]
    cases += [(MM_RAGGED, False), (MM_RAGGED_ODD, False), (MM_NARROW, False), (MM_WIDE, False)]
    for (m, k, n), on_path in cases:
        x, w = bench_conv_bn_epilogue.operands(m, k, n, torch.device("cuda"), seed=7)
        y_plain, _, _ = ops.matmul_stats(x, w, impl="plain")
        acc = (x.float() @ w.float()).double()  # the plain version's f32 accumulator
        want = (acc.sum(0), (acc * acc).sum(0))
        del acc
        mean = want[0] / m
        var = (want[1] / m - mean ** 2).clamp_min(1e-6)
        y_scale = max(1.0, y_plain.float().abs().max().item())
        t_lib = time_ms(lambda: torch.matmul(x, w), graph=True) if on_path else None
        y_product = ops.matmul_bf16(x, w, impl="kernel")
        for name, (fn, shapes) in kernels.items():
            stats = name != "matmul_bf16"
            timed = on_path and (m, k, n) in shapes
            wrapper, plan = routed[name]
            routes = dict(wrapper.routes)
            route = plan(m, k, n, aligned=True)["route"]
            got, again = fn(x, w, impl="kernel"), fn(x, w, impl="kernel")
            torch.cuda.synchronize()
            r = res[name]
            # both launches on the route that the plan picks
            took = {key: count - routes.get(key, 0) for key, count in wrapper.routes.items()
                    if count != routes.get(key, 0)}
            require(took == {route: 2}, f"{name} {(m, k, n)}: routes {took}, expected {route}")
            r["routes_checked"][route] = r["routes_checked"].get(route, 0) + 1
            y = got[0] if stats else got
            if route == "wgmma_tma":  # one kernel: the sums do not touch y
                require(bool(torch.equal(y, y_product)), f"{name} {(m, k, n)}: y is not "
                        f"matmul_bf16's")
            require(y.dtype == torch.bfloat16 and y.shape == (m, n),
                    f"{name} output {y.dtype} {tuple(y.shape)}")
            for a, c in zip(got if stats else (got,), again if stats else (again,)):
                require(bool(torch.equal(a, c)), f"{name} {(m, k, n)}: two runs differ")
            y_err = (y.float() - y_plain.float()).abs().max().item()
            require(y_err <= MM_Y_ATOL * y_scale, f"{name} {(m, k, n)}: y is off by {y_err} > "
                    f"{MM_Y_ATOL} x {y_scale}")
            bn_err = 0.0
            if stats:
                require(got[1].dtype == torch.float32 and got[1].shape == (n,)
                        and got[2].shape == (n,), f"{name} sums {tuple(got[1].shape)}")
                g_mean = got[1].double() / m
                g_var = got[2].double() / m - g_mean ** 2
                bn_err = max(((g_mean - mean).abs() / var.sqrt()).max().item(),
                             ((g_var - var).abs() / var).max().item())
                require(bn_err <= MM_BN_TOL, f"{name} {(m, k, n)}: BN-scaled sums are off by "
                        f"{bn_err} > {MM_BN_TOL}")
            r["max_abs_err"] = max(r["max_abs_err"], y_err)
            r["max_bn_scaled_err"] = max(r["max_bn_scaled_err"], bn_err)
            line = (f"{name} (M,K,N)={(m, k, n)}"
                    f"{' [' + route + ']' if route else ''}: max|dy|={y_err:.3e} (atol "
                    f"{MM_Y_ATOL} x {y_scale:.1f}), BN-scaled sums {bn_err:.3e} (tol "
                    f"{MM_BN_TOL}), two runs identical")
            if timed:  # CUDA-graph replays: the wrapper's host time is not timed
                t_kernel = time_ms(lambda: fn(x, w, impl="kernel"), graph=True)
                t_plain = time_ms(lambda: fn(x, w, impl="plain"), runs=5, graph=True)
                bound, by = matmul_bound_ms(m, k, n, stats)
                line += (f"; kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms torch.matmul "
                         f"{t_lib:.4f} ms bound {bound:.4f} ms ({by})")
                r["ms"] += t_kernel
                r["plain_ms"] += t_plain
                r["bound_ms"] += bound
                r["bound_by"].add(by)
                if not stats:
                    r["library_ms"] += t_lib
            print(line, flush=True)
        del x, w, y_plain, want, y_product
        torch.cuda.empty_cache()
    for name, r in res.items():
        kinds = r.pop("bound_by")
        r["bound_by"] = kinds.pop() if len(kinds) == 1 else "operations"
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name} over its tool's {len(kernels[name][1])} shapes: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, one library call (torch.matmul) {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return res


def phase_trainer(torch, attention, gpu_label, net_G, plan, fp32_batch):
    """CDTrainer.train_step at full width: timed steps on one fixed batch, the
    attention launches counted, then one fp32 step with the kernels against
    one with the plain attention. Every launch of the timed steps must be of
    ``plan["variant"]``. Returns (forward, backward) launches."""
    from stcd_tpu_torch.tools.profile_step import plain_attention, trainer_setup

    kernel = attention.cross_attention_kernel
    trainer, state, batch = trainer_setup(net_G)
    cfg = trainer.cfg
    require(cfg.batch_size == plan["batch"] and cfg.img_size == plan["size"],
            f"{net_G} setup is {cfg.batch_size} x {cfg.img_size}")
    n_steps = plan["warm"] + plan["steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.kernel_launches = kernel.backward_launches = 0
    kernel.forward_variants.clear()
    kernel.backward_variants.clear()
    outs, events = [], []
    for _ in range(n_steps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        outs.append(trainer.train_step(state, *batch))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    fwd, bwd = kernel.kernel_launches, kernel.backward_launches
    variants = (dict(kernel.forward_variants), dict(kernel.backward_variants))
    losses = [float(loss) for loss, _ in outs]
    pixels = cfg.batch_size * cfg.img_size ** 2
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"{net_G}: non-finite loss: {losses}")
    require(sum(losses[-3:]) / 3 < losses[0],
            f"{net_G}: the loss did not fall on a fixed batch: {losses}")
    for _, cm in outs:
        require(int(cm.sum()) == pixels, f"confusion counts sum to {int(cm.sum())}")
    require(state.step == n_steps, f"{state.step} updates for {n_steps} steps")
    require(fwd == plan["launches"] * n_steps and bwd == plan["launches"] * n_steps,
            f"{net_G}: {fwd} forward and {bwd} backward attention launches in {n_steps} "
            f"steps, expected {plan['launches']} each a step")
    require(variants == ({plan["variant"]: fwd}, {plan["variant"]: bwd}),
            f"{net_G}: attention variants {variants}, expected only {plan['variant']}")
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events[plan["warm"]:])
    step_ms = times[len(times) // 2]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    precision = "bf16 autocast" if state.bf16 else "fp32 with TF32 off"
    print(f"training: {net_G}, batch {cfg.batch_size}, {cfg.img_size}x{cfg.img_size}, "
          f"{precision}, {cfg.optimizer} lr {cfg.lr}, loss {cfg.loss}"
          f"{' multi-scale' if cfg.multi_scale_train else ''}, {n_steps} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; attention launches {fwd} forward and "
          f"{bwd} backward = {plan['launches']} x {n_steps} each, all {plan['variant']}",
          flush=True)
    print(f"training {net_G} on {gpu_label} (a smoke reading, median of {plan['steps']} "
          f"steps by CUDA events): step {step_ms:.3f} ms; "
          f"{cfg.batch_size / step_ms * 1e3:.2f} pairs/s; peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    del state, outs, trainer, batch
    torch.cuda.empty_cache()

    # one fp32 step (TF32 is off) from the same weights, batch and generator seed,
    # with the kernels and with the plain attention under autograd
    got = {}
    for impl in ("kernel", "plain"):
        trainer, state, batch = trainer_setup(net_G, batch_size=fp32_batch,
                                              dtype=torch.float32)
        before = kernel.kernel_launches + kernel.backward_launches
        with plain_attention() if impl == "plain" else contextlib.nullcontext():
            loss, cm = trainer.train_step(state, *batch)
        got[impl] = (float(loss), cm.cpu(),
                     kernel.kernel_launches + kernel.backward_launches - before)
        del trainer, state, batch
        torch.cuda.empty_cache()
    require(got["kernel"][2] == 2 * plan["launches"] and got["plain"][2] == 0,
            f"{net_G} fp32 step: {got['kernel'][2]} kernel launches with the kernels and "
            f"{got['plain'][2]} with the plain attention")
    d_loss = abs(got["kernel"][0] - got["plain"][0])
    d_cm = int((got["kernel"][1] - got["plain"][1]).abs().sum()) // 2
    print(f"one fp32 {net_G} train step at batch {fp32_batch}, kernels against plain "
          f"attention: loss {got['kernel'][0]:.6f} vs {got['plain'][0]:.6f} "
          f"(|d|={d_loss:.2e}, atol {ATTN_STEP_LOSS_ATOL}); confusion counts differ in "
          f"{d_cm} pixels (at most {STEP_CM_PIXELS})", flush=True)
    require(d_loss <= ATTN_STEP_LOSS_ATOL, f"{net_G}: step losses differ by {d_loss}")
    require(d_cm <= STEP_CM_PIXELS, f"{net_G}: confusion counts differ in {d_cm} pixels")
    return fwd, bwd


def phase_v6_fp32_step(torch, attention, gpu_label):
    """The ChangeFormerV6 train step at the trainer's default precision (fp32,
    TF32 off), at full width and batch 8: warm and timed steps with the
    kernels (every launch f32_cuda) and then with the plain attention, from
    the same weights and batch. Returns {impl: result}; the kernels' result
    holds the launches of its run."""
    from stcd_tpu_torch.tools.profile_step import plain_attention, trainer_setup

    kernel = attention.cross_attention_kernel
    plan = V6_FP32_TRAIN
    n_steps = plan["warm"] + plan["steps"]
    res = {}
    for impl in ("kernel", "plain"):
        trainer, state, batch = trainer_setup("ChangeFormerV6", dtype=torch.float32)
        cfg = trainer.cfg
        require(cfg.batch_size == plan["batch"] and cfg.img_size == plan["size"]
                and not state.bf16, f"fp32 V6 setup is {cfg.batch_size} x {cfg.img_size}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.kernel_launches = kernel.backward_launches = 0
        kernel.forward_variants.clear()
        kernel.backward_variants.clear()
        losses, events = [], []
        with plain_attention() if impl == "plain" else contextlib.nullcontext():
            for _ in range(n_steps):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                loss, _ = trainer.train_step(state, *batch)
                e1.record()
                losses.append(loss)
                events.append((e0, e1))
            torch.cuda.synchronize()
        fwd, bwd = kernel.kernel_launches, kernel.backward_launches
        variants = (dict(kernel.forward_variants), dict(kernel.backward_variants))
        losses = [float(x) for x in losses]
        require(all(x == x and abs(x) != float("inf") for x in losses),
                f"fp32 V6 ({impl} attention): non-finite loss: {losses}")
        want = plan["launches"] * n_steps if impl == "kernel" else 0
        require(fwd == bwd == want, f"fp32 V6 ({impl} attention): {fwd} forward and {bwd} "
                f"backward launches in {n_steps} steps, expected {want} each")
        if impl == "kernel":
            require(variants == ({"f32_cuda": fwd}, {"f32_cuda": bwd}),
                    f"fp32 V6: attention variants {variants}, expected only f32_cuda")
        times = sorted(e0.elapsed_time(e1) for e0, e1 in events[plan["warm"]:])
        step_ms = times[len(times) // 2]
        res[impl] = {"step_ms": step_ms, "pairs_per_s": cfg.batch_size / step_ms * 1e3,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "forward_launches": fwd, "backward_launches": bwd,
                     "loss_first_last": (losses[0], losses[-1])}
        del trainer, state, batch
        torch.cuda.empty_cache()
    for impl, r in res.items():
        print(f"training ChangeFormerV6 fp32 (TF32 off; the trainer's default precision), "
              f"batch {plan['batch']}, {plan['size']}x{plan['size']}, {impl} attention, on "
              f"{gpu_label} (median of {plan['steps']} steps by CUDA events after "
              f"{plan['warm']}): step {r['step_ms']:.3f} ms; {r['pairs_per_s']:.2f} pairs/s; peak "
              f"device memory {r['peak_gib']:.2f} GiB; loss {r['loss_first_last'][0]:.4f} -> "
              f"{r['loss_first_last'][1]:.4f}; attention launches {r['forward_launches']} + "
              f"{r['backward_launches']}", flush=True)
    print("fp32 V6 step json: " + json.dumps(res), flush=True)
    return res


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
    args = parser.parse_args(["--net_G", "ChangeFormerV6", "--embed_dim", "256",
                              "--init_seed", "0", "--device", "cuda", "--tile", str(TILE)])
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
        kernel.forward_variants.clear()
        results = [drive(engine, rounds[0])]
        t0 = time.monotonic()
        for scenes in rounds[1:]:
            results.append(drive(engine, scenes))
        timed_s = time.monotonic() - t0
        launches = kernel.kernel_launches
        variants = dict(kernel.forward_variants)
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
    require(variants == {"f32_cuda": launches}, f"fp32 serving launched {variants}")
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

    bf16_args = parser.parse_args(["--net_G", "ChangeFormerV6", "--embed_dim", "256",
                                   "--init_seed", "0", "--device", "cuda", "--tile",
                                   str(TILE), "--bf16"])
    engine = BatchingEngine(make_base_fn(bf16_args, model), tile=TILE, batch=BATCH,
                            device="cuda")
    try:
        before = kernel.kernel_launches
        kernel.forward_variants.clear()
        bf16 = engine.predict_pair(*rounds[0][0])
        bf16_batches = engine.stats_snapshot()["batches"]
    finally:
        engine.close()
    require(dict(kernel.forward_variants) == {"mma_bf16": 13 * bf16_batches},
            f"the bf16 request launched {dict(kernel.forward_variants)}")
    require(bool(np.isfinite(bf16).all()) and bf16.min() >= 0 and bf16.max() <= 1,
            "bf16 request gave non-finite or out-of-range probabilities")
    require(kernel.kernel_launches - before == 13 * bf16_batches,
            "the bf16 request did not go through the attention kernel")
    print(f"bf16 autocast request: finite, {kernel.kernel_launches - before} kernel "
          f"launches, all mma_bf16; max|dP| against fp32 "
          f"{float(np.abs(bf16 - results[0][0]).max()):.3e}", flush=True)
    return launches


STAGE_NAMES = {1: "UnetSeg resnet50 (stage 1, make_seg_steps)",
               2: "SegCD resnet50 (stage 2, make_cd_steps)",
               3: "SegCD resnet50 (stage 3, make_semi_cd_steps, 32 synthesized + 32 real pairs)"}


def phase_training(torch, augment_kernel, gpu_label, stage=2):
    """The train step of STCD stage 1, 2 or 3 at full width and batch 64
    through create_train_state and the stage's make_*_steps, then kernel
    against plain augmentation inside one fp32 step on the same draws.
    Returns the kernel's launches on the bf16 run."""
    from stcd_tpu_torch.data.augment import (params_to, sample_augment_params,
                                             sample_pair_params)
    from stcd_tpu_torch.tools.profile_step import seeded_stage_batch, stage_setup

    state, train_step, _ = stage_setup(stage, bf16=True)
    data = seeded_stage_batch(stage, TRAIN_BATCH, TILE, seed=1, device="cuda")
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
    terms = ("loss", "seg_loss", "cd_loss", "ct_loss") if stage == 3 else ("loss",)
    for term in terms:
        values = [float(o[term]) for o in outs]
        require(all(x == x and abs(x) != float("inf") for x in values),
                f"stage {stage}: non-finite {term}: {values}")
    losses = [float(o["loss"]) for o in outs]
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
    last = ", ".join(f"{t} {float(outs[-1][t]):.4f}" for t in terms[1:])
    print(f"training: {STAGE_NAMES[stage]} (256,128,64,32,16), batch {TRAIN_BATCH}, "
          f"{TILE}x{TILE}, augment on, bf16 autocast, {n_steps} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}{'; last step: ' + last if last else ''}; "
          f"augment kernel launches {launches}", flush=True)
    print(f"training stage {stage} on {gpu_label} (a smoke reading, median of {TRAIN_STEPS} "
          f"steps by CUDA events): step {step_ms:.3f} ms; {TRAIN_BATCH / step_ms * 1e3:.2f} "
          f"{'images' if stage == 1 else 'pairs'}/s; peak device memory {peak_gib:.2f} GiB",
          flush=True)
    del state, outs
    torch.cuda.empty_cache()

    # one fp32 step (TF32 is off) from the same init on the same draws, with the
    # kernel and with the plain augmentation: 8 samples (stage 3: 4 + 4 pairs)
    cpu_gen = torch.Generator().manual_seed(3)
    if stage == 1:
        small = {k: v[:8] for k, v in data.items()}
        draws = params_to(sample_augment_params(cpu_gen, 8, 0.5), "cuda")
    elif stage == 2:
        small = {k: v[:8] for k, v in data.items()}
        draws = tuple(params_to(p, "cuda") for p in sample_pair_params(cpu_gen, 8))
    else:
        small = {k: v[:4] for k, v in data.items()}
        draws = tuple(tuple(params_to(p, "cuda") for p in sample_pair_params(cpu_gen, 4, jp))
                      for jp in (0.5, 0.8))
    got = {}
    for impl in ("kernel", "plain"):
        out = train_step(stage_setup(stage, bf16=False)[0], small, aug_params=draws,
                         augment_impl=impl)
        got[impl] = (float(out["loss"]), out["cm"].cpu())
    require(augment_kernel.kernel_launches == launches + 1,
            "the plain-augmentation step launched the kernel")
    d_loss = abs(got["kernel"][0] - got["plain"][0])
    d_cm = int((got["kernel"][1] - got["plain"][1]).abs().sum()) // 2
    print(f"one fp32 stage-{stage} train step at batch 8, kernel against plain augmentation: "
          f"loss {got['kernel'][0]:.6f} vs {got['plain'][0]:.6f} (|d|={d_loss:.2e}, atol "
          f"{STEP_LOSS_ATOL}); confusion counts differ in {d_cm} pixels "
          f"(at most {STEP_CM_PIXELS})", flush=True)
    require(d_loss <= STEP_LOSS_ATOL, f"step losses differ by {d_loss}")
    require(d_cm <= STEP_CM_PIXELS, f"confusion counts differ in {d_cm} pixels")
    return launches


def phase_loop(torch, augment_kernel):
    """run_training for 2 epochs of 3 seeded device batches of 16 pairs at
    full width (SegCD-r50, stage 2, bf16) into a temporary directory; the
    artifacts exist and restore_last gives back the step and the weights.
    Returns the augmentation kernel's launches."""
    import tempfile

    from stcd_tpu_torch.tools.profile_step import seeded_stage_batch, stage_setup
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    from stcd_tpu_torch.train.loops import run_training

    state, train_step, eval_step = stage_setup(2, bf16=True)
    train = [seeded_stage_batch(2, LOOP_BATCH, TILE, seed=10 + i, device="cuda")
             for i in range(LOOP_BATCHES)]
    evals = [seeded_stage_batch(2, LOOP_BATCH, TILE, seed=20, device="cuda")]
    gen = torch.Generator(device="cuda").manual_seed(4)
    augment_kernel.kernel_launches = 0
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.monotonic()
        state, best, history = run_training(train_step, eval_step, state, train, evals,
                                            n_epochs=2, save_dir=save_dir, rng=gen,
                                            log_every=1)
        torch.cuda.synchronize()
        loop_s = time.monotonic() - t0
        launches = augment_kernel.kernel_launches
        files = sorted(os.listdir(save_dir))
        require(len(history) == 2 and state.step == 2 * LOOP_BATCHES,
                f"{len(history)} epochs, {state.step} steps")
        require(launches == 2 * LOOP_BATCHES, f"{launches} augment launches in the loop")
        require("last_ckpt" in files and "2.00_model" in files
                and sum(f.endswith("_best_model") for f in files) == 1,
                f"checkpoint files: {files}")
        with open(os.path.join(save_dir, "logs", "scalars.jsonl")) as f:
            tags = {json.loads(line)["tag"] for line in f}
        require({"train/loss", "train/IoU", "train/imgs_per_sec", "val/IoU"} <= tags,
                f"scalar log tags: {sorted(tags)}")
        for h in history:  # precision and F1 are nan while nothing is predicted changed
            require(0.0 <= h["val"]["OA"] <= 1.0 and 0.0 <= h["train"]["OA"] <= 1.0,
                    f"epoch metrics: {h}")
        fresh = stage_setup(2, bf16=True)[0]
        restored = CheckpointManager(save_dir).restore_last(fresh)
        require(restored is not None and restored[1] == 2 and fresh.step == state.step,
                f"restore_last gave {restored and restored[1:]} at step {fresh.step}")
        for (name, want), got in zip(state.model.state_dict().items(),
                                     fresh.model.state_dict().values()):
            require(bool(torch.equal(want, got)), f"restore_last: {name} differs")
        want_opt, got_opt = (st.optimizer.state_dict()["state"] for st in (state, fresh))
        require(len(want_opt) > 100 and want_opt.keys() == got_opt.keys()
                and all(torch.equal(want_opt[i]["exp_avg"], got_opt[i]["exp_avg"])
                        for i in want_opt), "restore_last: Adam moments differ")
    print(f"loop: run_training, SegCD resnet50, 2 epochs x {LOOP_BATCHES} batches of "
          f"{LOOP_BATCH} pairs, bf16: {loop_s:.1f} s with evals and checkpoints; best IoU "
          f"{best:.4f}; files {files}; restore_last gives back step {fresh.step}, the "
          f"weights and the Adam moments; augment kernel launches {launches}", flush=True)
    return launches


def phase_tools(torch):
    """The three feasibility benchmarks' entry points on the card: they are the
    main path of the four matmul kernels and of bn_stats. Returns each
    kernel's launches and the matmul kernels' launches by route."""
    from stcd_tpu_torch.ops import matmul_stats as ops
    from stcd_tpu_torch.ops.bn_stats import bn_stats_kernel
    from stcd_tpu_torch.tools import bench_bnstats, bench_bnstats_diag, bench_conv_bn_epilogue

    wrappers = {"matmul_stats": ops.matmul_stats_kernel, "matmul_bf16": ops.matmul_bf16_kernel,
                "matmul_stats_rows": ops.matmul_stats_rows_kernel,
                "matmul_stats_mma": ops.matmul_stats_mma_kernel}
    for wrapper in wrappers.values():
        wrapper.kernel_launches = 0
        wrapper.routes.clear()
    bn_stats_kernel.kernel_launches = 0
    rows = {"bench_conv_bn_epilogue": bench_conv_bn_epilogue.main([]),
            "bench_bnstats_diag": bench_bnstats_diag.main([]),
            "bench_bnstats": bench_bnstats.main([])}
    torch.cuda.synchronize()
    launches = {name: wrapper.kernel_launches for name, wrapper in wrappers.items()}
    launches["bn_stats"] = bn_stats_kernel.kernel_launches
    routes = {name: dict(wrapper.routes) for name, wrapper in wrappers.items()}
    for name, took in routes.items():
        require(took == {"wgmma_tma": launches[name]} and launches[name] > 0,
                f"the tools' {name} launches took the routes {took}")
    require(len(rows["bench_conv_bn_epilogue"]) == 5 and len(rows["bench_bnstats_diag"]) == 3
            and len(rows["bench_bnstats"]) == 6, "the tools did not return a row for each shape")
    for row in rows["bench_conv_bn_epilogue"]:
        require(row["impl"] == "kernel" and row["relerr"] == row["relerr"]
                and row["matmul_stats_ms"] > 0, f"bench_conv_bn_epilogue row: {row}")
    for row in rows["bench_bnstats_diag"]:
        require(row["impl"] == "kernel" and row["y_equal"]
                and row["cross_variant_err"] == row["cross_variant_err"],
                f"bench_bnstats_diag row: {row}")
    for row in rows["bench_bnstats"]:
        # against stats_plain, relative to the sum of the terms' magnitudes (the inputs
        # are standard normal, so the sum itself may cancel to near 0): two float32
        # summation orders
        require(row["impl"] == "kernel" and row["bn_stats_ms"] > 0
                and row["bn_stats_rel_err"] <= BN_REL_TOL, f"bench_bnstats row: {row}")
    print("tools rows json: " + json.dumps(rows), flush=True)
    print(f"tools: kernel launches {launches}; by route {routes}", flush=True)
    return launches, routes


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


PIPE = dict(n=16, size=256, encoder="resnet50", decoder="256,128,64,32,16", batch=8,
            epochs=3)  # the demo's tree and the full-width stages of phase 13
PIPE_DECODE_PASSES = 3  # loader passes over the LEVIR train pairs for the decode rate


def phase_pipeline_cli(torch, augment_kernel, gpu_label, root):
    """The pipeline from the command line: cli.pipeline_demo.main writes the
    demo tree (cli.make_demo_data: 16 train and 8 val tiles of 256x256 a
    dataset) into ``root`` and runs its six steps at full width on the card
    (resnet50, decoder 256..16, bf16, batch 8, 3 epochs). Requires every step's
    artifacts, reliabilities that are not all equal, the models and every
    loader batch on the card with the images as uint8, and one augmentation
    launch for each train step of the three stages. Returns the launches and
    the final evaluation's metrics."""
    from stcd_tpu_torch import native
    from stcd_tpu_torch.cli import pipeline_demo
    from stcd_tpu_torch.data import io as data_io
    from stcd_tpu_torch.data import loader as data_loader
    from stcd_tpu_torch.data.datasets import CDDataset

    batches = {}  # (key, device type, dtype) -> batches handed out
    plain_iter = data_loader.DataLoader.__iter__

    def recording_iter(self):
        for batch in plain_iter(self):
            for key, value in batch.items():
                if torch.is_tensor(value):
                    tag = (key, value.device.type, str(value.dtype).replace("torch.", ""))
                    batches[tag] = batches.get(tag, 0) + 1
            yield batch

    native_built = native.available()
    data_loader.DataLoader.__iter__ = recording_iter
    data_io.reset_decode_counts()
    augment_kernel.kernel_launches = 0
    try:
        # the tree stays in ``root`` for phases 16 and 17
        results = pipeline_demo.main([
            root, "--device", "cuda", "--n", str(PIPE["n"]), "--size", str(PIPE["size"]),
            "--encoder", PIPE["encoder"], "--decoder_channels", PIPE["decoder"],
            "--batch_size", str(PIPE["batch"]), "--n_epochs", str(PIPE["epochs"]),
            "--bf16"])
        torch.cuda.synchronize()
        launches = augment_kernel.kernel_launches
        decodes = data_io.decode_counts()
        runs, train = os.path.join(root, "runs"), os.path.join(root, "data", "LEVIR", "train")
        steps = list(results.values())
        stages = {"stage 1": steps[1]["result"], "stage 2": steps[2]["result"],
                  "stage 3": steps[5]["result"]}
        for name in ("seg", "psecd", "stcd"):
            files = os.listdir(os.path.join(runs, name))
            require({"last_ckpt", "1.00_model", "2.00_model", "3.00_model"} <= set(files)
                    and sum(f.endswith("_best_model") for f in files) == 1,
                    f"run {name}: {sorted(files)}")
        lists = {k: data_io.read_list(os.path.join(train, "list", f"{k}_ids.txt"))
                 for k in ("reliable", "unreliable")}
        require(len(lists["reliable"]) == len(lists["unreliable"]) == PIPE["n"] // 2,
                f"reliability lists {lists}")
        reliability = [r for _, r in steps[3]["result"]["reliability"]]
        require(len(set(reliability)) > 1, f"every reliability is {reliability[0]}")
        ff = sorted(os.listdir(os.path.join(train, "ff_label")))
        require(ff == sorted(os.listdir(os.path.join(train, "A"))), f"ff_label/ {ff}")
        metrics = steps[6]["result"]
        require(set(metrics) == {"OA", "precision", "recall", "F1", "IoU", "mIoU"}
                and 0.0 <= metrics["OA"] <= 1.0, f"evaluate's metrics {metrics}")
        train_steps = 0
        rates = {}
        for label, (name, out) in zip(("stage 1", "stage 2", "stage 3"),
                                     zip(("seg", "psecd", "stcd"), stages.values())):
            state = out["state"]
            require(all(p.is_cuda for p in state.model.parameters()),
                    f"{label}: a parameter is off the card")
            require(state.step == PIPE["epochs"] * (PIPE["n"] // PIPE["batch"]),
                    f"{label}: {state.step} train steps")
            train_steps += state.step
            with open(os.path.join(runs, name, "logs", "scalars.jsonl")) as f:
                rates[label] = [round(r["value"], 2) for r in map(json.loads, f)
                                if r["tag"] == "train/imgs_per_sec"]
        require(launches == train_steps == 18,
                f"{launches} augmentation launches for {train_steps} train steps")
        images = {"A", "B", "image", "CA", "CB"}
        labels = {"label", "s_label_A", "s_label_B", "c_label", "CL"}
        require(batches and all(dev == "cuda" for _, dev, _ in batches),
                f"loader batches off the card: {batches}")
        require(all(dtype == "uint8" for key, _, dtype in batches if key in images | labels),
                f"loader batches not uint8: {batches}")
        require({key for key, _, _ in batches} >= images,
                f"loader keys {sorted(batches)}")

        # the loader's decode rate on this host: the LEVIR train pairs (A, B, label)
        data_io.reset_decode_counts()
        loader = data_loader.DataLoader(
            CDDataset(os.path.join(root, "data"), "LEVIR", "train"), PIPE["batch"],
            shuffle=True, device="cuda")
        t0 = time.monotonic()
        for _ in range(PIPE_DECODE_PASSES):
            for batch in loader:
                pass
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        decoded = sum(data_io.decode_counts().values())
    finally:
        data_loader.DataLoader.__iter__ = plain_iter
        data_io.set_uint8_transfer(False)
    print(f"pipeline_cli: native decoder built: {native_built}; files decoded by path "
          f"{decodes} (TIFF goes to PIL)", flush=True)
    print("pipeline_cli: seconds by step " + json.dumps(
        {title: round(r["seconds"], 2) for title, r in results.items()}), flush=True)
    print(f"pipeline_cli ({gpu_label}): train images (stage 1) or samples (stages 2, 3) "
          f"per second by epoch, host clock, batch {PIPE['batch']}: {rates}", flush=True)
    print(f"pipeline_cli ({gpu_label}): loader decode {decoded} files in {decode_s:.3f} s = "
          f"{decoded / decode_s:.1f} files/s ({decoded // 3} pairs of {PIPE['size']}x{PIPE['size']} "
          f"PNG with labels, "
          f"{PIPE_DECODE_PASSES} passes, 4 threads, copies to the card included)", flush=True)
    print(f"pipeline_cli: reliabilities {sorted(set(round(r, 4) for r in reliability))}; "
          f"evaluate {json.dumps(metrics)}; loader batches {len(batches)} kinds, all on the "
          f"card; augment kernel launches {launches} for {train_steps} train steps", flush=True)
    return launches, metrics


TRAIN_CD = dict(batch=8, size=256, length=16, epochs=2)  # train_cd: 2 steps an epoch
# forward SRA launches of one forward of V1..V5 at their published widths
CF_LAUNCHES = {"ChangeFormerV1": 16, "ChangeFormerV2": 16, "ChangeFormerV3": 16,
               "ChangeFormerV4": 25, "ChangeFormerV5": 28}
CF_BATCH = 8  # pairs of 256x256 tiles: the encoders' attention sees 16 images
# (B, H, N, M, D) of the SRA stages of V4 and V5 at CF_BATCH pairs of 256x256 tiles, the
# shapes no model path gave the kernels before: V4's D = 16 and D = 40, V5's 5 heads
CF_NEW_SHAPES = ((16, 2, 16384, 256, 16), (16, 2, 4096, 256, 32), (16, 4, 1024, 256, 32),
                 (16, 8, 256, 256, 40), (16, 16, 64, 64, 32), (16, 1, 4096, 64, 64),
                 (16, 2, 1024, 64, 64), (16, 5, 256, 64, 64), (16, 8, 64, 64, 64))
INT8_F1_TOL = 0.02  # the JAX gate (tests/test_serving_quant.py:255-318)
# that gate's protocol: SegCD-r18 trained on its synthetic task, then float and int8 F1
INT8_GATE = dict(size=64, n_train=24, n_val=12, batch=4, epochs=4, seed=11,
                 decoder=(32, 24, 16, 12, 8))
EXPORT_ATOL = 1e-4  # a loaded program against the eager forward, x max(1, max |eager|)


def reset_attention_counts(attention):
    kernel = attention.cross_attention_kernel
    kernel.kernel_launches = kernel.backward_launches = 0
    kernel.forward_variants.clear()
    kernel.backward_variants.clear()
    return kernel


def phase_train_cd(torch, attention, augment_kernel, gpu_label, root):
    """cli.train_cd at full width: ChangeFormerV6 (embed 256), 256x256,
    batch 8, fp32, --augment, synthetic data, 2 epochs of 2 steps; then
    --eval_only; then a third epoch that resumes at epoch 2; then one epoch of
    base_transformer_pos_s4_dd8. Requires, for each train step, 13 forward and
    13 backward f32_cuda attention launches and one augmentation launch (and 13
    forward launches for each eval batch), a finite loss, best_ckpt, last_ckpt,
    both curves and the masks. Returns the launches by path."""
    import numpy as np

    from stcd_tpu_torch.cli import train_cd

    ckpt = os.path.join(root, "train_cd_v6")
    n = TRAIN_CD["length"] // TRAIN_CD["batch"]  # train steps an epoch
    val_batches = -(-max(TRAIN_CD["length"] // 2, 2) // TRAIN_CD["batch"])
    common = ["--net_G", "ChangeFormerV6", "--embed_dim", "256", "--img_size",
              str(TRAIN_CD["size"]), "--batch_size", str(TRAIN_CD["batch"]), "--augment",
              "--dataset_name", "synthetic", "--synthetic_length", str(TRAIN_CD["length"]),
              "--checkpoint_dir", ckpt, "--device", "cuda"]
    kernel = reset_attention_counts(attention)
    augment_kernel.kernel_launches = 0
    t0 = time.monotonic()
    out = train_cd.main(common + ["--max_epochs", str(TRAIN_CD["epochs"])])
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    steps = TRAIN_CD["epochs"] * n
    fwd, bwd, aug = kernel.kernel_launches, kernel.backward_launches, augment_kernel.kernel_launches
    evals = TRAIN_CD["epochs"] * val_batches + val_batches  # each epoch's val and the final
    require(out["state"].step == steps, f"train_cd: {out['state'].step} steps, not {steps}")
    require(fwd == 13 * (steps + evals) and bwd == 13 * steps and aug == steps,
            f"train_cd: {fwd} forward, {bwd} backward attention and {aug} augmentation "
            f"launches for {steps} train steps and {evals} eval batches")
    require(set(kernel.forward_variants) == set(kernel.backward_variants) == {"f32_cuda"},
            f"train_cd variants {dict(kernel.forward_variants)} "
            f"{dict(kernel.backward_variants)}")
    files = set(os.listdir(ckpt))
    require({"best_ckpt", "last_ckpt", "train_acc.npy", "val_acc.npy", "logs", "vis"} <= files,
            f"train_cd artifacts {sorted(files)}")
    with open(os.path.join(ckpt, "logs", "scalars.jsonl")) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    require(len(losses) == TRAIN_CD["epochs"] and all(np.isfinite(losses)),
            f"train_cd losses {losses}")
    masks = sorted(os.listdir(os.path.join(ckpt, "vis")))
    require(len(masks) == max(TRAIN_CD["length"] // 2, 2), f"train_cd masks {masks}")
    print(f"train_cd ({gpu_label}): ChangeFormerV6 embed 256, {TRAIN_CD['size']}x"
          f"{TRAIN_CD['size']}, batch {TRAIN_CD['batch']}, fp32, --augment: {steps} steps and "
          f"{evals} eval batches in {seconds:.2f} s (host clock, build and saves included); "
          f"losses {[round(x, 4) for x in losses]}; val scores {out['scores']}; "
          f"{fwd} + {bwd} attention launches, {aug} augmentation launches", flush=True)
    by_path = {"fwd": fwd, "bwd": bwd, "aug": aug}

    before = kernel.kernel_launches
    scores = train_cd.main(common + ["--eval_only"])["scores"]
    require(kernel.kernel_launches - before == 13 * val_batches, "train_cd --eval_only launches")
    out = train_cd.main(common + ["--max_epochs", str(TRAIN_CD["epochs"] + 1)])
    curves = [np.load(os.path.join(ckpt, f"{c}_acc.npy")) for c in ("train", "val")]
    require(out["trainer"].epoch_to_start == TRAIN_CD["epochs"]
            and out["state"].step == steps + n
            and all(len(c) == TRAIN_CD["epochs"] + 1 for c in curves),
            f"train_cd resume: epoch {out['trainer'].epoch_to_start}, step "
            f"{out['state'].step}, curves {[len(c) for c in curves]}")
    print(f"train_cd: --eval_only scores {scores}; the third epoch resumed at epoch "
          f"{out['trainer'].epoch_to_start} (step {out['state'].step}); val mF1 curve "
          f"{[round(float(x), 4) for x in curves[1]]}", flush=True)
    by_path["fwd"] += kernel.kernel_launches - before
    by_path["bwd"] = kernel.backward_launches
    by_path["aug"] = augment_kernel.kernel_launches

    # BIT, the small_m launches
    kernel = reset_attention_counts(attention)
    augment_kernel.kernel_launches = 0
    bit_dir = os.path.join(root, "train_cd_bit")
    t0 = time.monotonic()
    out = train_cd.main(["--img_size", str(TRAIN_CD["size"]), "--batch_size",
                         str(TRAIN_CD["batch"]), "--augment", "--dataset_name", "synthetic",
                         "--synthetic_length", str(TRAIN_CD["length"]), "--max_epochs", "1",
                         "--checkpoint_dir", bit_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = BIT_TRAIN["launches"]
    require(out["trainer"].cfg.net_G == "base_transformer_pos_s4_dd8", "the default net_G")
    require(kernel.kernel_launches == launches * (n + 2 * val_batches)
            and kernel.backward_launches == launches * n
            and augment_kernel.kernel_launches == n
            and set(kernel.forward_variants) == set(kernel.backward_variants) == {"small_m"},
            f"train_cd BIT: {kernel.kernel_launches} forward, {kernel.backward_launches} "
            f"backward ({dict(kernel.forward_variants)}), "
            f"{augment_kernel.kernel_launches} augmentation launches")
    require({"best_ckpt", "last_ckpt"} <= set(os.listdir(bit_dir)), "train_cd BIT artifacts")
    print(f"train_cd: base_transformer_pos_s4_dd8 (the default), 1 epoch of {n} steps in "
          f"{time.monotonic() - t0:.2f} s; {kernel.kernel_launches} + "
          f"{kernel.backward_launches} small_m launches; scores {out['scores']}", flush=True)
    return {"v6": by_path, "bit": {"fwd": kernel.kernel_launches,
                                   "bwd": kernel.backward_launches,
                                   "aug": augment_kernel.kernel_launches}}


def phase_changeformer_zoo(torch, attention, gpu_label):
    """ChangeFormer V1-V5 at their published widths (V5 embed 256), seeded
    weights: one eval forward of CF_BATCH pairs of 256x256 tiles with the
    kernel against the plain attention (P(changed) of the final scale within
    PROBS_ATOL), with CF_LAUNCHES forward launches, all f32_cuda; then one
    fp32 CDTrainer step of each with as many backward launches. Returns the
    launches by model."""
    from stcd_tpu_torch.models.factory import define_G, init_weights
    from stcd_tpu_torch.tools.profile_step import plain_attention, seeded_cd_batch
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    data = seeded_cd_batch(CF_BATCH, TILE, seed=3, device="cuda")
    a, b = (data[k].float().div(255.0).permute(0, 3, 1, 2).contiguous() for k in ("A", "B"))
    launches = {}

    def p_changed(out):
        out = out[-1] if isinstance(out, (list, tuple)) else out
        return torch.softmax(out.float(), dim=1)[:, 1:].sum(1)

    for net_G, per_forward in CF_LAUNCHES.items():
        model = init_weights(define_G(net_G, embed_dim=256, device="cuda"), seed=0).eval()
        kernel = reset_attention_counts(attention)
        with torch.no_grad():
            got = p_changed(model(a, b))
            torch.cuda.synchronize()
            fwd = kernel.kernel_launches
            ms = time_ms(lambda: model(a, b), runs=5)
            with plain_attention():
                want = p_changed(model(a, b))
                plain_ms = time_ms(lambda: model(a, b), runs=5)
        err = (got - want).abs().max().item()
        require(fwd == per_forward and set(kernel.forward_variants) == {"f32_cuda"},
                f"{net_G}: {fwd} forward launches {dict(kernel.forward_variants)}, not "
                f"{per_forward} f32_cuda")
        require(err <= PROBS_ATOL, f"{net_G}: P(changed) with the kernel and with the plain "
                f"attention differ by {err} > {PROBS_ATOL}")
        del model
        trainer = CDTrainer(TrainerConfig(net_G=net_G, embed_dim=256, img_size=TILE,
                                          batch_size=CF_BATCH), steps_per_epoch=100)
        state = trainer.init_state("cuda", init_seed=0)
        kernel = reset_attention_counts(attention)
        loss, _ = trainer.train_step(state, data["A"], data["B"], data["label"])
        torch.cuda.synchronize()
        require(bool(torch.isfinite(loss)) and kernel.kernel_launches == per_forward
                and kernel.backward_launches == per_forward
                and set(kernel.backward_variants) == {"f32_cuda"},
                f"{net_G} train step: loss {loss.item()}, {kernel.kernel_launches} forward "
                f"and {kernel.backward_launches} backward launches")
        launches[net_G] = {"eval_fwd": fwd, "train_fwd": kernel.kernel_launches,
                           "train_bwd": kernel.backward_launches}
        print(f"{net_G} ({gpu_label}): eval forward of {CF_BATCH} pairs at {TILE}x{TILE}, "
              f"fp32: {fwd} f32_cuda launches, max|P(changed) kernel - plain| {err:.3e} "
              f"(atol {PROBS_ATOL}); forward {ms:.2f} ms with the kernel, {plain_ms:.2f} ms "
              f"with the plain attention (events, median of 5); one fp32 train step: loss "
              f"{loss.item():.4f}, {kernel.kernel_launches} + {kernel.backward_launches} "
              f"launches", flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    return launches


def gate_pair(np, rng, size: int):
    """One learnable change pair of the JAX package's int8 gate and convergence
    protocol (benchmarks/convergence_parity.py:59-95, copied): a textured
    background, bright rectangles removed from A or added in B. Returns A and B
    as (size, size, 3) float in [0, 1] and the (size, size) label."""
    base = rng.uniform(0.25, 0.5) + rng.normal(0.0, 0.04, (size, size, 1))
    bg = np.clip(np.broadcast_to(base, (size, size, 3)).copy()
                 + rng.normal(0.0, 0.02, (size, size, 3)), 0, 1)
    a = bg + rng.normal(0.0, 0.01, bg.shape)
    b = bg + rng.normal(0.0, 0.01, bg.shape)
    label = np.zeros((size, size), np.float32)

    def rect():
        h, w = rng.integers(8, 22, 2)
        return (rng.integers(0, size - h), rng.integers(0, size - w), h, w)

    def paint(img, r, color):
        y, x, h, w = r
        img[y:y + h, x:x + w] = color + rng.normal(0.0, 0.02, (h, w, 3))

    for _ in range(rng.integers(1, 4)):
        r, color = rect(), rng.uniform(0.65, 0.95, 3)
        paint(a, r, color)
        if rng.uniform() < 0.5:
            paint(b, r, color)
        else:
            label[r[0]:r[0] + r[2], r[1]:r[1] + r[3]] = 1.0
    for _ in range(rng.integers(0, 3)):
        r, color = rect(), rng.uniform(0.65, 0.95, 3)
        paint(b, r, color)
        label[r[0]:r[0] + r[2], r[1]:r[1] + r[3]] = 1.0
    return np.clip(a, 0, 1), np.clip(b, 0, 1), label


def int8_gate(torch, np, root, gpu_label):
    """The JAX package's int8 gate (tests/test_serving_quant.py:255-318) on the
    card, through cli.evaluate: SegCD-r18 with decoder (32, 24, 16, 12, 8)
    trained for 4 epochs of Adam 1e-3 on 24 pairs of the gate's synthetic task
    at 64x64 (batch 4, no augmentation), its 12 val pairs written as a LEVIR
    tree; the float F1 must be above 0.5 (the model learned) and the --int8 F1
    within INT8_F1_TOL of it."""
    from stcd_tpu_torch.cli import evaluate
    from stcd_tpu_torch.data.io import save_mask_png, write_list
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    from stcd_tpu_torch.train.state import AdamConfig, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps
    from PIL import Image

    g = INT8_GATE
    rng = np.random.default_rng(g["seed"])
    pairs = [gate_pair(np, rng, g["size"]) for _ in range(g["n_train"] + g["n_val"])]
    u8 = [tuple((x * 255).round().astype(np.uint8) for x in p[:2]) + (p[2],) for p in pairs]
    train, val = u8[:g["n_train"]], u8[g["n_train"]:]
    model = init_weights(SegCD("resnet18", decoder_channels=g["decoder"]), seed=0)
    state = create_train_state(model, AdamConfig(lambda step: 1e-3), device="cuda")
    train_step, _ = make_cd_steps(augment=False)
    # cuDNN's deterministic algorithms: the gate's model is the same on every run
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(g["epochs"]):
            for s0 in range(0, g["n_train"], g["batch"]):
                chunk = train[s0:s0 + g["batch"]]
                train_step(state, {
                    "A": torch.from_numpy(np.stack([p[0] for p in chunk])).cuda(),
                    "B": torch.from_numpy(np.stack([p[1] for p in chunk])).cuda(),
                    "label": torch.from_numpy(
                        np.stack([p[2] for p in chunk])[..., None]).cuda()})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    tree = os.path.join(root, "int8_gate", "LEVIR", "val")
    names = [f"{i}.png" for i in range(g["n_val"])]
    for name, (a, b, label) in zip(names, val):
        for sub, img in (("A", a), ("B", b)):
            os.makedirs(os.path.join(tree, sub), exist_ok=True)
            Image.fromarray(img).save(os.path.join(tree, sub, name))
        save_mask_png(label, os.path.join(tree, "label", name))
    write_list(names, os.path.join(tree, "list", "val.txt"))
    run = os.path.join(root, "int8_gate", "run")
    CheckpointManager(run).save_best(state, 0.5)
    argv = ["--root_path", os.path.join(root, "int8_gate"), "--dataset_name", "LEVIR",
            "--split", "val", "--load_path", run, "--encoder", "resnet18",
            "--decoder_channels", ",".join(map(str, g["decoder"])), "--batch_size", "8",
            "--img_height", str(g["size"]), "--img_width", str(g["size"]), "--device", "cuda"]
    flt, q = evaluate.main(argv), evaluate.main(argv + ["--int8"])
    d_f1 = abs(q["F1"] - flt["F1"])
    print(f"int8 gate ({gpu_label}): SegCD-r18, decoder {g['decoder']}, trained on the card "
          f"on the gate's synthetic task: F1 {q['F1']:.4f} int8 against {flt['F1']:.4f} "
          f"float (|d| {d_f1:.4f} <= {INT8_F1_TOL}), IoU {q['IoU']:.4f} against "
          f"{flt['IoU']:.4f}", flush=True)
    require(flt["F1"] > 0.5, f"the int8 gate's model did not learn: float F1 {flt['F1']}")
    require(d_f1 <= INT8_F1_TOL, f"int8 gate: F1 {q['F1']} against float {flt['F1']}: "
            f"{d_f1} > {INT8_F1_TOL}")
    return flt, q


def phase_int8(torch, np, root, float_metrics, gpu_label):
    """int8: the JAX package's gate (``int8_gate``); then on the model that
    phase 13 trained (SegCD-r50, stage 3, decoder 256..16), cli.evaluate --int8
    beside the phase's float evaluation, with the share of its change logits
    within 0.1 of 0 (the gate holds a model with margins; this model is 3
    epochs into its training, and where its logits sit at 0 the int8 rounding
    moves its decisions: its F1 is reported, not gated), the int8 and float ms of
    one batch, cli.predict --int8 writing a mask, and cli.serve --int8
    --calib_dir answering requests in a subprocess."""
    import base64
    import socket
    import urllib.request

    from stcd_tpu_torch.cli import evaluate, predict
    from stcd_tpu_torch.data.augment import eval_preprocess
    from stcd_tpu_torch.data.io import read_image, set_uint8_transfer

    int8_gate(torch, np, root, gpu_label)
    data, stcd = os.path.join(root, "data"), os.path.join(root, "runs", "stcd")
    model_args = ["--encoder", PIPE["encoder"], "--decoder_channels", PIPE["decoder"],
                  "--device", "cuda"]
    metrics = evaluate.main(["--root_path", data, "--dataset_name", "LEVIR", "--split", "val",
                             "--load_path", stcd, "--batch_size", str(PIPE["batch"]),
                             "--img_height", str(PIPE["size"]), "--img_width",
                             str(PIPE["size"]), "--int8", *model_args])
    d_f1 = abs(metrics["F1"] - float_metrics["F1"])
    set_uint8_transfer(False)  # cli.evaluate switched it on

    parser = argparse.ArgumentParser()
    predict.add_model_args(parser)
    args = parser.parse_args(["--load_path", stcd, "--tile", str(PIPE["size"]), *model_args])
    model = predict.build_model(args)
    base_fn = predict.make_base_fn(args, model)
    val = os.path.join(data, "LEVIR", "val")
    names = sorted(os.listdir(os.path.join(val, "A")))[:PIPE["batch"]]
    a, b = (torch.from_numpy(np.stack([read_image(os.path.join(val, d, n)) for n in names]))
            .cuda() for d in ("A", "B"))
    qfn, scales = predict.quantize_base_fn(model, base_fn, a, b)
    with torch.inference_mode():
        float_ms, int8_ms = time_ms(lambda: base_fn(a, b), runs=10), time_ms(
            lambda: qfn(a, b), runs=10)
        change = model(eval_preprocess(a).permute(0, 3, 1, 2),
                       eval_preprocess(b).permute(0, 3, 1, 2))[2].float()
        near_zero = (change.abs() < 0.1).float().mean().item()
    from stcd_tpu_torch.serving.quant import n_quantized_sites
    print(f"int8 ({gpu_label}): SegCD-r50 of phase 13, {n_quantized_sites(scales)} of "
          f"{len(scales)} conv sites quantized; evaluate F1 {metrics['F1']:.4f} int8 against "
          f"{float_metrics['F1']:.4f} float (|d| {d_f1:.4f}, not gated: "
          f"{100 * near_zero:.1f} % of its change logits lie within 0.1 of 0), IoU "
          f"{metrics['IoU']:.4f} against {float_metrics['IoU']:.4f}; one step of "
          f"{PIPE['batch']} tiles of {PIPE['size']}x{PIPE['size']}: float {float_ms:.2f} ms, "
          f"int8 {int8_ms:.2f} ms (events, median of 10)", flush=True)

    out = os.path.join(root, "int8_mask.png")
    predict.main(["--image_a", os.path.join(val, "A", names[0]), "--image_b",
                  os.path.join(val, "B", names[0]), "--out", out, "--int8", "--load_path",
                  stcd, *model_args])
    require(os.path.getsize(out) > 0, "cli.predict --int8 wrote no mask")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "stcd_tpu_torch.cli.serve", "--load_path", stcd, "--int8",
         "--calib_dir", val, "--port", str(port), "--batch", "4", *model_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on"):
                break
        require(any(x.startswith("int8: ") for x in lines),
                f"cli.serve --int8 printed {lines[-5:]}")
        with open(os.path.join(val, "A", names[0]), "rb") as fa, \
                open(os.path.join(val, "B", names[0]), "rb") as fb:
            body = json.dumps({"image_a": base64.b64encode(fa.read()).decode(),
                               "image_b": base64.b64encode(fb.read()).decode()}).encode()
        replies = []
        for _ in range(3):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(json.loads(r.read()))
        require(all(r["shape"] == [PIPE["size"], PIPE["size"]] for r in replies),
                f"cli.serve --int8 replies {[r.get('shape') for r in replies]}")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    print(f"int8: cli.predict --int8 wrote {out}; cli.serve --int8 --calib_dir: "
          f"{[x for x in lines if x.startswith('int8: ')][0]}; answered {len(replies)} "
          f"requests, latency_ms {[r['latency_ms'] for r in replies]}", flush=True)
    return metrics


def phase_export(torch, np, attention, root, gpu_label):
    """cli.export_model on the card: SegCD-r50 of phase 13 (the default export),
    ChangeFormerV6 at embed 256 (the serving forward) and SegCD --int8 with
    --calib_npz, each written, loaded back and held against the eager forward
    (EXPORT_ATOL); the loaded V6 program launches the attention kernel 13
    times a call. Returns its launches."""
    from stcd_tpu_torch.cli import export_model
    from stcd_tpu_torch.data.io import read_image, set_uint8_transfer

    stcd = os.path.join(root, "runs", "stcd")
    val = os.path.join(root, "data", "LEVIR", "val")
    names = sorted(os.listdir(os.path.join(val, "A")))[:PIPE["batch"]]
    set_uint8_transfer(False)  # float images in [0, 1], the programs' inputs
    a, b = (np.stack([read_image(os.path.join(val, d, n)) for n in names])
            for d in ("A", "B"))
    calib = os.path.join(root, "calib.npz")
    np.savez(calib, A=a, B=b)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    size = ["--img_height", str(PIPE["size"]), "--img_width", str(PIPE["size"]),
            "--batch_size", str(PIPE["batch"]), "--device", "cuda"]
    segcd = ["--load_path", stcd, "--encoder", PIPE["encoder"], "--decoder_channels",
             PIPE["decoder"]]
    forms = {"segcd_r50": segcd, "changeformer_v6": ["--net_G", "ChangeFormerV6",
                                                     "--embed_dim", "256", "--init_seed", "0"],
             "segcd_r50_int8": segcd + ["--int8", "--calib_npz", calib]}
    kernel = attention.cross_attention_kernel
    v6_launches = 0
    for name, argv in forms.items():
        path = os.path.join(root, f"{name}.pt2")
        t0 = time.monotonic()
        res = export_model.main(argv + size + ["--out", path])
        seconds = time.monotonic() - t0
        loaded = torch.export.load(path).module()
        with torch.no_grad():
            before = kernel.kernel_launches
            got = loaded(ta, tb)
            torch.cuda.synchronize()
            launches = kernel.kernel_launches - before
            want = res["fn"](ta, tb)
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        bound = EXPORT_ATOL * max(1.0, max(w.float().abs().max().item() for w in want))
        require(len(got) == len(want) and err <= bound,
                f"export {name}: the loaded program differs from eager by {err} > {bound}")
        if name == "changeformer_v6":
            require(launches == 13, f"the loaded V6 program launched the attention kernel "
                    f"{launches} times, not 13")
            v6_launches = launches
        print(f"export {name} ({gpu_label}): {os.path.getsize(path) / 1e6:.1f} MB written "
              f"and loaded in {seconds:.1f} s; outputs {[tuple(g.shape) for g in got]}; "
              f"max|loaded - eager| {err:.3e} (atol {EXPORT_ATOL} x max(1, max|eager|)); "
              f"{launches} attention kernel launches a call", flush=True)
        del res, loaded
        torch.cuda.empty_cache()
    return v6_launches


# phase 18: the rest of the define_G zoo, at the widths of the JAX CLI defaults
ZOO_KEYS = ("Unet", "SiamUnet_sub", "SiamUnet_abs", "SiamUnet_conc", "SiamUnet_cross_conc",
            "SNUNet", "DTCDSCN", "IFNet", "ChangeGNNV1", "ChangeGNNV2", "ChangeGNNV2_sub",
            "ChangeGNNV2_abs", "ChangeGNNV2_conc", "GNN")
# train_cd's default batch; the first step is not timed; the CLI runs take cli_steps
ZOO_TRAIN = dict(batch=8, size=256, steps=6, cli_steps=2, cpu_batch=2)
# the card's eval forward against the CPU's on the same weights and inputs (fp32, TF32
# off on the card), x max(1, max |CPU output|): the two sum each conv in another order
ZOO_ATOL = 1e-3
# ViG keys: the share of the card's neighbour indices that the CPU's own KNN picks too,
# at least; the CPU forward is then run on the card's indices and held to ZOO_ATOL
ZOO_NEIGHBOUR_SHARE = 0.99


@contextlib.contextmanager
def card_neighbours():
    """Record the KNN indices of every Grapher call (``gcn_lib.knn_graph``);
    ``feed()`` then makes the next forward's Graphers take them, in order, and
    count how many of its own indices equal them (a near-tie of two scores
    ranks either way on either device; one other neighbour early in the
    encoder moves the outputs downstream of it)."""
    from stcd_tpu_torch.models import gcn_lib
    own = gcn_lib.knn_graph
    recorded, counts = [], [0, 0]

    def record(*args, **kwargs):
        idx = own(*args, **kwargs)
        recorded.append(idx)
        return idx

    def feed():
        queue = [i.cpu() for i in recorded]

        def take(*args, **kwargs):
            mine = own(*args, **kwargs)
            theirs = queue.pop(0)
            counts[0] += int((mine == theirs).sum())
            counts[1] += mine.numel()
            return theirs

        gcn_lib.knn_graph = take
        return queue

    gcn_lib.knn_graph = record
    try:
        yield feed, counts
    finally:
        gcn_lib.knn_graph = own


def phase_zoo(torch, augment_kernel, gpu_label, root):
    """The 14 define_G keys of this phase at full width (the ViG encoder's
    80/160/400/640, embed_dim 64): for each, CDTrainer with the TrainerConfig
    defaults (sgd 0.01, ce; IFNet bce with n_class 1), fp32 with TF32 off,
    augment on, seeded weights (models.factory.init_weights) and data, 6 train
    steps of 8 pairs of 256x256 tiles: finite losses, one augmentation call a
    step (counted from 0), the median ms of the last 5 steps (CUDA events) and
    the peak memory. Then one
    eval forward of 2 pairs on the card held against the same weights on the
    CPU (ZOO_ATOL; the ViG keys on the card's neighbours, ZOO_NEIGHBOUR_SHARE).
    Then cli.train_cd --augment (1 epoch of 2 steps, synthetic data) and
    cli.predict --load_path on what it wrote, for SNUNet and ChangeGNNV2.
    Returns the augmentation calls by path."""
    import copy

    import numpy as np

    from stcd_tpu_torch.cli import predict, train_cd
    from stcd_tpu_torch.data.augment import eval_preprocess
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    n, size, steps = ZOO_TRAIN["batch"], ZOO_TRAIN["size"], ZOO_TRAIN["steps"]
    data = seeded_cd_batch(n, size, seed=5, device="cuda")
    m = ZOO_TRAIN["cpu_batch"]
    xa, xb = (eval_preprocess(data[k][:m]).permute(0, 3, 1, 2).contiguous() for k in "AB")
    aug_calls, rows = 0, {}
    for net_G in ZOO_KEYS:
        bce = dict(loss="bce", n_class=1) if net_G == "IFNet" else {}
        trainer = CDTrainer(TrainerConfig(net_G=net_G, img_size=size, batch_size=n,
                                          augment=True, **bce), steps_per_epoch=steps)
        state = trainer.init_state("cuda", init_seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        augment_kernel.kernel_launches = 0
        losses, times = [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss, _ = trainer.train_step(state, data["A"], data["B"], data["label"])
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            losses.append(loss.item())
        calls = augment_kernel.kernel_launches
        aug_calls += calls
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(all(np.isfinite(losses)) and calls == steps,
                f"{net_G}: losses {losses}, {calls} augmentation calls for {steps} steps")
        model = state.model.eval()
        vig = net_G.startswith(("ChangeGNN", "GNN"))
        with torch.no_grad(), card_neighbours() as (feed, counts):
            card = model(xa, xb)
            queue = feed() if vig else []
            cpu = copy.deepcopy(model).cpu()(xa.cpu(), xb.cpu())
        card = (card[-1] if isinstance(card, (list, tuple)) else card).float().cpu()
        cpu = cpu[-1] if isinstance(cpu, (list, tuple)) else cpu
        err = (card - cpu).abs().max().item()
        bound = ZOO_ATOL * max(1.0, cpu.abs().max().item())
        share = counts[0] / counts[1] if vig else None
        require(card.shape == (m, 1 if bce else 2, size, size) and not queue
                and bool(torch.isfinite(card).all()) and err <= bound,
                f"{net_G}: card forward {tuple(card.shape)} against the CPU's: max|err| "
                f"{err} > {bound}")
        require(not vig or share >= ZOO_NEIGHBOUR_SHARE,
                f"{net_G}: {share} of the neighbour indices equal on the card and the CPU")
        timed = sorted(times[1:])
        rows[net_G] = {"step_ms": timed[len(timed) // 2], "peak_gib": peak}
        print(f"zoo {net_G} ({gpu_label}): {steps} train steps of {n} pairs at {size}x{size}, "
              f"fp32, augment: losses {[round(x, 4) for x in losses]}, step ms "
              f"{[round(t, 2) for t in times]} (median of the last {steps - 1} "
              f"{rows[net_G]['step_ms']:.2f}), peak "
              f"{peak:.2f} GiB, {calls} augmentation calls; eval of {m} pairs, card against "
              f"CPU: max|err| {err:.3e} (atol {ZOO_ATOL} x max(1, max|CPU|) = {bound:.3e})"
              + (f", {share:.4f} of the neighbour indices equal" if vig else ""), flush=True)
        del trainer, state, model
        torch.cuda.empty_cache()
    print("zoo step table: " + json.dumps(rows), flush=True)

    # from the command line: train_cd, then predict on what it wrote
    from PIL import Image
    rng = np.random.default_rng(6)
    images = []
    for name in ("zoo_a.png", "zoo_b.png"):
        path = os.path.join(root, name)
        Image.fromarray(rng.integers(0, 256, (2 * size, 2 * size, 3), dtype=np.uint8)).save(path)
        images.append(path)
    cli_calls, cli_steps = 0, ZOO_TRAIN["cli_steps"]
    for net_G in ("SNUNet", "ChangeGNNV2"):
        ckpt = os.path.join(root, f"train_cd_{net_G}")
        augment_kernel.kernel_launches = 0
        t0 = time.monotonic()
        out = train_cd.main(["--net_G", net_G, "--augment", "--dataset_name", "synthetic",
                             "--synthetic_length", str(cli_steps * n), "--batch_size", str(n),
                             "--img_size", str(size), "--max_epochs", "1", "--checkpoint_dir",
                             ckpt, "--device", "cuda"])
        torch.cuda.synchronize()
        calls = augment_kernel.kernel_launches
        cli_calls += calls
        require(out["state"].step == cli_steps and calls == cli_steps
                and {"best_ckpt", "last_ckpt"} <= set(os.listdir(ckpt)),
                f"train_cd {net_G}: step {out['state'].step}, {calls} augmentation calls, "
                f"{sorted(os.listdir(ckpt))}")
        mask = os.path.join(root, f"zoo_{net_G}.png")
        prob = os.path.join(root, f"zoo_{net_G}.npy")
        predict.main(["--net_G", net_G, "--load_path", ckpt, "--image_a", images[0],
                      "--image_b", images[1], "--out", mask, "--prob_out", prob,
                      "--tile", str(size), "--device", "cuda"])
        probs = np.load(prob)
        require(os.path.isfile(mask) and probs.shape == (2 * size, 2 * size, 1)
                and np.isfinite(probs).all() and 0 <= probs.min() and probs.max() <= 1,
                f"predict {net_G}: {probs.shape} probabilities")
        print(f"zoo cli ({gpu_label}): train_cd --net_G {net_G} --augment, 1 epoch of {cli_steps} "
              f"steps in {time.monotonic() - t0:.1f} s (host clock, eval and saves included), "
              f"{calls} augmentation calls, scores {out['scores']}; predict --load_path wrote "
              f"a {2 * size}x{2 * size} mask", flush=True)
        del out
        torch.cuda.empty_cache()
    return {"zoo_train": aug_calls, "zoo_cli": cli_calls}


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
    attn_bwd = phase_attention_backward(torch, attention)
    attn["max_abs_err"] = max(attn["max_abs_err"], attn_bwd["fwd_max_abs_err"])
    bn = phase_bn_stats(torch)
    mm = phase_matmul_stats(torch)

    # phase 4: serving
    serving_launches = phase_serving(torch, np, attention, gpu_label)

    # phase 5: training, the stage-2 step
    aug_by_path = {"stage2_step": phase_training(torch, augment.apply_augment_kernel,
                                                 gpu_label)}
    aug["library_ms"] = None  # no single PyTorch call computes this function

    # phase 6: SegCD serving
    phase_segcd_serving(torch, np)

    # phases 7 and 8: the trainer's step for ChangeFormerV6 and for BIT
    v6_fwd, v6_bwd = phase_trainer(torch, attention, gpu_label, "ChangeFormerV6",
                                   V6_TRAIN, fp32_batch=2)
    v6_fp32 = phase_v6_fp32_step(torch, attention, gpu_label)["kernel"]
    v6_fp32_fwd, v6_fp32_bwd = v6_fp32["forward_launches"], v6_fp32["backward_launches"]
    bit_fwd, bit_bwd = phase_trainer(torch, attention, gpu_label,
                                     "base_transformer_pos_s4_dd8", BIT_TRAIN, fp32_batch=8)
    # phases 9 to 11: the stage-1 and stage-3 steps and the epoch loop
    for stage in (1, 3):
        aug_by_path[f"stage{stage}_step"] = phase_training(
            torch, augment.apply_augment_kernel, gpu_label, stage=stage)
    aug_by_path["run_training"] = phase_loop(torch, augment.apply_augment_kernel)

    # phase 12: the three feasibility benchmarks, the matmul kernels' and bn_stats' entry
    # points
    tool_launches, tool_routes = phase_tools(torch)
    for name, took in tool_routes.items():
        mm[name]["launches_by_route"] = took
    for name, launches in tool_launches.items():
        require(launches > 0, f"the tools never launched {name}")
        (bn if name == "bn_stats" else mm[name])["launches"] = launches

    with tempfile.TemporaryDirectory() as root:
        # phase 13: the pipeline from the command line
        aug_by_path["pipeline_cli"], float_metrics = phase_pipeline_cli(
            torch, augment.apply_augment_kernel, gpu_label, root)
        # phase 14: cli.train_cd at full width
        train_cd = phase_train_cd(torch, attention, augment.apply_augment_kernel, gpu_label,
                                  root)
        aug_by_path["train_cd"] = train_cd["v6"]["aug"] + train_cd["bit"]["aug"]
        # phase 15: ChangeFormer V1-V5 at their published widths
        zoo = phase_changeformer_zoo(torch, attention, gpu_label)
        # phase 16: int8 evaluation, prediction and serving
        phase_int8(torch, np, root, float_metrics, gpu_label)
        # phase 17: export
        export_v6 = phase_export(torch, np, attention, root, gpu_label)
        # phase 18: the rest of the define_G zoo
        aug_by_path.update(phase_zoo(torch, augment.apply_augment_kernel, gpu_label, root))
    aug["launches"] = sum(aug_by_path.values())

    # every path's count was taken from 0 just before it and read just after
    fwd_by_path = {"v6_serving": serving_launches, "v6_training": v6_fwd,
                   "v6_fp32_training": v6_fp32_fwd, "bit_training": bit_fwd,
                   "train_cd_v6": train_cd["v6"]["fwd"], "train_cd_bit": train_cd["bit"]["fwd"],
                   **{f"{k.lower()}_eval_and_step": v["eval_fwd"] + v["train_fwd"]
                      for k, v in zoo.items()},
                   "export_v6_loaded": export_v6}
    bwd_by_path = {"v6_training": v6_bwd, "v6_fp32_training": v6_fp32_bwd,
                   "bit_training": bit_bwd, "train_cd_v6": train_cd["v6"]["bwd"],
                   "train_cd_bit": train_cd["bit"]["bwd"],
                   **{f"{k.lower()}_step": v["train_bwd"] for k, v in zoo.items()}}
    attn["launches"], attn["launches_by_path"] = sum(fwd_by_path.values()), fwd_by_path
    attn_bwd["launches"], attn_bwd["launches_by_path"] = sum(bwd_by_path.values()), bwd_by_path
    # the variant each path launched (each path's run required that it launched no other)
    f32_paths = ("v6_serving", "v6_fp32_training", "train_cd_v6", "export_v6_loaded")
    attn["variants"] = {
        "f32_cuda": sum(fwd_by_path[k] for k in f32_paths) + sum(
            v["eval_fwd"] + v["train_fwd"] for v in zoo.values()),
        V6_TRAIN["variant"]: v6_fwd,
        BIT_TRAIN["variant"]: bit_fwd + train_cd["bit"]["fwd"]}
    attn_bwd["variants"] = {
        "f32_cuda": v6_fp32_bwd + train_cd["v6"]["bwd"] + sum(v["train_bwd"]
                                                             for v in zoo.values()),
        V6_TRAIN["variant"]: v6_bwd, BIT_TRAIN["variant"]: bit_bwd + train_cd["bit"]["bwd"]}
    attn["ms_by_path"] = {"f32_serving_batch": attn["ms"], **attn_bwd.pop("fwd_ms_by_path")}

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": "cross_attention", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/cross_attention.cu",
         "replaces": "stcd_tpu/ops/attention.py:77", **{k: attn[k] for k in keys},
         "launches_by_path": attn["launches_by_path"], "variants": attn["variants"],
         "ms_by_path": attn["ms_by_path"]},
        {"name": "cross_attention_bwd", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/cross_attention_bwd.cu",
         "replaces": "stcd_tpu/ops/attention.py:141", **{k: attn_bwd[k] for k in keys},
         "launches_by_path": attn_bwd["launches_by_path"], "variants": attn_bwd["variants"],
         "ms_by_path": attn_bwd["ms_by_path"]},
        {"name": "augment", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/augment.cu",
         "replaces": "stcd_tpu/ops/augment_kernel.py:44", **{k: aug[k] for k in keys},
         "launches_by_path": aug_by_path, "eager_ms": aug["eager_ms"],
         "cuda_launches_per_call": aug["cuda_launches_per_call"]},
        {"name": "bn_stats", "route": "cuda",
         "source": "stcd_tpu_torch/ops/csrc/bn_stats.cu",
         "replaces": "stcd_tpu/ops/bn_stats.py:57", **{k: bn[k] for k in keys},
         "launches_by_path": {"bench_bnstats": bn["launches"]}, "scheme": bn["scheme"],
         "f32_ms": bn["f32_ms"], "f32_bound_ms": bn["f32_bound_ms"],
         "by_shape": bn["by_shape"]},
        *[{"name": name, "route": "cuda",
           "source": "stcd_tpu_torch/ops/csrc/" + ("matmul_hopper.cu" if "launches_by_route"
                                                   in mm[name] else "matmul_stats.cu"),
           "replaces": replaces, **{k: mm[name][k] for k in keys},
           "max_bn_scaled_err": mm[name]["max_bn_scaled_err"],
           **({"launches_by_route": mm[name]["launches_by_route"],
               "shapes_by_route_checked": mm[name]["routes_checked"]}
              if "launches_by_route" in mm[name] else {})}
          for name, replaces in (("matmul_stats", "benchmarks/bench_conv_bn_epilogue.py:30"),
                                 ("matmul_bf16", "benchmarks/bench_bnstats_diag.py:24"),
                                 ("matmul_stats_rows", "benchmarks/bench_bnstats_diag.py:46"),
                                 ("matmul_stats_mma", "benchmarks/bench_bnstats_diag.py:88"))],
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
