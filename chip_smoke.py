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
   on, 3 steps of 8 pairs of 256x256 tiles (finite losses, one augmentation call a
   step, the median ms of the last 2 and the peak memory), and one eval forward of 1 pair on
   the card against the same weights on the CPU within ZOO_ATOL (the ViG keys on the
   card's KNN indices, with ZOO_NEIGHBOUR_SHARE of the CPU's own equal to them); then
   cli.train_cd --augment and cli.predict --load_path for SNUNet and ChangeGNNV2.
19. the smp architectures of create_model at smp's default widths, classes 1: Unet
   with scse gates (its eval model with an aux head of 4 classes), UnetPlusPlus over
   vgg16_bn (the center block), MAnet, Linknet over resnext50_32x4d, FPN, FPN over
   mit_b2 (the attention kernels), PSPNet (encoder depth 3), DeepLabV3 over resnet50
   (output stride 8), DeepLabV3+ and PAN (output stride 16), the rest over resnet34:
   each 4 steps of make_seg_steps (augment on, Adam) on 8 images of 256x256, fp32
   (finite losses, one augmentation call a step, the median ms of the last 3 and the
   peak memory), and predict of 1 image on the card against the CPU within ZOO_ATOL;
   FPN over mit_b2 with 16 f32_cuda forward launches in predict and 16 + 16 a train
   step, and one fp32 step with the kernels against the plain attention.
20. the encoder families of get_encoder: SegCD (decoder 256..16, classes 1) over
   efficientnet-b4, timm-efficientnet-b3, mobilenet_v2, timm-mobilenetv3_large_100,
   se_resnext50_32x4d, densenet121, timm-regnety_016, dpn68, xception, inceptionv4,
   timm-res2net50_26w_4s, timm-resnest50d, timm-skresnet34, timm-gernet_m and
   mobileone_s1, each 3 make_cd_steps steps (augment on, Adam, drop_connect live) on
   8 pairs of 256x256, fp32, and DeepLabV3+ over mobilenet_v2 (output stride 16) and
   DeepLabV3 over se_resnext50_32x4d (output stride 8) through create_model, 3
   make_seg_steps steps each (finite losses, one augmentation call a step, the median
   ms of the last 2 and the peak memory); the eval forward of 1 on the card against
   the CPU within ZOO_ATOL; then cli.make_demo_data, cli.train_pse_cd --encoder
   efficientnet-b4 for one epoch and cli.predict --load_path on what it saved.
21. smp's fit loop (utils.meter TrainEpoch / ValidEpoch): (a) the CamVid configuration
   of smp's fit-loop notebook, FPN over se_resnext50_32x4d (sigmoid), 8 seeded 320x320
   pairs a batch through get_training_augmentation on the card and the encoder's
   preprocessing, utils DiceLoss with IoU and Fscore, Adam 1e-4: 6 train batches, 2 valid,
   then 3 with the optimizer swapped to Adam 1e-5 (moments and step kept); (b) a seeded
   synthetic Oxford Pet tree read by SimpleOxfordPetDataset through the loader, FPN over
   resnet34 with losses.smp.DiceLoss(binary), 4 batches of 16 at 256x256, then get_stats
   and iou_score on the held-out batch. Card against CPU: the batched augmentation against
   the per-image path, cutout, get_stats, the smp losses and the FPN-r34 eval forward.
   Median batch ms, images/s, peak memory; the eight kernels' counters do not move.
22. data-parallel training (stcd_tpu_torch/parallel), the ranks in processes of their own
   (this script with --phase22-cli or --phase22-rank): (a) cli.train_pse_cd at full width
   (SegCD-r50, decoder 256..16, 8 pairs of 256x256 from cli.make_demo_data, batch 8,
   fp32, 1 epoch) under torch.distributed.run --nproc_per_node 1 (NCCL, a world of 1) and
   in a plain process, at once, with cuDNN's deterministic algorithms: the two runs'
   weights equal. (b) two ranks on the one card under gloo (initialize(backend="gloo");
   NCCL refuses two ranks on one device): the stage-2 step at global batch 8, fp32, TF32
   off, SGD, 2 steps, each rank holding rows r::2, against the one-process step of this
   process: the first loss within DP_LOSS_RTOL, the counts but for STEP_CM_PIXELS, the
   parameters and running statistics within DP_PARAM_SHARE and DP_STATS_SHARE, both ranks'
   states equal; then bf16 at global batch 64 (32 a rank), 2 warm and 4 timed steps: step
   ms by rank, peak GiB, the
   augmentation kernel's launches (counted in the kernels line).
23. spatial partitioning (stcd_tpu_torch/parallel/spatial.py), the ranks in processes of
   their own, one launch for (a) and (b) (this script with --phase23-rank), started while
   this process takes its one-process steps: (a) two ranks on the one
   card under gloo at a space axis of 2, each holding a strip of 256 rows of every image:
   the stage-2 spatial step of SegCD-r50 (decoder 256..16) at 512x512, global batch 4,
   SGD, 2 steps, in fp32 (TF32 off) and then in bf16, against the one-process step of
   this process on the same batches and draws: the losses, counts, parameters and
   running statistics within the bounds of tools/check_spatial.py (bf16: the SP_BF16_*
   bounds), both ranks' states
   equal; each rank's step ms and peak memory beside the one process's. (b)
   cli.train_pse_cd --space_axis 2 --device cuda:0 at full width (SegCD-r50, 4 pairs of
   512x512, batch 4, 1 epoch: one Adam step) in (a)'s two ranks, so gloo (two ranks on
   one card), then the same CLI in this process: both ranks end with one state; the first loss within LOSS_RTOL,
   the parameters within one Adam step and at least SP_CLI_AGREE of them within 1e-5 of
   the plain run's, the running statistics within SP_CLI_STATS_SHARE. The augmentation
   kernel's launches of (a) and (b) are counted in the kernels line.
24. pipeline parallelism (stcd_tpu_torch/parallel/pipeline.py), four ranks on the one card
   under gloo in one launch for (a)-(d), started while this process computes the
   reference (this script with --phase24-rank), which shows the
   pipeline's cost, not its speed: (a)-(c) tools/check_pipeline.py's runs against this
   process's one-process runs: ChangeFormerV6 at full width, 256x256, batch 8, fp32,
   pp_stages 4, 4 microbatches, one train step and one eval batch with dropout off, then
   a step with attention dropout 0.1 whose microbatches must draw one mask a stage and
   leave the ranks' states and generators equal; base_transformer_pos_s4_dd8 at
   pp_stages 2 x data 2; ChangeGNNV2 at pp_stages 4. Each rank's launches of kernels #1
   and #2 (f32_cuda on V6's stages, small_m on BIT's) must be its blocks times the
   microbatches. (d) cli.train_cd --net_G ChangeFormerV6 --embed_dim 256 --pp_stages 4
   --device cuda:0 in the same four ranks for one epoch of cli.make_demo_data's tree
   (4 pairs: one step). Step ms and peak GiB by rank beside the one process's.
   Phase 3 also holds kernels #1 and #2 against their plain versions with the dropout
   rows (o, t) = (1, 2), f32 and bf16, at M > 8 and M <= 8, and (0, 1) bit-identical to
   the call without rows.
25. tensor parallelism (stcd_tpu_torch/parallel/tensor.py), two ranks on the one card
   under gloo in one launch (this script with --phase25-rank), which shows TP's cost,
   not its speed: tools/check_tensor_parallel.py's runs at model 2 against this
   process's one-process runs: (a) the SegCD-r50 stage-2 step (decoder 256..16, 256x256,
   global batch 8, fp32, SGD, augmentation on) through cli.common's make_mesh /
   place_state and make_cd_steps; (b) CDTrainer(tp_axis=2) over ChangeFormerV6 at embed
   256, 256x256, batch 8, fp32, one step and one eval batch with dropout off, then a
   step with the encoder's attention and MLP dropout at 0.1 after which both ranks hold
   one state and generator; (c) cli.train_cd --net_G base_transformer_pos_s4_dd8
   --tp_axis 2 --device cuda:0 for one epoch of 8 synthetic pairs. Each rank's errors,
   bytes of parameters and Adam moments against one process's, peak GiB, step ms and
   launches of kernels #1 and #2 (on its own heads: f32_cuda for V6's stages 2-4 at
   head offsets h0 = rank x heads / 2, stage 1 whole; small_m for BIT's decoder at
   h0 = 4 rank). Phase 3 also holds kernels #1 and #2 against their plain versions at
   the head offsets (h0, H) = (1, 2) and (4, 8) with rows (1, 2), f32 and bf16, M > 8
   and M <= 8, and (0, h) bit-identical to the call without heads.
26. serving split over replicas (stcd_tpu_torch/serving/replicas.py): the full-width
   ChangeFormerV6 (embed 256, seeded weights), fp32 with TF32 off, tile 256, batch 16,
   behind BatchingEngine(devices=["cuda:0", "cuda:0"]), two replicas from
   cli.predict.make_replicas on the one card, warmed, then
   4 concurrent 512x512 requests: the stitched P(changed) within PROBS_ATOL of the
   one-replica engine's on the same weights and scenes, /stats devices 2, mesh_sharded
   and no error, 13 f32_cuda attention launches a replica step (two a batch). Then
   SegCD-r50 (decoder 256..16) with --int8: two replicas with one scale table against
   the one-replica int8 engine, /stats quantized, the decisions at 0.5 agreeing on at
   least 1 - INT8_F1_TOL of the pixels. The 4-card run of the same path is
   stcd_tpu_torch/tools/check_sharded_serving.py.
27. spatial partitioning beside tensor parallelism (parallel/mesh.py's data x model x
   space grid), four ranks on the one card under gloo in one launch for (a) and (b)
   (this script with --phase27-rank), started while this process takes its one-process
   runs: (a) data 1 x model 2 x space 2 (rank r: model index r // 2, strip r % 2 of 256
   rows), the stage-2 spatial step of SegCD-r50 (decoder 256..16, its 10 wide convs
   split) at 512x512, global batch 4, fp32 (TF32 off), SGD, 2 steps, augmentation on,
   against the one-process step of this process on the same batches and draws: the
   losses, counts, parameters and running statistics within the bounds of
   tools/check_spatial.py, the four ranks' states equal; each rank's step ms and peak
   GiB beside the one process's. (b) cli.train_pse_cd --space_axis 2 --model_axis 2
   --device cuda:0 at phase 23 (b)'s size in (a)'s four ranks, against the same CLI in
   this process, at phase 23 (b)'s bounds. The augmentation kernel's launches of (a)
   and (b) are counted in the kernels line. Every phase prints its seconds.

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
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 64, 2, 5
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
V6_TRAIN = dict(batch=8, size=512, warm=2, steps=5, launches=13, variant="mma_bf16")
V6_FP32_TRAIN = dict(batch=8, size=512, warm=1, steps=3, launches=13)
BIT_TRAIN = dict(batch=32, size=256, warm=2, steps=5, launches=16, variant="small_m")
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


ROWS_SHAPES = ((4, 2, 1000, 37, 64), (4, 8, 1024, 4, 32))  # (B, H, N, M, D): M > 8, M <= 8
HEADS_CASES = ((1, 2), (4, 8))  # (h0, H): heads h0 .. H - 1 of a tensor-parallel rank


def phase_attention_rows(torch, attention):
    """Kernels #1 and #2 with the dropout rows of a sharded batch: at (o, t) =
    (1, 2), dropout 0.1, the forward and the gradients of the kernels against
    autograd through the plain version (within F32_ATOL / BWD_F32_ATOL, bf16
    BF16_ATOL / BWD_BF16_ATOL, of max(1, max|plain|)); at (0, 1) bit-identical
    to the call without rows; (1, 2) keeps another mask than (0, 1). Returns
    the largest forward and backward errors."""
    gen = torch.Generator(device="cpu").manual_seed(9)
    fwd_err = bwd_err = 0.0
    for shape in ROWS_SHAPES:
        b, h, n, m, d = shape
        for dtype, fwd_atol, bwd_atol in ((torch.float32, F32_ATOL, BWD_F32_ATOL),
                                          (torch.bfloat16, BF16_ATOL, BWD_BF16_ATOL)):
            q, k, v, g = (torch.randn(b, h, rows, d, generator=gen).to("cuda", dtype)
                          for rows in (n, m, m, n))

            def run(impl, rows=None):
                leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
                kw = {} if rows is None else {"dropout_rows": rows}
                out = attention.cross_attention(*leaves, dropout_rate=0.1, dropout_seed=77,
                                                impl=impl, **kw)
                return out.detach(), torch.autograd.grad(out, leaves, g)

            (out, grads), (want, want_grads) = run("kernel", (1, 2)), run("plain", (1, 2))
            default, explicit, moved = run("kernel"), run("kernel", (0, 1)), out
            torch.cuda.synchronize()
            name = f"{shape} {str(dtype).replace('torch.', '')} " \
                   f"[{attention.select_variant(dtype, m)}]"
            err = (out.float() - want.float()).abs().max().item()
            bound = fwd_atol * max(1.0, want.float().abs().max().item())
            require(err <= bound, f"attention rows (1, 2) {name}: forward {err} > {bound}")
            errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(grads, want_grads)]
            bounds = [bwd_atol * max(1.0, w.float().abs().max().item()) for w in want_grads]
            require(all(e <= c for e, c in zip(errs, bounds)),
                    f"attention rows (1, 2) {name}: dq, dk, dv {errs} > {bounds}")
            require(torch.equal(default[0], explicit[0])
                    and all(torch.equal(x, y) for x, y in zip(default[1], explicit[1])),
                    f"attention rows (0, 1) {name}: not bit-identical to the call without rows")
            require(not torch.equal(moved, default[0]),
                    f"attention rows {name}: (1, 2) kept the mask of (0, 1)")
            print(f"attention rows (o, t) = (1, 2) {name} dropout 0.1: forward {err:.3e}, "
                  f"dq dk dv {[f'{e:.3e}' for e in errs]} against plain; (0, 1) "
                  f"bit-identical to no rows", flush=True)
            fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, *errs)
            for h0, total in HEADS_CASES:  # a tensor-parallel rank's heads h0 .. H - 1 of H
                lq, lk, lv, lg = (t.repeat(1, total, 1, 1)[:, :total - h0].contiguous()
                                  for t in (q, k, v, g))

                def run_heads(impl, heads):
                    leaves = tuple(t.clone().requires_grad_() for t in (lq, lk, lv))
                    kw = {} if heads is None else {"dropout_heads": heads}
                    out = attention.cross_attention(*leaves, dropout_rate=0.1,
                                                    dropout_seed=77, impl=impl,
                                                    dropout_rows=(1, 2), **kw)
                    return out.detach(), torch.autograd.grad(out, leaves, lg)

                (out, grads), (want, want_grads) = (run_heads("kernel", (h0, total)),
                                                    run_heads("plain", (h0, total)))
                default, own = run_heads("kernel", None), run_heads("kernel", (0, total - h0))
                torch.cuda.synchronize()
                tag = f"attention heads (h0, H) = ({h0}, {total}), rows (1, 2) {name}"
                err = (out.float() - want.float()).abs().max().item()
                bound = fwd_atol * max(1.0, want.float().abs().max().item())
                require(err <= bound, f"{tag}: forward {err} > {bound}")
                errs = [(a.float() - w.float()).abs().max().item()
                        for a, w in zip(grads, want_grads)]
                bounds = [bwd_atol * max(1.0, w.float().abs().max().item()) for w in want_grads]
                require(all(e <= c for e, c in zip(errs, bounds)),
                        f"{tag}: dq, dk, dv {errs} > {bounds}")
                require(torch.equal(default[0], own[0])
                        and all(torch.equal(x, y) for x, y in zip(default[1], own[1])),
                        f"{tag}: (0, h) not bit-identical to the call without heads")
                require(not torch.equal(out, default[0]),
                        f"{tag}: the offset kept the mask of (0, h)")
                print(f"{tag} dropout 0.1: forward {err:.3e}, dq dk dv "
                      f"{[f'{e:.3e}' for e in errs]} against plain; (0, h) bit-identical to "
                      "no heads", flush=True)
                fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, *errs)
    return fwd_err, bwd_err


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
    kernel.launches_by_device.clear()
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
ZOO_TRAIN = dict(batch=8, size=256, steps=3, cli_steps=2, cpu_batch=1)
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
    augment on, seeded weights (models.factory.init_weights) and data, ZOO_TRAIN's
    train steps of 8 pairs of 256x256 tiles: finite losses, one augmentation call a
    step (counted from 0), the median ms of the steps after the first (CUDA events) and
    the peak memory. Then one
    eval forward of ZOO_TRAIN's cpu_batch pairs on the card held against the
    same weights on the CPU (ZOO_ATOL; the ViG keys on the card's neighbours, ZOO_NEIGHBOUR_SHARE).
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


# phase 19: the smp architectures of create_model at smp's default widths
# (label, arch, encoder, create_model keywords); classes=1 for each
SMP_MODELS = (
    ("unet_scse", "unet", "resnet34", dict(decoder_attention_type="scse")),
    ("unetplusplus", "unetplusplus", "vgg16_bn", {}),
    ("manet", "manet", "resnet34", {}),
    ("linknet", "linknet", "resnext50_32x4d", {}),
    ("fpn", "fpn", "resnet34", {}),
    ("fpn_mit_b2", "fpn", "mit_b2", {}),
    ("pspnet", "pspnet", "resnet34", {}),
    ("deeplabv3", "deeplabv3", "resnet50", {}),
    ("deeplabv3plus", "deeplabv3plus", "resnet34", {}),
    ("pan", "pan", "resnet34", {}),
)
SMP_AUX = {"classes": 4}  # the aux head of unet_scse's eval check (trained without it)
SMP_TRAIN = dict(batch=8, size=256, steps=4, cpu_batch=1)  # the first step is not timed
SMP_MIT_LAUNCHES = 16  # SRA calls of mit_b2 a forward: depths 3 + 4 + 6 + 3


def phase_smp(torch, attention, augment_kernel, gpu_label):
    """create_model's architectures at smp's default widths on the card:
    each model of SMP_MODELS (classes 1, seeded weights
    ``models.segcd.init_weights``) takes SMP_TRAIN["steps"] train steps
    of make_seg_steps(augment=True) with Adam on 8 images of 256x256, fp32
    with TF32 off, one fixed seeded batch: finite losses, one augmentation
    call a step (counted from 0), the median ms of the steps after the first
    (CUDA events) and the peak memory. Its eval forward (``predict``) of cpu_batch
    images on the card is held against the same weights on the CPU within
    ZOO_ATOL x max(1, max |CPU|); unet_scse's eval model carries the aux head
    (both outputs held), and the model it trains has none. fpn_mit_b2 runs the
    attention kernels: SMP_MIT_LAUNCHES f32_cuda forward launches in predict
    and as many forward and backward a train step, and one fp32 train step
    with the kernels against one with the plain attention (same weights,
    batch and generator seed) within ATTN_STEP_LOSS_ATOL.
    Returns (augmentation calls, attention forward launches, backward
    launches) of the path."""
    import copy

    from stcd_tpu_torch.data.augment import eval_preprocess
    from stcd_tpu_torch.models import create_model
    from stcd_tpu_torch.models.segcd import init_weights
    from stcd_tpu_torch.tools.profile_step import plain_attention, seeded_stage_batch
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_seg_steps

    n, size, steps, m = (SMP_TRAIN[k] for k in ("batch", "size", "steps", "cpu_batch"))
    data = seeded_stage_batch(1, n, size, seed=7, device="cuda")
    x = eval_preprocess(data["image"][:m]).permute(0, 3, 1, 2).contiguous()
    train_step, _ = make_seg_steps(augment=True)

    def build(arch, encoder, kw):
        return init_weights(create_model(arch, encoder, classes=1, device="cuda", **kw),
                            seed=0)

    def one_step(arch, encoder, kw, batch):
        state = create_train_state(build(arch, encoder, kw), adam_poly(1e-3, 60, 1000),
                                   device="cuda", seed=8)
        return float(train_step(state, batch, state.generator)["loss"])

    aug_calls, attn_fwd, attn_bwd, rows = 0, 0, 0, {}
    for label, arch, encoder, kw in SMP_MODELS:
        mit = encoder.startswith("mit")
        # the eval forward on the card and on the CPU, same weights and inputs
        model = build(arch, encoder, {**kw, **({"aux_params": SMP_AUX} if label == "unet_scse"
                                              else {})})
        kernel = reset_attention_counts(attention)
        card = model.predict(x)
        torch.cuda.synchronize()
        eval_fwd = kernel.kernel_launches
        cpu = copy.deepcopy(model).cpu().predict(x.cpu())
        card, cpu = (list(o) if isinstance(o, tuple) else [o] for o in (card, cpu))
        errs = [((c.cpu() - w).abs().max().item(), ZOO_ATOL * max(1.0, w.abs().max().item()))
                for c, w in zip(card, cpu)]
        require(len(card) == (2 if label == "unet_scse" else 1)
                and card[0].shape == (m, 1, size, size)
                and all(bool(torch.isfinite(c).all()) for c in card)
                and all(e <= b for e, b in errs),
                f"{label}: card forward {[tuple(c.shape) for c in card]} against the CPU's: "
                f"max|err| and bounds {errs}")
        require(eval_fwd == (SMP_MIT_LAUNCHES if mit else 0)
                and set(kernel.forward_variants) <= {"f32_cuda"},
                f"{label}: {eval_fwd} attention launches in predict "
                f"{dict(kernel.forward_variants)}")
        del model, card, cpu
        # the train steps
        state = create_train_state(build(arch, encoder, kw), adam_poly(1e-3, 60, 1000),
                                   device="cuda", seed=8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        augment_kernel.kernel_launches = 0
        kernel = reset_attention_counts(attention)
        losses, times = [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = train_step(state, data, state.generator)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            losses.append(float(out["loss"]))
        calls = augment_kernel.kernel_launches
        fwd, bwd = kernel.kernel_launches, kernel.backward_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = SMP_MIT_LAUNCHES * steps if mit else 0
        require(all(v == v and abs(v) != float("inf") for v in losses) and calls == steps
                and state.step == steps,
                f"{label}: losses {losses}, {calls} augmentation calls and {state.step} "
                f"updates for {steps} steps")
        require(fwd == want and bwd == want and set(kernel.forward_variants) <= {"f32_cuda"}
                and set(kernel.backward_variants) <= {"f32_cuda"},
                f"{label}: {fwd} forward and {bwd} backward attention launches "
                f"{dict(kernel.forward_variants)} {dict(kernel.backward_variants)}, not {want}")
        aug_calls += calls
        attn_fwd += eval_fwd + fwd
        attn_bwd += bwd
        timed = sorted(times[1:])
        rows[label] = {"step_ms": timed[len(timed) // 2], "peak_gib": peak}
        print(f"smp {label} ({arch}, {encoder}; {gpu_label}): {steps} train steps of {n} "
              f"images at {size}x{size}, fp32, augment, Adam: losses "
              f"{[round(v, 4) for v in losses]}, step ms {[round(t, 2) for t in times]} "
              f"(median of the last {steps - 1} {rows[label]['step_ms']:.2f}), peak "
              f"{peak:.2f} GiB, {calls} augmentation calls"
              + (f", attention {eval_fwd} launches in predict and {fwd} + {bwd} in the steps, "
                 f"all f32_cuda" if mit else "")
              + f"; predict of {m} images, card against CPU: max|err| "
              + ", ".join(f"{e:.3e} (bound {b:.3e})" for e, b in errs), flush=True)
        del state, out
        torch.cuda.empty_cache()
        if mit:  # one fp32 step with the kernels and one with the plain attention
            small = {k: v[:m] for k, v in data.items()}
            kernel = reset_attention_counts(attention)
            got = one_step(arch, encoder, kw, small)
            launched = kernel.kernel_launches + kernel.backward_launches
            with plain_attention():
                plain = one_step(arch, encoder, kw, small)
            require(launched == 2 * SMP_MIT_LAUNCHES and kernel.kernel_launches
                    + kernel.backward_launches == launched,
                    f"{label}: {launched} launches with the kernels, "
                    f"{kernel.kernel_launches + kernel.backward_launches - launched} plain")
            d_loss = abs(got - plain)
            print(f"smp {label}: one fp32 train step of {m} images, kernels against plain "
                  f"attention: loss {got:.6f} vs {plain:.6f} (|d|={d_loss:.2e}, atol "
                  f"{ATTN_STEP_LOSS_ATOL})", flush=True)
            require(d_loss <= ATTN_STEP_LOSS_ATOL, f"{label}: step losses differ by {d_loss}")
            torch.cuda.empty_cache()
    print("smp step table: " + json.dumps(rows), flush=True)
    return aug_calls, attn_fwd, attn_bwd


# phase 20: SegCD over one encoder of each family beyond ResNet, VGG and MiT, at
# the published configs, the way cli/common.py::build_state builds it
ENC_ZOO = ("efficientnet-b4", "timm-efficientnet-b3", "mobilenet_v2",
           "timm-mobilenetv3_large_100", "se_resnext50_32x4d", "densenet121",
           "timm-regnety_016", "dpn68", "xception", "inceptionv4", "timm-res2net50_26w_4s",
           "timm-resnest50d", "timm-skresnet34", "timm-gernet_m", "mobileone_s1")
# (label, arch, encoder): dilated encoders through create_model, make_seg_steps
ENC_ZOO_DILATED = (("deeplabv3plus_mobilenet_v2_os16", "deeplabv3plus", "mobilenet_v2"),
                   ("deeplabv3_se_resnext50_os8", "deeplabv3", "se_resnext50_32x4d"))
ENC_ZOO_TRAIN = dict(batch=8, size=256, steps=3, cpu_batch=1)  # the first step is not timed
ENC_ZOO_DECODER = (256, 128, 64, 32, 16)
ENC_ZOO_CLI = dict(encoder="efficientnet-b4", n=8, size=256, batch=4)  # 2 steps an epoch


def phase_encoder_zoo(torch, augment_kernel, gpu_label):
    """The encoder families of get_encoder on the card: SegCD over each
    encoder of ENC_ZOO (decoder ENC_ZOO_DECODER, classes 1, seeded
    ``models.segcd.init_weights``) takes ENC_ZOO_TRAIN["steps"] steps of
    make_cd_steps(augment=True) with Adam and the Poly schedule on 8 pairs of
    256x256, fp32 with TF32 off, one fixed seeded batch
    (tools/profile_step.py::seeded_stage_batch), drop_connect live; the two
    dilated models of ENC_ZOO_DILATED take as many make_seg_steps steps.
    Requires finite losses, one augmentation call a step (counted from 0) and
    state.step == steps; prints the losses, the median ms of the steps after
    the first (CUDA events) and the peak memory. The eval forward of cpu_batch
    pairs (images for the DeepLabs) on the card is held against the same weights
    on the CPU within ZOO_ATOL x max(1, max |CPU|). Then from the command
    line: cli.make_demo_data, cli.train_pse_cd --encoder efficientnet-b4 for
    one epoch, and cli.predict --encoder efficientnet-b4 --load_path on what
    it saved. Returns the augmentation calls of the steps and of the CLI run."""
    import copy

    import numpy as np

    from stcd_tpu_torch.cli import make_demo_data, predict, train_pse_cd
    from stcd_tpu_torch.data.augment import eval_preprocess
    from stcd_tpu_torch.models import create_model
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.tools.profile_step import seeded_stage_batch
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps, make_seg_steps

    n, size, steps, m = (ENC_ZOO_TRAIN[k] for k in ("batch", "size", "steps", "cpu_batch"))
    pairs = seeded_stage_batch(2, n, size, seed=9, device="cuda")
    images = seeded_stage_batch(1, n, size, seed=10, device="cuda")
    cd_step, _ = make_cd_steps(augment=True)
    seg_step, _ = make_seg_steps(augment=True)
    models = [(name, "segcd", name) for name in ENC_ZOO] + list(ENC_ZOO_DILATED)

    def build(arch, encoder):
        if arch == "segcd":
            model = SegCD(encoder, classes=1, decoder_channels=ENC_ZOO_DECODER, device="cuda")
        else:
            model = create_model(arch, encoder, classes=1, device="cuda")
        return init_weights(model, seed=0)

    aug_calls, rows = 0, {}
    for label, arch, encoder in models:
        cd = arch == "segcd"
        model = build(arch, encoder).eval()
        ins = ([eval_preprocess(pairs[k][:m]).permute(0, 3, 1, 2).contiguous()
                for k in ("A", "B")] if cd else
               [eval_preprocess(images["image"][:m]).permute(0, 3, 1, 2).contiguous()])
        with torch.no_grad():
            card = model(*ins) if cd else model.predict(*ins)
            cpu = copy.deepcopy(model).cpu()(*(t.cpu() for t in ins)) if cd else \
                copy.deepcopy(model).cpu().predict(*(t.cpu() for t in ins))
        card, cpu = (list(o) if isinstance(o, (tuple, list)) else [o] for o in (card, cpu))
        errs = [((c.cpu() - w).abs().max().item(), ZOO_ATOL * max(1.0, w.abs().max().item()))
                for c, w in zip(card, cpu)]
        require(len(card) == len(cpu) and card[-1].shape[-2:] == (size, size)
                and all(bool(torch.isfinite(c).all()) for c in card)
                and all(e <= b for e, b in errs),
                f"{label}: card forward {[tuple(c.shape) for c in card]} against the CPU's: "
                f"max|err| and bounds {errs}")
        del model, card, cpu
        state = create_train_state(build(arch, encoder), adam_poly(1e-3, 60, 1000),
                                   device="cuda", seed=8)
        step, data = (cd_step, pairs) if cd else (seg_step, images)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        augment_kernel.kernel_launches = 0
        losses, times = [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(state, data, state.generator)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            losses.append(float(out["loss"]))
        calls = augment_kernel.kernel_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(all(v == v and abs(v) != float("inf") for v in losses) and calls == steps
                and state.step == steps,
                f"{label}: losses {losses}, {calls} augmentation calls and {state.step} "
                f"updates for {steps} steps")
        aug_calls += calls
        timed = sorted(times[1:])
        rows[label] = {"step_ms": timed[len(timed) // 2], "peak_gib": peak}
        print(f"encoder zoo {label} ({arch}, {encoder}; {gpu_label}): {steps} "
              f"{'make_cd_steps' if cd else 'make_seg_steps'} steps of {n} "
              f"{'pairs' if cd else 'images'} at {size}x{size}, fp32, augment, Adam: losses "
              f"{[round(v, 4) for v in losses]}, step ms {[round(t, 2) for t in times]} "
              f"(median of the last {steps - 1} {rows[label]['step_ms']:.2f}), peak "
              f"{peak:.2f} GiB, {calls} augmentation calls; eval of {m}, card against CPU: "
              "max|err| " + ", ".join(f"{e:.3e} (bound {b:.3e})" for e, b in errs), flush=True)
        del state, out
        torch.cuda.empty_cache()
    print("encoder zoo step table: " + json.dumps(rows), flush=True)

    # from the command line: the demo tree, train_pse_cd, then predict on what it saved
    cli = ENC_ZOO_CLI
    with tempfile.TemporaryDirectory() as root:
        data, save = os.path.join(root, "data"), os.path.join(root, "runs", "psecd")
        make_demo_data.main([data, "--n", str(cli["n"]), "--size", str(cli["size"])])
        augment_kernel.kernel_launches = 0
        t0 = time.monotonic()
        try:
            out = train_pse_cd.main([
                "--root_path", data, "--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR",
                "--encoder", cli["encoder"], "--batch_size", str(cli["batch"]),
                "--n_epochs", "1", "--img_height", str(cli["size"]), "--img_width",
                str(cli["size"]), "--save_name", save, "--device", "cuda"])
        finally:
            from stcd_tpu_torch.data import io as data_io
            data_io.set_uint8_transfer(False)
        torch.cuda.synchronize()
        cli_calls = augment_kernel.kernel_launches
        want = cli["n"] // cli["batch"]
        require(out["state"].step == want and cli_calls == want
                and "last_ckpt" in os.listdir(save),
                f"train_pse_cd --encoder {cli['encoder']}: step {out['state'].step}, "
                f"{cli_calls} augmentation calls, {sorted(os.listdir(save))}")
        val = os.path.join(data, "LEVIR", "val")
        mask, prob = os.path.join(root, "mask.png"), os.path.join(root, "prob.npy")
        predict.main(["--encoder", cli["encoder"], "--load_path", save,
                      "--image_a", os.path.join(val, "A", "0.png"),
                      "--image_b", os.path.join(val, "B", "0.png"), "--out", mask,
                      "--prob_out", prob, "--tile", str(cli["size"]), "--device", "cuda"])
        probs = np.load(prob)
        require(os.path.isfile(mask) and probs.shape == (cli["size"], cli["size"], 1)
                and np.isfinite(probs).all() and 0 <= probs.min() and probs.max() <= 1,
                f"predict --encoder {cli['encoder']}: {probs.shape} probabilities")
        print(f"encoder zoo cli ({gpu_label}): train_pse_cd --encoder {cli['encoder']}, 1 epoch "
              f"of {want} steps of {cli['batch']} pairs at {cli['size']}x{cli['size']} in "
              f"{time.monotonic() - t0:.1f} s (host clock, eval and saves included), "
              f"{cli_calls} augmentation calls, best IoU {out['best']:.4f}; predict "
              f"--load_path wrote a {cli['size']}x{cli['size']} mask", flush=True)
        del out
        torch.cuda.empty_cache()
    return {"encoder_zoo": aug_calls, "encoder_zoo_cli": cli_calls}


# phase 21: smp's fit loop (utils.meter) over create_model: the CamVid configuration of
# smp's fit-loop notebook, then the Oxford Pet configuration of its binary example
SMP_FIT = dict(encoder="se_resnext50_32x4d", batch=8, size=320, train=6, valid=2, swap=3,
               lr=1e-4, swap_lr=1e-5)
PET_FIT = dict(encoder="resnet34", batch=16, batches=4, n_trainval=72, n_test=8, valid_batch=8,
               cpu_batch=2, lr=1e-4)
AUG_ATOL, AUG_MASK_SHARE = 1e-4, 0.999  # batched card against the per-image CPU path
SMP_LOSS_RTOL = 1e-5  # each smp loss, card against CPU on one fixed pair
FIT_FWD_ATOL = 1e-4  # FPN-r34 eval forward, card against CPU, times max(1, max |CPU|)


def kernel_counts(attention, augment) -> dict:
    """The launch counters of the eight kernels' wrappers."""
    from stcd_tpu_torch.ops import bn_stats, matmul_stats
    return {"cross_attention": attention.cross_attention_kernel.kernel_launches,
            "cross_attention_bwd": attention.cross_attention_kernel.backward_launches,
            "augment": augment.apply_augment_kernel.kernel_launches,
            "bn_stats": bn_stats.bn_stats_kernel.kernel_launches,
            **{name: getattr(matmul_stats, name + "_kernel").kernel_launches
               for name in ("matmul_stats", "matmul_bf16", "matmul_stats_rows",
                            "matmul_stats_mma")}}


def seeded_street_batches(torch, n_batches: int, batch: int, size: int, seed: int) -> list:
    """Stand-ins for CamVid's car masks, on the card: images of noise in [0, 0.6]
    with one to four axis-aligned boxes ("cars") of a colour of their own, and
    masks of 1 on the boxes; drawn on the CPU from ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for _ in range(n_batches):
        img = torch.rand(batch, size, size, 3, generator=gen) * 0.6
        mask = torch.zeros(batch, size, size, 1)
        for i in range(batch):
            for _ in range(int(torch.randint(1, 5, (1,), generator=gen))):
                h, w = (int(v) for v in torch.randint(size // 10, size // 3, (2,), generator=gen))
                y, x = (int(v) for v in torch.randint(0, size - max(h, w), (2,), generator=gen))
                mask[i, y:y + h, x:x + w] = 1.0
                img[i, y:y + h, x:x + w] = (0.5 * img[i, y:y + h, x:x + w]
                                            + 0.5 * torch.rand(3, generator=gen))
        out.append((img.cuda(), mask.cuda()))
    return out


def timed_batches(torch, batches, events: list):
    """Yield ``batches``, recording a CUDA event before each and one after the
    last: event i to i + 1 spans batch i's update and its log reads."""
    for batch in batches:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        yield batch
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()


def batch_ms(events: list) -> list:
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def phase_smp_fit(torch, counters, gpu_label):
    """smp's fit loop on the card, fp32 with TF32 off.

    (a) The CamVid configuration of smp's fit-loop notebook: FPN over
    se_resnext50_32x4d, classes 1, activation sigmoid (seeded weights),
    utils.meter.DiceLoss with IoU and Fscore at threshold 0.5, Adam 1e-4;
    batches of 8 seeded 320x320 image and mask pairs through
    get_training_augmentation (batched, on the state's generator) and the
    encoder's preprocessing; TrainEpoch over 6 batches, ValidEpoch over 2,
    then TrainEpoch(tx=Adam 1e-5) over 3, which must keep the optimizer, its
    moments and the step count. (b) Oxford Pet: a seeded synthetic tree in the
    dataset's layout, SimpleOxfordPetDataset in train and valid mode through
    the loader; FPN over resnet34 (classes 1), losses.smp.DiceLoss('binary',
    from_logits=True), TrainEpoch over 4 batches of 16 at 256x256; then
    get_stats and iou_score (micro, micro-imagewise) on the held-out batch.

    Card against the CPU on the same draws and weights: the batched
    augmentation against the per-image CPU path (images within AUG_ATOL,
    masks equal on AUG_MASK_SHARE of the pixels: a perspective solve may move
    a coordinate across a rounding boundary), cutout equal with the fill
    injected, get_stats' counts equal, each smp loss within SMP_LOSS_RTOL, the
    FPN-r34 eval forward within FIT_FWD_ATOL x max(1, max |CPU|). Prints the
    median batch ms after the first (CUDA events), images/s, peak memory,
    each epoch's logs and the step count around the swap. This path launches
    none of the eight kernels: their counters are read before and after."""
    import copy

    from stcd_tpu_torch import losses, metrics
    from stcd_tpu_torch.data import augment as aug
    from stcd_tpu_torch.data.loader import DataLoader
    from stcd_tpu_torch.data.oxford_pet import SimpleOxfordPetDataset, write_synthetic_tree
    from stcd_tpu_torch.encoders import get_preprocessing_fn
    from stcd_tpu_torch.models import create_model
    from stcd_tpu_torch.models.segcd import init_weights
    from stcd_tpu_torch.train.state import AdamConfig, create_train_state
    from stcd_tpu_torch.utils import meter

    t_phase = time.monotonic()
    before = counters()
    cfg = SMP_FIT
    n, size = cfg["batch"], cfg["size"]
    data = seeded_street_batches(torch, cfg["train"] + cfg["valid"] + cfg["swap"], n, size,
                                 seed=21)

    # the augmentation and the losses, card against CPU
    gen = torch.Generator(device="cuda").manual_seed(21)
    img0, mask0 = data[0]
    params = aug.sample_training_augmentation_params(gen, n, size, size)
    card_i, card_m = aug.apply_training_augmentation(img0, mask0, params)
    cpu_params = aug.params_to(params, "cpu")
    per_image = [aug.apply_training_augmentation(img0[i:i + 1].cpu(), mask0[i:i + 1].cpu(),
                                                 aug.select_params(cpu_params, i))
                 for i in range(n)]
    aug_err = (card_i.cpu() - torch.cat([p[0] for p in per_image])).abs().max().item()
    mask_share = (card_m.cpu() == torch.cat([p[1] for p in per_image])).float().mean().item()
    require(aug_err <= AUG_ATOL and mask_share >= AUG_MASK_SHARE
            and bool(torch.isfinite(card_i).all()),
            f"augmentation card against per-image CPU: max|err| {aug_err:.3e} (bound "
            f"{AUG_ATOL}), masks equal on {mask_share:.6f} (bound {AUG_MASK_SHARE})")
    cut = aug.sample_cutout_params(gen, n, size, size, p=1.0)
    card_cut = aug.cutout(None, img0, img0.flip(0), mask0, params=cut)
    cpu_cut = aug.cutout(None, img0.cpu(), img0.flip(0).cpu(), mask0.cpu(),
                         params=aug.params_to(cut, "cpu"))
    require(all(torch.equal(a.cpu(), b) for a, b in zip(card_cut, cpu_cut)),
            "cutout on the card differs from the CPU's with the same fill")
    lgen = torch.Generator(device="cpu").manual_seed(22)
    logits = torch.randn(2, 3, 64, 64, generator=lgen) * 2
    binary_t = (torch.rand(2, 1, 64, 64, generator=lgen) > 0.5).float()
    multi_t = torch.randint(0, 3, (2, 64, 64), generator=lgen)
    label_t = (torch.rand(2, 3, 64, 64, generator=lgen) > 0.5).float()
    loss_cases = [(f"{cls}({mode})", getattr(losses, cls)(mode=mode), x, t)
                  for cls in ("DiceLoss", "JaccardLoss", "TverskyLoss", "FocalLoss", "LovaszLoss")
                  for mode, x, t in (("binary", logits[:, :1], binary_t),
                                     ("multiclass", logits, multi_t),
                                     ("multilabel", logits, label_t))]
    loss_cases += [("SoftBCEWithLogitsLoss", losses.SoftBCEWithLogitsLoss(smooth_factor=0.1),
                    logits, label_t),
                   ("SoftCrossEntropyLoss", losses.SoftCrossEntropyLoss(smooth_factor=0.1),
                    logits, multi_t),
                   ("MCCLoss", losses.MCCLoss(), logits[:, :1].sigmoid(), binary_t)]
    loss_errs = {}
    for name, fn, x, t in loss_cases:
        want = fn(x, t).item()
        got = fn(x.cuda(), t.cuda()).item()
        loss_errs[name] = abs(got - want) / max(abs(want), 1e-12)
    require(max(loss_errs.values()) <= SMP_LOSS_RTOL,
            f"smp losses card against CPU, relative errors {loss_errs}")

    # (a) the CamVid configuration through TrainEpoch, ValidEpoch and the tx swap
    preprocess = get_preprocessing_fn(cfg["encoder"])
    model = init_weights(create_model("FPN", encoder_name=cfg["encoder"], classes=1,
                                      activation="sigmoid", device="cuda"), seed=0)
    state = create_train_state(model, AdamConfig(lambda step: cfg["lr"]), device="cuda", seed=5)
    fn = aug.get_training_augmentation()
    aug_events, batches = [], []
    for k, (img, mask) in enumerate(data):
        if k < cfg["train"] or k >= cfg["train"] + cfg["valid"]:
            aug_events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
            aug_events[-1][0].record()
            img, mask = fn(state.generator, img, mask)
            aug_events[-1][1].record()
        batches.append({"image": preprocess(img), "label": mask})
    torch.cuda.synchronize()
    aug_ms = sorted(a.elapsed_time(b) for a, b in aug_events)
    train_b = batches[:cfg["train"]]
    valid_b = batches[cfg["train"]:cfg["train"] + cfg["valid"]]
    swap_b = batches[cfg["train"] + cfg["valid"]:]
    loss = meter.DiceLoss()
    mets = [meter.IoU(threshold=0.5), meter.Fscore(threshold=0.5)]
    torch.cuda.reset_peak_memory_stats()
    events = []
    state, train_logs = meter.TrainEpoch(model, loss, mets).run(
        state, timed_batches(torch, train_b, events))
    train_ms = batch_ms(events)
    state, valid_logs = meter.ValidEpoch(model, loss, mets).run(state, valid_b)
    step_before, optimizer = state.step, state.optimizer
    events = []
    state, swap_logs = meter.TrainEpoch(model, loss, mets,
                                        tx=AdamConfig(lambda step: cfg["swap_lr"])).run(
        state, timed_batches(torch, swap_b, events))
    swap_ms = batch_ms(events)
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    adam_steps = {int(s["step"]) for s in state.optimizer.state.values()}
    logs = (train_logs, valid_logs, swap_logs)
    require(all(v == v and abs(v) != float("inf") for d in logs for v in d.values())
            and set(train_logs) == {"loss", "iou_score", "fscore"}
            and step_before == cfg["train"] and state.step == cfg["train"] + cfg["swap"]
            and state.optimizer is optimizer and adam_steps == {state.step}
            and state.optimizer.param_groups[0]["lr"] == cfg["swap_lr"],
            f"smp fit (a): logs {logs}, step {step_before} -> {state.step}, Adam steps "
            f"{adam_steps}, optimizer kept {state.optimizer is optimizer}")
    timed = sorted(train_ms[1:] + swap_ms[1:])
    med_a = timed[len(timed) // 2]
    print(f"smp fit (a) ({gpu_label}): FPN {cfg['encoder']} (sigmoid), {n} images of "
          f"{size}x{size} a batch, fp32, utils DiceLoss, IoU and Fscore at 0.5; augmentation "
          f"ms a batch {[round(t, 2) for t in aug_ms]}; TrainEpoch Adam {cfg['lr']} over "
          f"{cfg['train']} batches: ms {[round(t, 2) for t in train_ms]}, logs {train_logs}; "
          f"ValidEpoch over {cfg['valid']}: {valid_logs}; TrainEpoch(tx=Adam {cfg['swap_lr']}) "
          f"over {cfg['swap']}: ms {[round(t, 2) for t in swap_ms]}, logs {swap_logs}; step "
          f"{step_before} -> {state.step}, the optimizer and its moments kept (Adam step "
          f"{sorted(adam_steps)}); median batch ms after the first {med_a:.2f} "
          f"({n / med_a * 1e3:.1f} images/s), peak {peak_a:.2f} GiB", flush=True)
    del state, model, optimizer, batches, data
    torch.cuda.empty_cache()

    # (b) Oxford Pet: the dataset's layout on disk, the loader, FPN-r34
    pet = PET_FIT
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        write_synthetic_tree(root, pet["n_trainval"], pet["n_test"], seed=7)
        t_write = time.monotonic() - t0
        train_ds, valid_ds = (SimpleOxfordPetDataset(root, mode) for mode in ("train", "valid"))
        require(len(train_ds) == pet["batch"] * pet["batches"]
                and len(valid_ds) == pet["valid_batch"],
                f"Oxford Pet splits: {len(train_ds)} train, {len(valid_ds)} valid")
        preprocess = get_preprocessing_fn(pet["encoder"])
        model = init_weights(create_model("FPN", pet["encoder"], classes=1, device="cuda"),
                             seed=1)
        state = create_train_state(model, AdamConfig(lambda step: pet["lr"]), device="cuda",
                                   seed=6)
        loader = DataLoader(train_ds, pet["batch"], shuffle=True, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        t0 = time.monotonic()
        state, pet_logs = meter.TrainEpoch(
            model, losses.DiceLoss("binary", from_logits=True),
            [meter.IoU(threshold=0.5, activation="sigmoid")]).run(
            state, timed_batches(torch, ({"image": preprocess(b["image"]), "label": b["label"]}
                                         for b in loader), events))
        pet_ms = batch_ms(events)
        t_epoch = time.monotonic() - t0
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
        held = next(iter(DataLoader(valid_ds, pet["valid_batch"], device="cuda")))
        x = preprocess(held["image"]).permute(0, 3, 1, 2)
        logits = model.predict(x)
        pred = (logits.sigmoid() > 0.5).long()
        target = held["label"].permute(0, 3, 1, 2).long()
        stats = metrics.get_stats(pred, target, "binary")
        cpu_stats = metrics.get_stats(pred.cpu(), target.cpu(), "binary")
        iou = {r: metrics.iou_score(*stats, reduction=r).item()
               for r in ("micro", "micro-imagewise")}
        m = pet["cpu_batch"]
        with torch.no_grad():
            cpu_logits = copy.deepcopy(model).cpu().predict(x[:m].cpu().contiguous())
        fwd_err = (logits[:m].cpu() - cpu_logits).abs().max().item()
        fwd_bound = FIT_FWD_ATOL * max(1.0, cpu_logits.abs().max().item())
        require(state.step == pet["batches"] and all(v == v for v in pet_logs.values())
                and all(torch.equal(a.cpu(), b) for a, b in zip(stats, cpu_stats))
                and int(sum(s.sum() for s in stats)) == pet["valid_batch"] * 256 * 256
                and all(0.0 <= v <= 1.0 for v in iou.values()) and fwd_err <= fwd_bound,
                f"smp fit (b): step {state.step}, logs {pet_logs}, get_stats card "
                f"{[s.sum().item() for s in stats]} CPU {[s.sum().item() for s in cpu_stats]}, "
                f"iou {iou}, eval forward max|err| {fwd_err:.3e} (bound {fwd_bound:.3e})")
        med_b = sorted(pet_ms[1:])[len(pet_ms[1:]) // 2]
        print(f"smp fit (b) ({gpu_label}): Oxford Pet layout ({pet['n_trainval']} trainval, "
              f"{pet['n_test']} test JPEGs of 300-500 px written in {t_write:.1f} s), "
              f"SimpleOxfordPetDataset through the loader, FPN {pet['encoder']}, losses.smp."
              f"DiceLoss(binary, from_logits), Adam {pet['lr']}: TrainEpoch over "
              f"{pet['batches']} batches of {pet['batch']} at 256x256 in {t_epoch:.2f} s (host "
              f"clock, decode included), batch ms {[round(t, 2) for t in pet_ms]} (median after "
              f"the first {med_b:.2f}, {pet['batch'] / med_b * 1e3:.1f} images/s), peak "
              f"{peak_b:.2f} GiB, logs {pet_logs}; held-out batch of {pet['valid_batch']}: "
              f"get_stats tp/fp/fn/tn {[int(s.sum()) for s in stats]} (equal on the CPU), "
              f"iou_score {iou}; eval forward of {m}, card against CPU: max|err| {fwd_err:.3e} "
              f"(bound {fwd_bound:.3e})", flush=True)
        del state, model
        torch.cuda.empty_cache()
    after = counters()
    require(after == before, f"the smp fit loop launched kernels: {before} -> {after}")
    print(f"smp fit: card against CPU, augmentation max|err| {aug_err:.3e}, masks equal on "
          f"{mask_share:.6f}, cutout equal, smp losses max relative error "
          f"{max(loss_errs.values()):.3e}; kernel counters before and after {after}; phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    return {"a_batch_ms": med_a, "a_peak_gib": peak_a, "b_batch_ms": med_b, "b_peak_gib": peak_b}


# phase 22: data-parallel training (stcd_tpu_torch/parallel) on the card. (a) cli.train_pse_cd
# at full width as one torchrun rank under NCCL, against the same CLI in a plain process;
# (b) two ranks on the one card under gloo (NCCL refuses two ranks on one device), the
# stage-2 step against the one-process step at the same global batch, then bf16 steps
DP_CLI = dict(n=8, size=256, batch=8)  # one epoch of 1 step of SegCD-r50 (CLI defaults)
DP_STEP = dict(batch=8, size=256, steps=2, lr=1e-3)  # fp32, SGD momentum 0.9, 4 pairs a rank
DP_BF16 = dict(batch=64, warm=2, steps=4)  # bf16 autocast, 32 pairs a rank
DP_LOSS_RTOL = 1e-5  # the first step's loss, two ranks against one process
# after DP_STEP's 3 steps, two ranks against one process, |d| over max(1, the tensor's
# largest magnitude): float32 sums in another order and cuDNN's algorithms for 4 pairs
# against those for 8; a running variance E[x^2] - E[x]^2 magnifies that noise. Measured
# on an H100 80GB HBM3 at 700 W: parameters 5.6e-6 (encoder.conv1.weight), running
# statistics 7.7e-5 and 8.3e-5 (encoder.layer4.2.bn1.running_var); the first loss equal
DP_PARAM_SHARE = 3e-5
DP_STATS_SHARE = 5e-4
DP_TIMEOUT = 400  # seconds a launch may take
DP_ENV_DROP = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "TORCHELASTIC_RUN_ID")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tagged(out: str, tag: str) -> list:
    """The JSON objects that follow ``tag`` in ``out``. Ranks share one pipe, so
    another rank's text may stand between an object and its newline: each is
    read to its closing brace."""
    decoder, found, start = json.JSONDecoder(), [], 0
    while (i := out.find(tag + " {", start)) >= 0:
        obj, start = decoder.raw_decode(out, i + len(tag) + 1)
        found.append(obj)
    return found


def print_tagged(tag: str, obj: dict) -> None:
    """One line ``tag {json}`` in one write, which a pipe keeps whole."""
    sys.stdout.write(f"{tag} {json.dumps(obj)}\n")
    sys.stdout.flush()


def launch(cmd: list, timeout: int = DP_TIMEOUT) -> str:
    """Run ``cmd`` in a session of its own and return its output; on a time-out
    the whole session (torchrun and its ranks) is killed. A failure raises."""
    return finish(start(cmd), cmd, timeout)


def start(cmd: list) -> subprocess.Popen:
    """``cmd`` started in a session of its own (``finish`` waits for it)."""
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV_DROP}
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, start_new_session=True)


def finish(proc: subprocess.Popen, cmd: list, timeout: int = DP_TIMEOUT) -> str:
    """The output of ``start(cmd)``'s process; on a time-out its whole session is
    killed. A failure raises."""
    import signal
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{' '.join(cmd[:6])} ... did not end in {timeout} s")
    require(proc.returncode == 0, f"{' '.join(cmd[:6])} ... exited {proc.returncode}:\n"
            f"{out[-4000:]}")
    return out


def wait_for(path: str, timeout: int = DP_TIMEOUT) -> None:
    """Block until ``path`` exists: a rank started before its reference was
    written (so its start-up overlaps the reference's computation) waits here
    before it touches the card."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        require(time.monotonic() - t0 < timeout, f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def save_for_ranks(torch, obj, path: str) -> None:
    """``torch.save`` under a temporary name, then renamed: a waiting rank never
    reads a partial file."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def torchrun(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
            str(nproc), "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
            os.path.abspath(__file__), *args]


def dp_fp32_run(torch, rows) -> dict:
    """DP_STEP's fp32 stage-2 steps (SegCD-r50, decoder 256..16, augmentation on, SGD)
    on the global batches from seeds 10, 11, ..., this process holding ``rows`` of each;
    the draws from one generator on the card seeded 2."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps

    model = init_weights(SegCD("resnet50", classes=1, decoder_channels=(256, 128, 64, 32, 16)),
                         seed=0)
    state = create_train_state(model, SGDConfig(lambda step: DP_STEP["lr"], momentum=0.9,
                                                weight_decay=0.0), device="cuda")
    train_step = make_cd_steps(augment=True)[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    losses, counts = [], []
    for i in range(DP_STEP["steps"]):
        data = seeded_cd_batch(DP_STEP["batch"], DP_STEP["size"], seed=10 + i, device="cuda")
        out = train_step(state, {k: v[rows] for k, v in data.items()}, gen)
        losses.append(float(out["loss"]))
        counts.append(out["cm"].cpu().tolist())
    return {"losses": losses, "counts": counts,
            "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def state_errors(want: dict, got: dict) -> dict:
    """The largest |got - want| / max(1, max |want|) of each group of a
    state_dict (parameters, running means, running variances, counts), as
    (error, name)."""
    errs = {}
    for k, v in want.items():
        group = ("running_var" if k.endswith("running_var") else "running_mean"
                 if k.endswith("running_mean") else "param" if v.is_floating_point()
                 else "count")
        err = ((got[k].double() - v.double()).abs().max().item()
               / max(1.0, v.abs().max().item()))
        errs[group] = max(errs.get(group, (-1.0, "")), (err, k))
    return errs


def phase22_cli(argv) -> int:
    """One process of phase 22 (a) or a rank of phase 23 (b):
    cli.train_pse_cd.main(argv) with cuDNN's deterministic algorithms, so that
    two runs can be held to equal weights."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print_tagged("PHASE22_CLI", deterministic_cli(argv))
    return 0


def deterministic_cli(argv) -> dict:
    """cli.train_pse_cd.main(argv) with TF32 off and cuDNN's deterministic
    algorithms (the flags put back after): its step, augmentation launches,
    world and device."""
    import torch
    from stcd_tpu_torch.cli import train_pse_cd
    from stcd_tpu_torch.data import io as data_io
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.parallel import distributed

    kept = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    kept_uint8 = data_io._UINT8_TRANSFER
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    augment.apply_augment_kernel.kernel_launches = 0
    try:
        out = train_pse_cd.main(argv)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = kept
        data_io.set_uint8_transfer(kept_uint8)
    return {"launches": augment.apply_augment_kernel.kernel_launches,
            "step": out["state"].step, "world": distributed.world_size(),
            "device": str(out["state"].device),
            "backend": torch.distributed.get_backend() if distributed.is_initialized()
            else None}


def phase22_rank(out_dir: str) -> int:
    """One of the two ranks of phase 22 (b), on cuda:0 under gloo."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch, stage_setup

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize("cuda:0", backend="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    require(world == 2 and torch.distributed.get_backend() == "gloo" and device.index == 0,
            f"rank {rank}: world {world}, {torch.distributed.get_backend()}, {device}")
    rows = distributed.global_batch_sharding()
    wait_for(os.path.join(out_dir, "go"))
    augment.apply_augment_kernel.kernel_launches = 0
    t0 = time.monotonic()
    fp32 = dp_fp32_run(torch, rows)
    fp32_s = time.monotonic() - t0
    torch.save(fp32["state"], os.path.join(out_dir, f"rank{rank}.pt"))

    state, train_step, _ = stage_setup(2, bf16=True)
    data = seeded_cd_batch(DP_BF16["batch"], DP_STEP["size"], seed=1, device="cuda")
    data = {k: v[rows] for k, v in data.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(DP_BF16["warm"] + DP_BF16["steps"]):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, data, gen)["loss"]))  # float() waits
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times = sorted(times[DP_BF16["warm"]:])
    print_tagged("PHASE22_RANK", {
        "rank": rank, "losses": fp32["losses"], "counts": fp32["counts"], "fp32_s": fp32_s,
        "bf16_losses": losses, "bf16_step_ms": times[len(times) // 2],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": augment.apply_augment_kernel.kernel_launches})
    distributed.barrier("phase 22 done")
    return 0


def phase_data_parallel(torch, gpu_label) -> dict:
    """Phase 22. Returns the augmentation kernel's launches by path."""
    from stcd_tpu_torch.cli import make_demo_data

    t_phase = time.monotonic()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        # (b)'s two ranks start up now and touch the card once (a) and this process's
        # one-process reference are done (``go``)
        t_ranks = time.monotonic()
        ranks_cmd = torchrun(2, "--phase22-rank", root)
        ranks_proc = start(ranks_cmd)
        # (a) the CLI as one torchrun rank under NCCL and in a plain process, at once,
        # while this process computes (b)'s reference
        data = os.path.join(root, "data")
        make_demo_data.main([data, "--n", str(DP_CLI["n"]), "--size", str(DP_CLI["size"])])
        cli = ["--phase22-cli", "--root_path", data, "--dataset_name", "LEVIR",
               "--CDdataset_name", "LEVIR", "--batch_size", str(DP_CLI["batch"]), "--n_epochs",
               "1", "--img_height", str(DP_CLI["size"]), "--img_width", str(DP_CLI["size"]),
               "--device", "cuda", "--no_preempt"]
        runs = {"nccl": torchrun(1, *cli, "--save_name", os.path.join(root, "nccl")),
                "plain": [sys.executable, os.path.abspath(__file__), *cli, "--save_name",
                          os.path.join(root, "plain")]}
        t0 = time.monotonic()
        procs = {k: start(cmd) for k, cmd in runs.items()}
        one = dp_fp32_run(torch, slice(None))
        torch.cuda.empty_cache()
        info = {k: tagged(finish(proc, runs[k]), "PHASE22_CLI")[0]
                for k, proc in procs.items()}
        cli_s = time.monotonic() - t0
        want_steps = DP_CLI["n"] // DP_CLI["batch"]
        require(info["nccl"]["backend"] == "nccl" and info["nccl"]["world"] == 1
                and info["plain"]["backend"] is None and info["plain"]["world"] == 1,
                f"phase 22 (a): {info}")
        for k, v in info.items():
            require(v["step"] == v["launches"] == want_steps and v["device"].startswith("cuda"),
                    f"phase 22 (a) {k}: {v}")
            launches[f"dp_cli_{k}"] = v["launches"]
        saved = {k: torch.load(os.path.join(root, k, "last_ckpt"), map_location="cpu",
                               weights_only=True)["model"] for k in runs}
        cli_diff = max((saved["nccl"][k].double() - v.double()).abs().max().item()
                       for k, v in saved["plain"].items() if v.is_floating_point())
        require(saved["nccl"].keys() == saved["plain"].keys() and cli_diff == 0.0,
                f"phase 22 (a): torchrun's weights differ from the plain run's by {cli_diff}")
        print(f"data parallel (a) ({gpu_label}): cli.train_pse_cd SegCD-r50 (256..16), "
              f"{DP_CLI['n']} pairs of {DP_CLI['size']}x{DP_CLI['size']}, batch "
              f"{DP_CLI['batch']}, 1 epoch: torchrun --nproc_per_node 1 (NCCL, world 1) and a "
              f"plain process, at once (and (b)'s reference in this process), {cli_s:.1f} s; "
              f"weights equal (max |d| {cli_diff}); "
              f"augment launches {info['nccl']['launches']} + {info['plain']['launches']}",
              flush=True)
        del saved

        # (b) two ranks on the one card under gloo against the one-process reference
        with open(os.path.join(root, "go"), "w"):
            pass
        out = finish(ranks_proc, ranks_cmd)
        ranks_s = time.monotonic() - t_ranks
        ranks = sorted(tagged(out, "PHASE22_RANK"), key=lambda r: r["rank"])
        require([r["rank"] for r in ranks] == [0, 1], f"phase 22 (b): {out[-3000:]}")
        states = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
                  for r in range(2)]
    loss_err = abs(ranks[0]["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    flips = max(sum(abs(a - b) for ga, wa in zip(got, want) for a, b in zip(ga, wa)) // 2
                for r in ranks for got, want in zip(r["counts"], one["counts"]))
    errs = state_errors(one["state"], states[0])
    print(f"data parallel (b) ({gpu_label}): 2 ranks on one card under gloo, SegCD-r50 "
          f"stage 2, global batch {DP_STEP['batch']} fp32 (TF32 off), {DP_STEP['steps']} SGD "
          f"steps against one process: losses {ranks[0]['losses']} vs {one['losses']} "
          f"(step 1 rel {loss_err:.2e}); after the steps, |d| / max(1, |w|) by group "
          f"{ {g: (f'{e:.2e}', k) for g, (e, k) in errs.items()} }; counts differ in at most "
          f"{flips} pixels", flush=True)
    require(all(torch.equal(states[1][k], v) for k, v in states[0].items()),
            "phase 22 (b): the two ranks' states differ")
    require(loss_err <= DP_LOSS_RTOL and ranks[0]["losses"] == ranks[1]["losses"],
            f"phase 22 (b): losses {[r['losses'] for r in ranks]} against {one['losses']}")
    for r in ranks:
        for got, want in zip(r["counts"], one["counts"]):
            require([sum(x) for x in got] == [sum(x) for x in want],
                    f"phase 22 (b): counts {got} against {want}")
    require(flips <= STEP_CM_PIXELS, f"phase 22 (b): counts differ in {flips} pixels")
    require(errs["count"][0] == 0.0 and errs["param"][0] <= DP_PARAM_SHARE
            and max(errs["running_mean"][0], errs["running_var"][0]) <= DP_STATS_SHARE,
            f"phase 22 (b): the state after the steps: {errs}")
    print(f"data parallel (b) ({gpu_label}): bf16 global batch {DP_BF16['batch']} "
          f"({DP_BF16['batch'] // 2} a rank), median of {DP_BF16['steps']} steps by the host "
          f"clock, gloo through the host: step ms by rank "
          f"{[round(r['bf16_step_ms'], 1) for r in ranks]}, peak GiB by rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]}, augment launches by rank "
          f"{[r['launches'] for r in ranks]}; losses {ranks[0]['bf16_losses'][0]:.4f} -> "
          f"{ranks[0]['bf16_losses'][-1]:.4f}; launch {ranks_s:.1f} s from its start with (a) "
          f"(the fp32 steps "
          f"{ranks[0]['fp32_s']:.1f} s); phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    for r in ranks:
        bf16 = r["bf16_losses"]
        require(all(x == x and abs(x) != float("inf") for x in bf16) and bf16[-1] < bf16[0],
                f"phase 22 (b) rank {r['rank']}: bf16 losses {bf16}")
        want_launches = DP_STEP["steps"] + DP_BF16["warm"] + DP_BF16["steps"]
        require(r["launches"] == want_launches,
                f"phase 22 (b) rank {r['rank']}: {r['launches']} augment launches")
    launches["dp_gloo_two_ranks"] = sum(r["launches"] for r in ranks)
    return launches


# phase 23: spatial partitioning (stcd_tpu_torch/parallel/spatial.py) on the card. (a) two
# ranks on the one card under gloo at a space axis of 2: the stage-2 spatial step against
# the one-process step at the same global batch, fp32 then bf16; (b) cli.train_pse_cd
# --space_axis 2 under torch.distributed.run against the same CLI in a plain process
SP_CLI = dict(n=4, size=512, batch=4)  # one epoch of one Adam step at lr 1e-3 (CLI defaults)
# fp32: the bounds of stcd_tpu_torch/tools/check_spatial.py. bf16 autocast: each conv's
# output rounded to bf16 from sums in another order. Measured on an H100 80GB HBM3 at
# 700 W: losses 1.6e-4 relative, 662 pixels, parameters 5.9e-5, running statistics 1.0e-2
SP_BF16_LOSS_RTOL = 1e-3
SP_BF16_CM_PIXELS = 2048
SP_BF16_PARAM_SHARE = 3e-4
SP_BF16_STATS_SHARE = 5e-2
# (b) Adam's first step (lr 1e-3) moves each element by lr times the sign of its gradient,
# whatever the gradient's size: an element whose gradient is within float32 noise of 0
# may move the other way (2 lr apart), every other one agrees within rounding. So the
# step shows a gradient that is wrong in sign or zero in the share of the elements that
# agree within 1e-5 (SP_CLI_AGREE), not in the largest difference: a zero or negated
# gradient leaves almost none. A gradient scaled as a whole is invisible to Adam; (a)
# holds the same spatial step's SGD updates to the one process's. Measured on an H100
# 80GB HBM3 at 700 W: the first loss equal, parameters 2.0e-3 apart, 0.983397 of them
# within 1e-5, running statistics 1.4e-6
SP_CLI_ATOL = 2 * 1e-3 + 1e-6
SP_CLI_AGREE = 0.95
SP_CLI_STATS_SHARE = 1e-4  # the statistics of one forward


def phase23_rank(out_dir: str, cli: list) -> int:
    """One of the two ranks of phase 23, on cuda:0 under gloo: (a) at a space axis
    of 2 once this process's one-process steps are done (``go``), then (b),
    cli.train_pse_cd with ``cli``, in the same processes."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh
    from stcd_tpu_torch.tools.check_spatial import cd_steps_run

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize("cuda:0", backend="gloo")
    mesh = create_mesh(space=2)
    rank = distributed.rank()
    require(mesh.space == 2 and mesh.data == 1 and device.index == 0
            and torch.distributed.get_backend() == "gloo",
            f"rank {rank}: {mesh}, {torch.distributed.get_backend()}, {device}")
    wait_for(os.path.join(out_dir, "go"))
    augment.apply_augment_kernel.kernel_launches = 0
    res = {}
    for prec in ("fp32", "bf16"):
        res[prec] = cd_steps_run(prec == "bf16", mesh)
        torch.save(res[prec].pop("state"), os.path.join(out_dir, f"sp_{prec}_rank{rank}.pt"))
    print_tagged("PHASE23_RANK", {
        "rank": rank, "space_rank": distributed.space_rank(), **res,
        "launches": augment.apply_augment_kernel.kernel_launches})
    torch.cuda.empty_cache()
    distributed.barrier("phase 23 (a) done")
    t0 = time.monotonic()
    info = deterministic_cli(cli)
    print_tagged("PHASE22_CLI", {**info, "seconds": time.monotonic() - t0})
    distributed.barrier("phase 23 done")
    return 0


def phase_spatial(torch, gpu_label) -> dict:
    """Phase 23. Returns the augmentation kernel's launches by path."""
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.tools.check_spatial import (CM_PIXELS, LOSS_RTOL, PARAM_SHARE, RUN,
                                                    STATS_SHARE, cd_steps_run)

    t_phase = time.monotonic()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        # (b)'s data, and its command for the ranks: they run it after (a) in one launch
        data = os.path.join(root, "data")
        make_demo_data.main([data, "--n", str(SP_CLI["n"]), "--size", str(SP_CLI["size"])])
        cli = ["--root_path", data, "--dataset_name", "LEVIR",
               "--CDdataset_name", "LEVIR", "--batch_size", str(SP_CLI["batch"]),
               "--n_epochs", "1", "--img_height", str(SP_CLI["size"]), "--img_width",
               str(SP_CLI["size"]), "--device", "cuda", "--no_preempt"]
        # (a) the two strips on the one card start up while this process takes the
        # one-process steps; they touch the card once it is done (``go``)
        t0 = time.monotonic()
        cmd = torchrun(2, "--phase23-rank", root, *cli, "--space_axis", "2", "--device",
                       "cuda:0", "--save_name", os.path.join(root, "space2"))
        proc = start(cmd)
        one = {}
        augment.apply_augment_kernel.kernel_launches = 0
        for prec in ("fp32", "bf16"):
            one[prec] = cd_steps_run(prec == "bf16")
            torch.cuda.empty_cache()
        launches["sp_one_process"] = augment.apply_augment_kernel.kernel_launches
        with open(os.path.join(root, "go"), "w"):
            pass
        out = finish(proc, cmd)
        ranks_s = time.monotonic() - t0
        ranks = sorted(tagged(out, "PHASE23_RANK"), key=lambda r: r["rank"])
        require([(r["rank"], r["space_rank"]) for r in ranks] == [(0, 0), (1, 1)],
                f"phase 23 (a): {out[-3000:]}")
        bounds = {"fp32": (LOSS_RTOL, CM_PIXELS, PARAM_SHARE, STATS_SHARE),
                  "bf16": (SP_BF16_LOSS_RTOL, SP_BF16_CM_PIXELS, SP_BF16_PARAM_SHARE,
                           SP_BF16_STATS_SHARE)}
        for prec, (loss_tol, cm_tol, param_tol, stats_tol) in bounds.items():
            states = [torch.load(os.path.join(root, f"sp_{prec}_rank{r}.pt"), weights_only=True)
                      for r in range(2)]
            want = one[prec]
            loss_err = max(abs(a - b) / abs(b) for r in ranks
                           for a, b in zip(r[prec]["losses"], want["losses"]))
            flips = max(sum(abs(a - b) for ga, wa in zip(got, w) for a, b in zip(ga, wa)) // 2
                        for r in ranks for got, w in zip(r[prec]["counts"], want["counts"]))
            errs = state_errors(want["state"], states[0])
            print(f"spatial (a) {prec} ({gpu_label}): 2 ranks on one card under gloo, space 2 "
                  f"(strips of {RUN['size'] // 2} rows), SegCD-r50 stage 2 at "
                  f"{RUN['size']}x{RUN['size']}, global batch {RUN['batch']}, "
                  f"{RUN['steps']} SGD steps against one process: losses "
                  f"{ranks[0][prec]['losses']} vs {want['losses']} (max rel {loss_err:.2e}); "
                  f"after the steps, |d| / max(1, |w|) by group "
                  f"{ {g: (f'{e:.2e}', k) for g, (e, k) in errs.items()} }; counts differ in "
                  f"at most {flips} pixels", flush=True)
            print(f"spatial (a) {prec} ({gpu_label}): step ms by rank (the fastest of steps "
                  f"2-{RUN['steps']}, host clock, halos and reductions through the host "
                  f"under gloo) {[round(r[prec]['step_ms'], 1) for r in ranks]} against "
                  f"{want['step_ms']:.1f} for one process; peak GiB by rank "
                  f"{[round(r[prec]['peak_gib'], 3) for r in ranks]} against "
                  f"{want['peak_gib']:.3f} for one process", flush=True)
            require(all(torch.equal(states[1][k], v) for k, v in states[0].items()),
                    f"phase 23 (a) {prec}: the two ranks' states differ")
            require(loss_err <= loss_tol and ranks[0][prec]["losses"] == ranks[1][prec]["losses"],
                    f"phase 23 (a) {prec}: losses {[r[prec]['losses'] for r in ranks]} against "
                    f"{want['losses']}")
            for r in ranks:
                for got, w in zip(r[prec]["counts"], want["counts"]):
                    require([sum(x) for x in got] == [sum(x) for x in w],
                            f"phase 23 (a) {prec}: counts {got} against {w}")
            require(flips <= cm_tol, f"phase 23 (a) {prec}: counts differ in {flips} pixels")
            require(errs["count"][0] == 0.0 and errs["param"][0] <= param_tol
                    and max(errs["running_mean"][0], errs["running_var"][0]) <= stats_tol,
                    f"phase 23 (a) {prec}: the state after the steps: {errs}")
            del states
        for r in ranks:
            require(r["launches"] == 2 * RUN["steps"],
                    f"phase 23 (a) rank {r['rank']}: {r['launches']} augment launches")
        launches["sp_two_ranks"] = sum(r["launches"] for r in ranks)

        # (b) the CLI at space 2 ran in the ranks after (a) (both on card 0; a card would
        # otherwise be cuda:LOCAL_RANK); the plain run in this process
        runs = ("space2", "plain")
        t0 = time.monotonic()
        info = {"space2": tagged(out, "PHASE22_CLI"),
                "plain": [deterministic_cli([*cli, "--save_name",
                                             os.path.join(root, "plain")])]}
        cli_s = max(v["seconds"] for v in info["space2"]) + time.monotonic() - t0
        want_steps = SP_CLI["n"] // SP_CLI["batch"]
        require(len(info["space2"]) == 2 and len(info["plain"]) == 1, f"phase 23 (b): {info}")
        for v in info["space2"]:
            require(v["backend"] == "gloo" and v["world"] == 2 and v["step"] == want_steps
                    and v["launches"] == want_steps and v["device"].startswith("cuda"),
                    f"phase 23 (b) space2: {v}")
        require(info["plain"][0]["step"] == info["plain"][0]["launches"] == want_steps,
                f"phase 23 (b) plain: {info['plain']}")
        launches["sp_cli_space2"] = sum(v["launches"] for v in info["space2"])
        launches["sp_cli_plain"] = info["plain"][0]["launches"]
        saved = {k: torch.load(os.path.join(root, k, "last_ckpt"), map_location="cpu",
                               weights_only=True)["model"] for k in runs}
        first_loss = {}
        for k in runs:
            with open(os.path.join(root, k, "logs", "scalars.jsonl")) as f:
                first_loss[k] = [r["value"] for r in map(json.loads, f)
                                 if r["tag"] == "train/loss" and r["step"] == 0][0]
        loss_err = abs(first_loss["space2"] - first_loss["plain"]) / abs(first_loss["plain"])
        params = [k for k, v in saved["plain"].items()
                  if v.is_floating_point() and "running" not in k]
        param_err = max((saved["space2"][k] - saved["plain"][k]).abs().max().item()
                        for k in params)
        agree = (sum(((saved["space2"][k] - saved["plain"][k]).abs() <= 1e-5).sum().item()
                     for k in params) / sum(saved["plain"][k].numel() for k in params))
        stats_err = max(((saved["space2"][k].double() - v.double()).abs().max()
                         / v.abs().max().clamp(min=1.0)).item()
                        for k, v in saved["plain"].items() if "running" in k)
        print(f"spatial (b) ({gpu_label}): cli.train_pse_cd --space_axis 2 --device cuda:0 "
              f"(the ranks of (a), one card, gloo) and a plain run in this process, "
              f"SegCD-r50, {SP_CLI['n']} pairs of {SP_CLI['size']}x{SP_CLI['size']}, batch "
              f"{SP_CLI['batch']}, 1 epoch: {cli_s:.1f} s; first loss {first_loss['space2']} vs "
              f"{first_loss['plain']} (rel {loss_err:.2e}); after the Adam step the "
              f"parameters within {param_err:.2e} ({agree:.6f} of them within 1e-5), the "
              f"running statistics within {stats_err:.2e} of their largest magnitude; augment "
              f"launches by rank {[v['launches'] for v in info['space2']]} + "
              f"{info['plain'][0]['launches']}", flush=True)
        require(saved["space2"].keys() == saved["plain"].keys() and loss_err <= LOSS_RTOL
                and param_err <= SP_CLI_ATOL and agree >= SP_CLI_AGREE
                and stats_err <= SP_CLI_STATS_SHARE,
                f"phase 23 (b): the space-2 run against the plain run: first loss {loss_err}, "
                f"parameters {param_err} ({agree} within 1e-5), running statistics "
                f"{stats_err}")
        del saved
    print(f"spatial: ranks {ranks_s:.1f} s, phase {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return launches


# phase 24: pipeline parallelism (stcd_tpu_torch/parallel/pipeline.py) on the card: four
# ranks on cuda:0 under gloo run tools/check_pipeline.py's runs (bounds and launch counts
# there) against this process's one-process runs, then cli.train_cd --pp_stages 4
PP_CLI = dict(n=4, size=256, batch=4)  # 4 train and 2 val pairs; 1 step, 1 val batch
PP_TIMEOUT = 300


def phase24_rank(out_dir: str, cli: list) -> int:
    """One of the four ranks of phase 24, on cuda:0 under gloo: (a)-(c) once the
    reference is written, then (d), cli.train_cd.main(cli), in the same
    processes."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.tools import check_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize("cuda:0", backend="gloo")
    require(distributed.world_size() == 4 and device.index == 0,
            f"rank {distributed.rank()}: world {distributed.world_size()}, {device}")
    wait_for(os.path.join(out_dir, "ref.pt"))
    ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
    print_tagged("PHASE24_RANK", check_pipeline.rank_checks(ref, device))
    del ref
    torch.cuda.empty_cache()
    distributed.barrier("phase 24 (a)-(c) done")
    phase24_cli(cli)
    distributed.barrier("phase 24 done")
    return 0


def phase24_cli(argv) -> int:
    """Phase 24 (d) on this rank: cli.train_cd.main(argv) and its attention launches."""
    import torch
    from stcd_tpu_torch.cli import train_cd
    from stcd_tpu_torch.ops import attention
    from stcd_tpu_torch.parallel import distributed

    kernel = reset_attention_counts(attention)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = train_cd.main(argv)
    torch.cuda.synchronize()
    print_tagged("PHASE24_CLI", {
        "rank": distributed.rank(), "stage": distributed.stage_rank(),
        "world": distributed.world_size(), "backend": torch.distributed.get_backend(),
        "step": out["state"].step, "seconds": time.monotonic() - t0,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "fwd": kernel.kernel_launches, "bwd": kernel.backward_launches,
        "variants": sorted(set(kernel.forward_variants) | set(kernel.backward_variants)),
        "mf1": out["scores"]["mf1"]})
    return 0


def phase_pipeline(torch, gpu_label) -> dict:
    """Phase 24. Returns the attention kernels' launches by path, forward and backward."""
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.tools import check_pipeline as cp

    t_phase = time.monotonic()
    fwd, bwd = {}, {}
    with tempfile.TemporaryDirectory() as root:
        # (d)'s data first: the ranks run it after (a)-(c) in the same launch, which starts
        # while this process computes the reference
        data = os.path.join(root, "data")
        make_demo_data.main([data, "--n", str(PP_CLI["n"]), "--size", str(PP_CLI["size"])])
        cli = ["--net_G", "ChangeFormerV6", "--embed_dim", "256",
               "--pp_stages", "4", "--root_path", data, "--dataset_name", "LEVIR",
               "--img_size", str(PP_CLI["size"]), "--batch_size", str(PP_CLI["batch"]),
               "--max_epochs", "1", "--n_cpu", "1", "--device", "cuda:0",
               "--checkpoint_dir", os.path.join(root, "cli")]
        t0 = time.monotonic()
        cmd = torchrun(4, "--phase24-rank", root, *cli)
        proc = start(cmd)
        ref = cp.reference()
        save_for_ranks(torch, ref, os.path.join(root, "ref.pt"))
        out = finish(proc, cmd, timeout=PP_TIMEOUT)
        ranks_s = time.monotonic() - t0
        ranks = sorted(tagged(out, "PHASE24_RANK"), key=lambda r: r["rank"])
        require([r["rank"] for r in ranks] == [0, 1, 2, 3]
                and all(r["backend"] == "gloo" for r in ranks), f"phase 24: {out[-3000:]}")
        for kind, (net_G, n, size, stages, micro, n_data) in cp.RUNS.items():
            rows = [r[kind] for r in ranks]
            print(f"pipeline ({kind}) ({gpu_label}): {net_G}, {size}x{size}, global batch {n}, "
                  f"fp32, pp_stages {stages} x data {n_data}, {micro} microbatches, 4 ranks "
                  f"on one card under gloo (the pipeline's cost, not its speed): warm train "
                  f"step ms by rank {[round(x['step_ms'], 1) for x in rows]} against "
                  f"{ref[kind]['step_ms']:.1f} for one process (first step "
                  f"{[round(x['first_ms'], 1) for x in rows]} against "
                  f"{ref[kind]['first_ms']:.1f}); warm eval ms "
                  f"{[round(x['eval_ms'], 1) for x in rows]} against "
                  f"{ref[kind]['eval_ms']:.1f}; peak GiB {[round(x['peak_gib'], 3) for x in rows]}"
                  f" against {ref[kind]['peak_gib']:.3f}; against one process by rank "
                  f"{[{k: float(f'{v:.3g}') for k, v in x['errors'].items()} for x in rows]}; "
                  f"attention launches by rank (train fwd/bwd, eval fwd) "
                  f"{[(x['launches']['train']['fwd'], x['launches']['train']['bwd'], x['launches']['eval']['fwd']) for x in rows]}"
                  + (f"; dropout 0.1 step: {[x['dropout_calls'] for x in rows]} attention calls "
                     f"by rank, one mask a stage, states and generators equal"
                     if kind == "v6" else ""), flush=True)
            fails = [f"rank {i}: {f}" for i, x in enumerate(rows) for f in x["fails"]]
            require(not fails, f"phase 24 {kind}: {fails}")
            fwd[f"pp_{kind}"] = sum(x["launches"]["train"]["fwd"] + x["launches"]["eval"]["fwd"]
                                    for x in rows)
            bwd[f"pp_{kind}"] = sum(x["launches"]["train"]["bwd"] for x in rows)
        require(fwd["pp_v6"] == 2 * 13 * 4 and fwd["pp_bit"] == 2 * 2 * 8 * 2 * 2
                and fwd["pp_vig"] == 0, f"phase 24 launches {fwd} {bwd}")

        # (d) cli.train_cd --pp_stages 4 in the same four ranks on card 0
        info = sorted(tagged(out, "PHASE24_CLI"), key=lambda r: r["rank"])
        cli_s = max(r["seconds"] for r in info)
        steps = PP_CLI["n"] // PP_CLI["batch"]
        evals = 2 * -(-max(PP_CLI["n"] // 2, 2) // PP_CLI["batch"])  # the epoch's and the final
        require(len(info) == 4, f"phase 24 (d): {info}")
        for r in info:
            blocks = cp.BLOCKS["v6"][r["stage"]] * 4  # a stage's blocks times 4 microbatches
            require(r["world"] == 4 and r["backend"] == "gloo" and r["step"] == steps
                    and r["fwd"] == blocks * (steps + evals) and r["bwd"] == blocks * steps
                    and r["variants"] == ["f32_cuda"],
                    f"phase 24 (d) rank {r['rank']}: {r}")
        fwd["pp_cli_v6"] = sum(r["fwd"] for r in info)
        bwd["pp_cli_v6"] = sum(r["bwd"] for r in info)
        print(f"pipeline (d) ({gpu_label}): cli.train_cd --net_G ChangeFormerV6 --embed_dim "
              f"256 --pp_stages 4 --device cuda:0 (torchrun --nproc_per_node 4, one card, "
              f"gloo, in the launch of (a)-(c)), {PP_CLI['n']} pairs of "
              f"{PP_CLI['size']}x{PP_CLI['size']}, batch {PP_CLI['batch']}, 1 epoch ({steps} "
              f"steps): {cli_s:.1f} s; attention launches "
              f"by rank (fwd, bwd) {[(r['fwd'], r['bwd']) for r in info]}; peak GiB by rank "
              f"{[round(r['peak_gib'], 3) for r in info]}; val mF1 "
              f"{[round(r['mf1'], 4) for r in info]}", flush=True)
        require(len({r["mf1"] for r in info}) == 1, f"phase 24 (d): the ranks' scores {info}")
    print(f"pipeline: the ranks' launch {ranks_s:.1f} s (the reference computed while they "
          f"start), phase {time.monotonic() - t_phase:.1f} s", flush=True)
    return {"fwd": fwd, "bwd": bwd}


# phase 25: tensor parallelism (stcd_tpu_torch/parallel/tensor.py) on the card: two ranks
# on cuda:0 under gloo, in one launch, run tools/check_tensor_parallel.py's runs at model
# 2 (bounds and launch counts there) against this process's one-process runs, then
# cli.train_cd --net_G base_transformer_pos_s4_dd8 --tp_axis 2 for one epoch
TP_CLI = dict(n=8, size=256, batch=4)  # synthetic pairs: 2 steps, 1 val batch
TP_TIMEOUT = 300


def phase25_rank(out_dir: str) -> int:
    """One of the two ranks of phase 25, on cuda:0 under gloo."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stcd_tpu_torch.cli import train_cd
    from stcd_tpu_torch.ops import attention
    from stcd_tpu_torch.parallel import distributed, tensor
    from stcd_tpu_torch.tools import check_tensor_parallel as ctp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize("cuda:0", backend="gloo")
    require(distributed.world_size() == 2 and device.index == 0,
            f"rank {distributed.rank()}: world {distributed.world_size()}, {device}")
    wait_for(os.path.join(out_dir, "ref.pt"))
    ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
    t0 = time.monotonic()
    report = ctp.rank_checks(ref, device)
    del ref
    report["checks_s"] = time.monotonic() - t0
    # (c) cli.train_cd over BIT at --tp_axis 2
    kernel = reset_attention_counts(attention)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = train_cd.main([
        "--net_G", "base_transformer_pos_s4_dd8", "--tp_axis", "2", "--dataset_name",
        "synthetic", "--synthetic_length", str(TP_CLI["n"]), "--img_size", str(TP_CLI["size"]),
        "--batch_size", str(TP_CLI["batch"]), "--max_epochs", "1", "--n_cpu", "1",
        "--device", "cuda:0", "--checkpoint_dir", os.path.join(out_dir, "cli")])
    torch.cuda.synchronize()
    heads = [m.heads_split for m in out["state"].model.modules()
             if getattr(m, "heads_split", None) is not None]
    state = out["state"]
    report["cli"] = {
        "seconds": time.monotonic() - t0, "step": state.step,
        "bytes": tensor.state_bytes(state.model, state.optimizer),
        "one_process_bytes": one_process_bytes(torch, state),
        "split": tensor.is_split(out["state"].model), "heads": sorted(set(heads)),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "fwd": kernel.kernel_launches, "bwd": kernel.backward_launches,
        "variants": sorted(set(kernel.forward_variants) | set(kernel.backward_variants)),
        "mf1": out["scores"]["mf1"]}
    print_tagged("PHASE25_RANK", report)
    distributed.barrier("phase 25 done")
    return 0


def one_process_bytes(torch, state) -> int:
    """The bytes of a split train state's parameters and optimizer state in
    one process: each split tensor at its full size (``tp_split``)."""
    n = 0
    for p in state.model.parameters():
        scale = p.tp_split.size // p.shape[p.tp_split.dim] if hasattr(p, "tp_split") else 1
        n += p.numel() * p.element_size() * scale
        for v in state.optimizer.state.get(p, {}).values():
            if torch.is_tensor(v):
                n += v.numel() * v.element_size() * (scale if v.shape == p.shape else 1)
    return n


def phase_tensor_parallel(torch, gpu_label) -> dict:
    """Phase 25. Returns the kernels' launches by path: attention forward and
    backward, and the augmentation's."""
    from stcd_tpu_torch.tools import check_tensor_parallel as ctp

    t_phase = time.monotonic()
    kinds = list(ctp.GRIDS[2])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        cmd = torchrun(2, "--phase25-rank", root)
        proc = start(cmd)  # the ranks start while this process computes the reference
        ref = ctp.reference(kinds, "cuda")
        save_for_ranks(torch, ref, os.path.join(root, "ref.pt"))
        out = finish(proc, cmd, timeout=TP_TIMEOUT)
        ranks_s = time.monotonic() - t0
    ranks = sorted(tagged(out, "PHASE25_RANK"), key=lambda r: r["rank"])
    require([r["rank"] for r in ranks] == [0, 1] and all(r["backend"] == "gloo"
                                                         for r in ranks),
            f"phase 25: {out[-3000:]}")
    what = {"segcd": "(a) SegCD-r50 stage-2 step (make_mesh / place_state / make_cd_steps, "
                     "augmentation on), decoder 256..16",
            "v6": "(b) CDTrainer(tp_axis=2) over ChangeFormerV6, embed 256"}
    for kind in kinds:
        rows, want = [r[kind] for r in ranks], ref[kind]
        print(f"tensor parallel {what[kind]} ({gpu_label}): 256x256, global batch 8, fp32, "
              f"model 2 x data 1, two ranks on one card under gloo (TP's cost, not its "
              f"speed): errors against one process by rank "
              f"{[{k: float(f'{v:.3g}') for k, v in x['errors'].items()} for x in rows]}; "
              f"bytes of parameters and Adam moments by rank "
              f"{[x['adam_bytes'] for x in rows]} against {want['adam_bytes']} "
              f"({[round(x['bytes_ratio'], 4) for x in rows]}); peak GiB "
              f"{[round(x['peak_gib'], 3) for x in rows]} against {want['peak_gib']:.3f}; "
              f"step ms (first, warm) {[(round(x['first_ms'], 1), round(x['step_ms'], 1)) for x in rows]}"
              f" against ({want['first_ms']:.1f}, {want['step_ms']:.1f}); launches by rank "
              f"{[x['launches'] for x in rows]}", flush=True)
        fails = [f"rank {i}: {f}" for i, x in enumerate(rows) for f in x["fails"]]
        require(not fails, f"phase 25 {kind}: {fails}")
    cli = [r["cli"] for r in ranks]
    steps = TP_CLI["n"] // TP_CLI["batch"]
    per_forward = 16  # BIT's 8 decoder blocks, decoding A and B
    evals = 2 * -(-max(TP_CLI["n"] // 2, 2) // TP_CLI["batch"])  # the epoch's and the final
    for i, c in enumerate(cli):
        require(c["split"] and c["step"] == steps and c["fwd"] == per_forward * (steps + evals)
                and c["bwd"] == per_forward * steps and c["variants"] == ["small_m"]
                and c["heads"] == [[4 * i, 4]], f"phase 25 (c) rank {i}: {c}")
    require(cli[0]["mf1"] == cli[1]["mf1"], f"phase 25 (c): the ranks' scores {cli}")
    print(f"tensor parallel (c) ({gpu_label}): cli.train_cd --net_G base_transformer_pos_s4_dd8 "
          f"--tp_axis 2 --device cuda:0 (two ranks, one card, gloo), {TP_CLI['n']} synthetic "
          f"pairs of {TP_CLI['size']}x{TP_CLI['size']}, batch {TP_CLI['batch']}, 1 epoch: "
          f"{[round(c['seconds'], 1) for c in cli]} s by rank; bytes of parameters and SGD "
          f"momentum by rank {[c['bytes'] for c in cli]} against {cli[0]['one_process_bytes']} "
          f"in one process ({[round(c['bytes'] / c['one_process_bytes'], 4) for c in cli]}); "
          f"no one-process run to hold it against (its scores equal on both ranks); "
          f"decoder heads (h0, h) by rank "
          f"{[c['heads'] for c in cli]}; attention launches by rank (fwd, bwd) "
          f"{[(c['fwd'], c['bwd']) for c in cli]} (small_m); peak GiB "
          f"{[round(c['peak_gib'], 3) for c in cli]}; val mF1 {cli[0]['mf1']:.4f}", flush=True)
    print(f"tensor parallel: the ranks' launch {ranks_s:.1f} s, the reference computed while "
          f"they start (checks {[round(r['checks_s'], 1) for r in ranks]} s by rank), phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    v6 = [r["v6"]["launches"] for r in ranks]
    drop = [r["v6"]["dropout_launches"] for r in ranks]
    return {"fwd": {"tp_v6": sum(x["train"]["fwd"] + x["eval"]["fwd"] for x in v6)
                    + sum(d["fwd"] for d in drop),
                    "tp_cli_bit": sum(c["fwd"] for c in cli)},
            "bwd": {"tp_v6": sum(x["train"]["bwd"] for x in v6) + sum(d["bwd"] for d in drop),
                    "tp_cli_bit": sum(c["bwd"] for c in cli)},
            "aug": {"tp_segcd": sum(r["segcd"]["launches"]["train"]["aug"] for r in ranks)}}


# phase 27: spatial partitioning beside tensor parallelism on the card: four ranks on
# cuda:0 under gloo at data 1 x model 2 x space 2. (a) tools/check_spatial.py's stage-2
# steps (RUN) at fp32 against one process, at its bounds; (b) cli.train_pse_cd
# --space_axis 2 --model_axis 2 against a plain run, at phase 23 (b)'s size and bounds
SM_GRID = dict(model=2, space=2)
SM_TIMEOUT = 400


def phase27_rank(out_dir: str, cli: list) -> int:
    """One of the four ranks of phase 27, on cuda:0 under gloo: (a) once this
    process's one-process runs are done (``go``), then (b), cli.train_pse_cd
    with ``cli``, in the same processes."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh
    from stcd_tpu_torch.tools.check_spatial import cd_steps_run

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize("cuda:0", backend="gloo")
    mesh = create_mesh(**SM_GRID)
    rank = distributed.rank()
    require(mesh.model == 2 and mesh.space == 2 and mesh.data == 1 and device.index == 0
            and torch.distributed.get_backend() == "gloo",
            f"rank {rank}: {mesh}, {torch.distributed.get_backend()}, {device}")
    wait_for(os.path.join(out_dir, "go"), timeout=SM_TIMEOUT)
    augment.apply_augment_kernel.kernel_launches = 0
    res = cd_steps_run(False, mesh)
    torch.save(res.pop("state"), os.path.join(out_dir, f"sm_rank{rank}.pt"))
    print_tagged("PHASE27_RANK", {
        "rank": rank, "model_rank": distributed.model_rank(),
        "space_rank": distributed.space_rank(), **res,
        "launches": augment.apply_augment_kernel.kernel_launches})
    torch.cuda.empty_cache()
    distributed.barrier("phase 27 (a) done")
    t0 = time.monotonic()
    info = deterministic_cli(cli)
    print_tagged("PHASE27_CLI", {**info, "seconds": time.monotonic() - t0})
    distributed.barrier("phase 27 done")
    return 0


def phase_space_model(torch, gpu_label) -> dict:
    """Phase 27. Returns the augmentation kernel's launches by path."""
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.ops import augment
    from stcd_tpu_torch.tools.check_spatial import (CM_PIXELS, LOSS_RTOL, PARAM_SHARE, RUN,
                                                    STATS_SHARE, cd_steps_run)

    t_phase = time.monotonic()
    launches = {}
    world = SM_GRID["model"] * SM_GRID["space"]
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        make_demo_data.main([data, "--n", str(SP_CLI["n"]), "--size", str(SP_CLI["size"])])
        cli = ["--root_path", data, "--dataset_name", "LEVIR",
               "--CDdataset_name", "LEVIR", "--batch_size", str(SP_CLI["batch"]),
               "--n_epochs", "1", "--img_height", str(SP_CLI["size"]), "--img_width",
               str(SP_CLI["size"]), "--device", "cuda", "--no_preempt"]
        # the four ranks start up while this process takes (a)'s one-process steps and
        # (b)'s plain run; they touch the card once those are done (``go``)
        t0 = time.monotonic()
        cmd = torchrun(world, "--phase27-rank", root, *cli, "--space_axis",
                       str(SM_GRID["space"]), "--model_axis", str(SM_GRID["model"]),
                       "--device", "cuda:0", "--save_name", os.path.join(root, "grid"))
        proc = start(cmd)
        augment.apply_augment_kernel.kernel_launches = 0
        one = cd_steps_run(False)
        launches["sm_one_process"] = augment.apply_augment_kernel.kernel_launches
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        plain = deterministic_cli([*cli, "--save_name", os.path.join(root, "plain")])
        plain_s = time.monotonic() - t1
        torch.cuda.empty_cache()
        with open(os.path.join(root, "go"), "w"):
            pass
        out = finish(proc, cmd, timeout=SM_TIMEOUT)
        ranks_s = time.monotonic() - t0
        ranks = sorted(tagged(out, "PHASE27_RANK"), key=lambda r: r["rank"])
        require([(r["rank"], r["model_rank"], r["space_rank"]) for r in ranks]
                == [(r, r // 2, r % 2) for r in range(world)], f"phase 27 (a): {out[-3000:]}")
        states = [torch.load(os.path.join(root, f"sm_rank{r}.pt"), weights_only=True)
                  for r in range(world)]
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], one["losses"]))
        flips = max(sum(abs(a - b) for ga, wa in zip(got, w) for a, b in zip(ga, wa)) // 2
                    for r in ranks for got, w in zip(r["counts"], one["counts"]))
        errs = state_errors(one["state"], states[0])
        print(f"space x model (a) ({gpu_label}): 4 ranks on one card under gloo, data 1 x "
              f"model 2 x space 2 (strips of {RUN['size'] // 2} rows, "
              f"{ranks[0]['n_split']} split tensors), SegCD-r50 stage 2 at "
              f"{RUN['size']}x{RUN['size']}, global batch {RUN['batch']}, fp32, "
              f"{RUN['steps']} SGD steps against one process: losses {ranks[0]['losses']} "
              f"vs {one['losses']} (max rel {loss_err:.2e}); after the steps, "
              f"|d| / max(1, |w|) by group "
              f"{ {g: (f'{e:.2e}', k) for g, (e, k) in errs.items()} }; counts differ in "
              f"at most {flips} pixels", flush=True)
        print(f"space x model (a) ({gpu_label}): step ms by rank (the fastest of steps "
              f"2-{RUN['steps']}, host clock, halos, gathers and reductions through the "
              f"host under gloo) {[round(r['step_ms'], 1) for r in ranks]} against "
              f"{one['step_ms']:.1f} for one process; peak GiB by rank "
              f"{[round(r['peak_gib'], 3) for r in ranks]} against {one['peak_gib']:.3f} "
              f"for one process", flush=True)
        require(all(torch.equal(st[k], v) for st in states[1:] for k, v in states[0].items()),
                "phase 27 (a): the four ranks' states differ")
        require(all(r["losses"] == ranks[0]["losses"] for r in ranks) and loss_err <= LOSS_RTOL,
                f"phase 27 (a): losses {[r['losses'] for r in ranks]} against {one['losses']}")
        for r in ranks:
            require(r["n_split"] == ranks[0]["n_split"] > 0, f"phase 27 (a) rank {r['rank']}: "
                    f"{r['n_split']} split tensors")
            for got, w in zip(r["counts"], one["counts"]):
                require([sum(x) for x in got] == [sum(x) for x in w],
                        f"phase 27 (a): counts {got} against {w}")
            require(r["launches"] == RUN["steps"],
                    f"phase 27 (a) rank {r['rank']}: {r['launches']} augment launches")
        require(flips <= CM_PIXELS, f"phase 27 (a): counts differ in {flips} pixels")
        require(errs["count"][0] == 0.0 and errs["param"][0] <= PARAM_SHARE
                and max(errs["running_mean"][0], errs["running_var"][0]) <= STATS_SHARE,
                f"phase 27 (a): the state after the steps: {errs}")
        del states
        launches["sm_four_ranks"] = sum(r["launches"] for r in ranks)

        # (b) the CLI on the grid ran in the ranks after (a); the plain run before them
        info = tagged(out, "PHASE27_CLI")
        want_steps = SP_CLI["n"] // SP_CLI["batch"]
        require(len(info) == world, f"phase 27 (b): {info}")
        for v in info:
            require(v["backend"] == "gloo" and v["world"] == world and v["step"] == want_steps
                    and v["launches"] == want_steps and v["device"].startswith("cuda"),
                    f"phase 27 (b) grid: {v}")
        require(plain["step"] == plain["launches"] == want_steps, f"phase 27 (b) plain: {plain}")
        launches["sm_cli_grid"] = sum(v["launches"] for v in info)
        launches["sm_cli_plain"] = plain["launches"]
        runs = ("grid", "plain")
        saved = {k: torch.load(os.path.join(root, k, "last_ckpt"), map_location="cpu",
                               weights_only=True)["model"] for k in runs}
        first_loss = {}
        for k in runs:
            with open(os.path.join(root, k, "logs", "scalars.jsonl")) as f:
                first_loss[k] = [r["value"] for r in map(json.loads, f)
                                 if r["tag"] == "train/loss" and r["step"] == 0][0]
        loss_err = abs(first_loss["grid"] - first_loss["plain"]) / abs(first_loss["plain"])
        params = [k for k, v in saved["plain"].items()
                  if v.is_floating_point() and "running" not in k]
        param_err = max((saved["grid"][k] - saved["plain"][k]).abs().max().item()
                        for k in params)
        agree = (sum(((saved["grid"][k] - saved["plain"][k]).abs() <= 1e-5).sum().item()
                     for k in params) / sum(saved["plain"][k].numel() for k in params))
        stats_err = max(((saved["grid"][k].double() - v.double()).abs().max()
                         / v.abs().max().clamp(min=1.0)).item()
                        for k, v in saved["plain"].items() if "running" in k)
        print(f"space x model (b) ({gpu_label}): cli.train_pse_cd --space_axis 2 "
              f"--model_axis 2 --device cuda:0 (the ranks of (a), one card, gloo) "
              f"{[round(v['seconds'], 1) for v in info]} s by rank, and a plain run in this "
              f"process {plain_s:.1f} s, SegCD-r50, {SP_CLI['n']} pairs of "
              f"{SP_CLI['size']}x{SP_CLI['size']}, batch {SP_CLI['batch']}, 1 epoch: first "
              f"loss {first_loss['grid']} vs {first_loss['plain']} (rel {loss_err:.2e}); "
              f"after the Adam step the parameters within {param_err:.2e} ({agree:.6f} of "
              f"them within 1e-5), the running statistics within {stats_err:.2e} of their "
              f"largest magnitude; augment launches by rank {[v['launches'] for v in info]} "
              f"+ {plain['launches']}", flush=True)
        require(saved["grid"].keys() == saved["plain"].keys() and loss_err <= LOSS_RTOL
                and param_err <= SP_CLI_ATOL and agree >= SP_CLI_AGREE
                and stats_err <= SP_CLI_STATS_SHARE,
                f"phase 27 (b): the grid run against the plain run: first loss {loss_err}, "
                f"parameters {param_err} ({agree} within 1e-5), running statistics "
                f"{stats_err}")
        del saved
    print(f"space x model: the ranks' launch {ranks_s:.1f} s (this process's runs while "
          f"they start), phase {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


REPLICAS = ["cuda:0", "cuda:0"]  # two replicas on the one card


def phase_replicas(torch, np, attention, gpu_label) -> int:
    """Serving split over two replicas on the one card (phase 26): V6 fp32
    against one replica, then SegCD-r50 int8 against one replica. Returns the
    attention launches of the two-replica V6 run."""
    from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_replicas
    from stcd_tpu_torch.serving.server import BatchingEngine

    parser = argparse.ArgumentParser()
    add_model_args(parser)
    common = ["--init_seed", "0", "--device", "cuda", "--tile", str(TILE)]
    args = parser.parse_args(["--net_G", "ChangeFormerV6", "--embed_dim", "256", *common])
    model = build_model(args)
    rng = np.random.default_rng(3)
    scenes = [tuple(rng.uniform(0, 1, (SCENE, SCENE, 3)).astype(np.float32)
                    for _ in range(2)) for _ in range(4)]

    def engine_over(fns, devices, quantized=False):
        engine = BatchingEngine(fns, tile=TILE, batch=BATCH, max_wait_ms=50.0,
                                devices=devices, quantized=quantized)
        engine.warm()
        return engine

    one = engine_over(make_replicas(args, model, REPLICAS[:1]), REPLICAS[:1])
    try:
        want = drive(one, scenes)
    finally:
        one.close()
    engine = engine_over(make_replicas(args, model, REPLICAS), REPLICAS)
    try:
        kernel = reset_attention_counts(attention)
        t0 = time.monotonic()
        got = drive(engine, scenes)
        seconds = time.monotonic() - t0
        launches, variants = kernel.kernel_launches, dict(kernel.forward_variants)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    steps = len(REPLICAS) * stats["batches"]
    print(f"replicas ({gpu_label}): V6 fp32 over {REPLICAS}: {stats['tiles']} tiles in "
          f"{stats['batches']} batches ({steps} replica steps) in {seconds:.2f} s, step_ms "
          f"p50 {stats['step_ms']['p50']}; attention launches {launches} {variants}; "
          f"max|dP| against one replica {err:.3e} (atol {PROBS_ATOL})", flush=True)
    require(stats["devices"] == 2 and stats["mesh_sharded"] is True
            and stats["errors"] == 0 and stats["requests"] == 4, f"replica /stats {stats}")
    require(launches == 13 * steps and variants == {"f32_cuda": launches},
            f"{launches} launches {variants} for {steps} replica steps")
    require(err <= PROBS_ATOL, f"two replicas against one: max|dP| {err}")
    del model

    args = parser.parse_args([*common, "--int8"])
    model = build_model(args)
    calib = [torch.from_numpy(np.stack([s[k][:TILE, :TILE] for s in scenes])).cuda()
             for k in (0, 1)]
    maps = {}
    for devices in (REPLICAS[:1], REPLICAS):
        engine = engine_over(make_replicas(args, model, devices, calib), devices,
                             quantized=True)
        try:
            maps[len(devices)] = drive(engine, scenes)
            stats = engine.stats_snapshot()
        finally:
            engine.close()
        require(stats["quantized"] is True and stats["devices"] == len(devices)
                and stats["errors"] == 0, f"int8 /stats {stats}")
    agree = float(np.mean([np.mean((g > 0.5) == (w > 0.5)) for g, w in zip(maps[2], maps[1])]))
    err = max(float(np.abs(g - w).max()) for g, w in zip(maps[2], maps[1]))
    print(f"replicas: SegCD-r50 int8, two replicas against one: decisions agree on "
          f"{agree:.6f} of the pixels (>= {1 - INT8_F1_TOL}), max|dP| {err:.3e}; /stats "
          f"quantized", flush=True)
    require(agree >= 1 - INT8_F1_TOL, f"int8 replicas: decisions agree on {agree}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from stcd_tpu_torch.ops import _build, attention, augment

    t_start = time.monotonic()
    seconds = {}

    @contextlib.contextmanager
    def timed(name: str):
        t0 = time.monotonic()
        yield
        seconds[name] = round(time.monotonic() - t0, 1)
        print(f"phase {name}: {seconds[name]} s", flush=True)

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
    with timed("2 build"):
        lib_path = _build.build()
        _build.load_library()
    print(f"build: {seconds['2 build']} s -> {lib_path}", flush=True)

    # phase 3: kernels against their plain versions
    with timed("3 kernels"):
        attn = phase_kernels(torch, attention)
        aug = phase_augment_kernel(torch)
        attn_bwd = phase_attention_backward(torch, attention)
        rows_fwd_err, rows_bwd_err = phase_attention_rows(torch, attention)
        attn["max_abs_err"] = max(attn["max_abs_err"], attn_bwd["fwd_max_abs_err"],
                                  rows_fwd_err)
        attn_bwd["max_abs_err"] = max(attn_bwd["max_abs_err"], rows_bwd_err)
        bn = phase_bn_stats(torch)
        mm = phase_matmul_stats(torch)

    # phase 4: serving
    with timed("4 serving"):
        serving_launches = phase_serving(torch, np, attention, gpu_label)

    # phase 5: training, the stage-2 step
    with timed("5 stage2 step"):
        aug_by_path = {"stage2_step": phase_training(torch, augment.apply_augment_kernel,
                                                     gpu_label)}
    aug["library_ms"] = None  # no single PyTorch call computes this function

    # phase 6: SegCD serving
    with timed("6 segcd serving"):
        phase_segcd_serving(torch, np)

    # phases 7 and 8: the trainer's step for ChangeFormerV6 and for BIT
    with timed("7-8 trainer steps"):
        v6_fwd, v6_bwd = phase_trainer(torch, attention, gpu_label, "ChangeFormerV6",
                                       V6_TRAIN, fp32_batch=2)
        v6_fp32 = phase_v6_fp32_step(torch, attention, gpu_label)["kernel"]
        v6_fp32_fwd, v6_fp32_bwd = v6_fp32["forward_launches"], v6_fp32["backward_launches"]
        bit_fwd, bit_bwd = phase_trainer(torch, attention, gpu_label,
                                         "base_transformer_pos_s4_dd8", BIT_TRAIN,
                                         fp32_batch=8)
    # phases 9 to 11: the stage-1 and stage-3 steps and the epoch loop
    with timed("9-11 stage steps and loop"):
        for stage in (1, 3):
            aug_by_path[f"stage{stage}_step"] = phase_training(
                torch, augment.apply_augment_kernel, gpu_label, stage=stage)
        aug_by_path["run_training"] = phase_loop(torch, augment.apply_augment_kernel)

    # phase 12: the three feasibility benchmarks, the matmul kernels' and bn_stats' entry
    # points
    with timed("12 tools"):
        tool_launches, tool_routes = phase_tools(torch)
    for name, took in tool_routes.items():
        mm[name]["launches_by_route"] = took
    for name, launches in tool_launches.items():
        require(launches > 0, f"the tools never launched {name}")
        (bn if name == "bn_stats" else mm[name])["launches"] = launches

    with tempfile.TemporaryDirectory() as root:
        # phase 13: the pipeline from the command line
        with timed("13 pipeline cli"):
            aug_by_path["pipeline_cli"], float_metrics = phase_pipeline_cli(
                torch, augment.apply_augment_kernel, gpu_label, root)
        # phase 14: cli.train_cd at full width
        with timed("14 train_cd"):
            train_cd = phase_train_cd(torch, attention, augment.apply_augment_kernel,
                                      gpu_label, root)
        aug_by_path["train_cd"] = train_cd["v6"]["aug"] + train_cd["bit"]["aug"]
        # phase 15: ChangeFormer V1-V5 at their published widths
        with timed("15 changeformer zoo"):
            zoo = phase_changeformer_zoo(torch, attention, gpu_label)
        # phase 16: int8 evaluation, prediction and serving
        with timed("16 int8"):
            phase_int8(torch, np, root, float_metrics, gpu_label)
        # phase 17: export
        with timed("17 export"):
            export_v6 = phase_export(torch, np, attention, root, gpu_label)
        # phase 18: the rest of the define_G zoo
        with timed("18 zoo"):
            aug_by_path.update(phase_zoo(torch, augment.apply_augment_kernel, gpu_label,
                                         root))
    # phase 19: the smp architectures of create_model
    with timed("19 smp"):
        aug_by_path["smp_zoo"], smp_fwd, smp_bwd = phase_smp(
            torch, attention, augment.apply_augment_kernel, gpu_label)
    # phase 20: the encoder families of get_encoder
    with timed("20 encoders"):
        aug_by_path.update(phase_encoder_zoo(torch, augment.apply_augment_kernel, gpu_label))
    # phase 21: smp's fit loop (launches none of the kernels)
    with timed("21 smp fit"):
        phase_smp_fit(torch, lambda: kernel_counts(attention, augment), gpu_label)
    # phase 22: data-parallel training, its ranks in processes of their own
    with timed("22 data parallel"):
        aug_by_path.update(phase_data_parallel(torch, gpu_label))
    # phase 23: spatial partitioning, its ranks in processes of their own
    with timed("23 spatial"):
        aug_by_path.update(phase_spatial(torch, gpu_label))
    # phase 24: pipeline parallelism, its ranks in processes of their own
    with timed("24 pipeline"):
        pp_launches = phase_pipeline(torch, gpu_label)
    # phase 25: tensor parallelism, its ranks in processes of their own
    with timed("25 tensor parallel"):
        tp_launches = phase_tensor_parallel(torch, gpu_label)
    aug_by_path.update(tp_launches["aug"])
    # phase 26: serving split over replicas on the one card
    with timed("26 replicas"):
        replica_launches = phase_replicas(torch, np, attention, gpu_label)
    # phase 27: spatial partitioning beside tensor parallelism, its ranks in processes of
    # their own
    with timed("27 space x model"):
        aug_by_path.update(phase_space_model(torch, gpu_label))
    aug["launches"] = sum(aug_by_path.values())
    print(f"phase seconds: {json.dumps(seconds)}; total {time.monotonic() - t_start:.1f} s",
          flush=True)

    # every path's count was taken from 0 just before it and read just after
    fwd_by_path = {"v6_serving": serving_launches, "v6_training": v6_fwd,
                   "v6_fp32_training": v6_fp32_fwd, "bit_training": bit_fwd,
                   "train_cd_v6": train_cd["v6"]["fwd"], "train_cd_bit": train_cd["bit"]["fwd"],
                   **{f"{k.lower()}_eval_and_step": v["eval_fwd"] + v["train_fwd"]
                      for k, v in zoo.items()},
                   "export_v6_loaded": export_v6, "smp_fpn_mit_b2": smp_fwd,
                   "v6_serving_replicas": replica_launches,
                   **pp_launches["fwd"], **tp_launches["fwd"]}
    bwd_by_path = {"v6_training": v6_bwd, "v6_fp32_training": v6_fp32_bwd,
                   "bit_training": bit_bwd, "train_cd_v6": train_cd["v6"]["bwd"],
                   "train_cd_bit": train_cd["bit"]["bwd"],
                   **{f"{k.lower()}_step": v["train_bwd"] for k, v in zoo.items()},
                   "smp_fpn_mit_b2": smp_bwd, **pp_launches["bwd"], **tp_launches["bwd"]}
    attn["launches"], attn["launches_by_path"] = sum(fwd_by_path.values()), fwd_by_path
    attn_bwd["launches"], attn_bwd["launches_by_path"] = sum(bwd_by_path.values()), bwd_by_path
    # the variant each path launched (each path's run required that it launched no other)
    f32_paths = ("v6_serving", "v6_fp32_training", "train_cd_v6", "export_v6_loaded",
                 "smp_fpn_mit_b2", "pp_v6", "pp_cli_v6", "tp_v6", "v6_serving_replicas")
    attn["variants"] = {
        "f32_cuda": sum(fwd_by_path[k] for k in f32_paths) + sum(
            v["eval_fwd"] + v["train_fwd"] for v in zoo.values()),
        V6_TRAIN["variant"]: v6_fwd,
        BIT_TRAIN["variant"]: bit_fwd + train_cd["bit"]["fwd"] + fwd_by_path["pp_bit"]
        + fwd_by_path["tp_cli_bit"]}
    attn_bwd["variants"] = {
        "f32_cuda": v6_fp32_bwd + train_cd["v6"]["bwd"] + smp_bwd + sum(
            v["train_bwd"] for v in zoo.values()) + bwd_by_path["pp_v6"]
        + bwd_by_path["pp_cli_v6"] + bwd_by_path["tp_v6"],
        V6_TRAIN["variant"]: v6_bwd,
        BIT_TRAIN["variant"]: bit_bwd + train_cd["bit"]["bwd"] + bwd_by_path["pp_bit"]
        + bwd_by_path["tp_cli_bit"]}
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
    if sys.argv[1:2] == ["--phase22-cli"]:  # a process that phase 22 starts
        sys.exit(phase22_cli(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase22-rank"]:
        sys.exit(phase22_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--phase23-rank"]:
        sys.exit(phase23_rank(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--phase24-rank"]:
        sys.exit(phase24_rank(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--phase25-rank"]:
        sys.exit(phase25_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--phase27-rank"]:
        sys.exit(phase27_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
