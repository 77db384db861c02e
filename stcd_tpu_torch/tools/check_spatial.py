"""Spatial partitioning across cards: the halo ops and the stage-2 spatial step
of ``parallel/spatial.py``, one rank a card under NCCL (``batch_isend_irecv``),
against the whole map and the one-process step.

Usage (the reference first, in a plain process on one card; then the ranks):

  python -m stcd_tpu_torch.tools.check_spatial --reference ref.pt
  torchrun --nproc_per_node 2 -m stcd_tpu_torch.tools.check_spatial --against ref.pt
  torchrun --nproc_per_node 4 -m stcd_tpu_torch.tools.check_spatial --against ref.pt --data 2

Each rank checks, on its card in float64, the halo conv (the stem, strided,
dilated, 1x1, 1-row strips, a halo wider than a strip), the max pool k3s2p1
and bilinear x2 upsampling against the op on the whole map (forward, input
gradient, and the weight gradient summed over the space group) within
OP_TOL of the largest magnitude; then RUN's stage-2 steps (SegCD-r50, decoder
256..16, 512x512, global batch 4, augmentation on, SGD) through the spatial
steps, against the reference: every loss within LOSS_RTOL, the counts but for
CM_PIXELS, the parameters and running statistics within PARAM_SHARE and
STATS_SHARE of each tensor's largest magnitude (the bounds of chip_smoke.py's
phase 23). Rank 0 prints one ``CHECK_SPATIAL {json}`` line with every rank's
step ms and peak GiB; a failed check exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

RUN = dict(batch=4, size=512, steps=2, lr=1e-3)  # SGD momentum 0.9, draws from seed 2
OP_TOL = 1e-12  # float64, the same products summed in another order
# after RUN's 3 fp32 steps (TF32 off), |d| over max(1, the tensor's largest magnitude):
# float32 sums in another order, cuDNN's algorithms for strips of 256 rows against whole
# images. Measured with two gloo ranks on an H100 80GB HBM3 at 700 W (chip_smoke.py phase
# 23): losses 5.9e-7 relative, 38 pixels of 4 x 512 x 512 at the threshold, parameters
# 5.1e-6 (encoder.conv1.weight), running statistics 4.8e-5 (a running variance)
LOSS_RTOL = 1e-5
CM_PIXELS = 64
PARAM_SHARE = 3e-5
STATS_SHARE = 5e-4


def cd_steps_run(bf16: bool = False, mesh=None, device="cuda") -> dict:
    """RUN's stage-2 steps on the global batches from seeds 10, 11, ...: the
    one-process steps (``mesh`` None) or the spatial steps of ``mesh``, this
    rank holding its data shard's rows and, with a model axis, its shard of
    the split convs (``place_train_state``). Returns the losses, counts, the
    state (the one-process layout: split tensors gathered), the fastest
    step's ms after the first, the first's, and the peak GiB."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.parallel import tensor
    from stcd_tpu_torch.parallel.mesh import batch_sharding, place_train_state
    from stcd_tpu_torch.parallel.spatial import make_spatial_cd_steps
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps

    model = init_weights(SegCD("resnet50", classes=1, decoder_channels=(256, 128, 64, 32, 16)),
                         seed=0)
    state = create_train_state(model, SGDConfig(lambda step: RUN["lr"], momentum=0.9,
                                                weight_decay=0.0), device=device, bf16=bf16)
    if mesh is not None:
        place_train_state(mesh, state)
    train_step = (make_cd_steps(augment=True)[0] if mesh is None
                  else make_spatial_cd_steps(None, mesh, augment=True)[0])
    rows = slice(None) if mesh is None else batch_sharding(mesh)
    gen = torch.Generator(device=device).manual_seed(2)
    batches = [{k: v[rows] for k, v in seeded_cd_batch(RUN["batch"], RUN["size"], seed=10 + i,
                                                       device=device).items()}
               for i in range(RUN["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, counts, times = [], [], []
    for data in batches:
        t0 = time.perf_counter()
        out = train_step(state, data, gen)
        losses.append(float(out["loss"]))  # float() waits
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(out["cm"].cpu().tolist())
    torch.cuda.synchronize()
    return {"losses": losses, "counts": counts, "step_ms": min(times[1:]),
            "first_ms": times[0], "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "n_split": sum(hasattr(p, "tp_split") for p in state.model.parameters()),
            "state": {k: v.detach().cpu()
                      for k, v in tensor.full_state_dict(state.model).items()}}


def state_errors(want: dict, got: dict) -> dict:
    """The largest |got - want| / max(1, max |want|) of each group of a
    state_dict (parameters, running means, running variances, counts)."""
    errs = {}
    for k, v in want.items():
        group = ("running_var" if k.endswith("running_var") else "running_mean"
                 if k.endswith("running_mean") else "param" if v.is_floating_point()
                 else "count")
        err = ((got[k].double() - v.double()).abs().max().item()
               / max(1.0, v.abs().max().item()))
        errs[group] = max(errs.get(group, 0.0), err)
    return errs


def _sin_grads(fn, *tensors):
    tensors = [t.clone().requires_grad_(True) for t in tensors]
    y = fn(*tensors)
    torch.sin(y).sum().backward()
    return [y.detach()] + [t.grad for t in tensors]


def op_errors(space: int, device) -> dict:
    """The largest error of each halo op on this rank's strip against the op on
    the whole map, over the largest magnitude (every rank must call it)."""
    from stcd_tpu_torch.layers.modules import resize_bilinear
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.spatial import spatial_context

    s, group = distributed.space_rank(), distributed.space_group()
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(device)

    def strip(t, world=space):
        h = t.shape[2] // world
        return t[:, :, s * h:(s + 1) * h]

    def err(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()

    # name: (global rows, kernel, stride, padding, dilation)
    convs = {"k7s2p3_stem": (16 * space, 7, 2, 3, 1), "k3s1p1": (8 * space, 3, 1, 1, 1),
             "k3s2p1": (8 * space, 3, 2, 1, 1), "k1s2": (8 * space, 1, 2, 0, 1),
             "k3d2p2": (8 * space, 3, 1, 2, 2), "k3_1row_strips": (space, 3, 1, 1, 1),
             "k7_gather_path": (2 * space, 7, 1, 3, 1)}
    out = {}
    for name, (h, k, stride, pad, dil) in convs.items():
        x, w, b = rand(2, 8, h, 12), rand(8, 8, k, k) * 0.1, rand(8)

        def conv(x, w, b):
            return F.conv2d(x, w, b, stride, pad, dil)

        want = _sin_grads(conv, x, w, b)
        with spatial_context(space):
            got = _sin_grads(conv, strip(x), w, b)
        for g in got[2:]:
            torch.distributed.all_reduce(g, group=group)
        out[name] = max(err(got[0], strip(want[0])), err(got[1], strip(want[1])),
                        err(got[2], want[2]), err(got[3], want[3]))
    for name, fn, x in (
            ("max_pool_k3s2p1", lambda t: F.max_pool2d(t, 3, 2, 1), rand(2, 4, 8 * space, 9) - 5),
            ("bilinear_x2", lambda t: resize_bilinear(t, (2 * t.shape[2], 2 * t.shape[3])),
             rand(2, 4, 4 * space, 9))):
        want = _sin_grads(fn, x)
        with spatial_context(space):
            got = _sin_grads(fn, strip(x))
        out[name] = max(err(got[0], strip(want[0])), err(got[1], strip(want[1])))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reference", help="write the one-process run here (a plain process)")
    p.add_argument("--against", help="the reference to hold the ranks' run against")
    p.add_argument("--data", type=int, default=1, help="the data axis (space: W / data)")
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.reference:
        torch.save(cd_steps_run(), args.reference)
        return 0

    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh

    device = distributed.initialize("cuda")
    space = distributed.world_size() // args.data
    mesh = create_mesh(data=args.data, space=space)
    ops = op_errors(space, device)
    run = cd_steps_run(mesh=mesh)
    want = torch.load(args.against, weights_only=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], want["losses"]))
    flips = max(sum(abs(a - b) for ga, wa in zip(got, w) for a, b in zip(ga, wa)) // 2
                for got, w in zip(run["counts"], want["counts"]))
    errs = state_errors(want["state"], run.pop("state"))
    mine = {"rank": distributed.rank(), "device": str(device), "ops": ops,
            "loss_err": loss_err, "flips": flips, "state_errs": errs,
            **{k: run[k] for k in ("losses", "step_ms", "first_ms", "peak_gib")}}
    ranks = [None] * distributed.world_size()
    torch.distributed.all_gather_object(ranks, mine)
    ok = all(max(r["ops"].values()) <= OP_TOL and r["loss_err"] <= LOSS_RTOL
             and r["flips"] <= CM_PIXELS and r["state_errs"]["param"] <= PARAM_SHARE
             and max(r["state_errs"]["running_mean"], r["state_errs"]["running_var"])
             <= STATS_SHARE for r in ranks)
    if distributed.is_primary():
        print("CHECK_SPATIAL " + json.dumps({
            "ok": ok, "backend": torch.distributed.get_backend(), "data": args.data,
            "space": space, "reference": {k: want[k] for k in ("losses", "step_ms",
                                                               "first_ms", "peak_gib")},
            "ranks": ranks}), flush=True)
    distributed.barrier("check_spatial")
    torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
