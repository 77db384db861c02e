"""Tensor parallelism on cards: the stage-2 step and ``CDTrainer(tp_axis)``
through ``parallel/tensor.py``'s splits, against the one-process step.

Usage (the reference first, in a plain process on one card; then the ranks):

  python -m stcd_tpu_torch.tools.check_tensor_parallel --reference ref.pt
  torchrun --nproc_per_node 4 -m stcd_tpu_torch.tools.check_tensor_parallel --against ref.pt

Four ranks, one a card under NCCL, run RUNS at the grids of GRIDS[4]; two
ranks on card 0 under gloo (``--device cuda:0``, as ``chip_smoke.py``'s
phase 25 runs them) run GRIDS[2]:

- ``segcd``: SegCD-r50 (decoder 256..16) through ``cli.common.make_mesh`` /
  ``place_state`` and ``make_cd_steps`` (augmentation on), 256x256 pairs,
  global batch 8, fp32 (TF32 off), at data 2 x model 2 (4 ranks) or model 2
  (2 ranks): the wide-conv rule splits 10 kernels (layer4 and the decoder's
  first conv);
- ``v6``: ``CDTrainer`` over ChangeFormerV6 at embed 256, the same batch
  size, at the same grids: the SRA attention of stages 2-4 and every
  MixFFN split by heads and hidden channels (kernels #1 and #2, ``f32_cuda``,
  on each rank's heads), 8 wide convs; then a second step with the encoder's
  attention and MLP dropout at 0.1, after which every rank must hold the
  state and generator of every other;
- ``bit_pp``: ``CDTrainer`` over ``base_transformer_pos_s4_dd8`` at model 2
  x stage 2 (4 ranks only): the decoder's blocks split by heads inside the
  pipeline (``small_m`` with a head offset).

Each takes one SGD step with the dropouts off (``segcd`` without the
augmentation's randomness differing: the draws come from one seeded
generator) and, for the trainers, one eval batch, from one set of seeded
weights, and is held against the one process's step on the same global
batch: the loss within LOSS_RTOL, the counts but for CM_PIXELS, every state
tensor within STATE_SHARE of its largest magnitude (the gathered state, the
one-process layout), this rank's eval logits within LOGIT_SHARE. A second
step is timed warm (host clock, synchronized). Each rank reports its bytes of
parameters and their Adam moments (an Adam over its parameters, one step at
rate 0) against one process's, its peak memory and its launches of kernels
#1 and #2. Rank 0 prints one ``CHECK_TENSOR_PARALLEL {json}`` line with
every rank's numbers; a failed check exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import torch

# name: (net_G, global batch, image size)
RUNS = {"segcd": ("SegCD-r50", 8, 256), "v6": ("ChangeFormerV6", 8, 256),
        "bit_pp": ("base_transformer_pos_s4_dd8", 8, 256)}
# ranks of the launch: {run: (model, stage)}, data the rest
GRIDS = {2: {"segcd": (2, 1), "v6": (2, 1)},
         4: {"segcd": (2, 1), "v6": (2, 1), "bit_pp": (2, 2)}}
# kernel #1's launches a forward on one rank: V6's 13 SRA blocks; BIT's decoder blocks a
# stage (8 over the stages) times its 2 decodes (A and B) and 2 microbatches
LAUNCHES = {"segcd": 0, "v6": 13, "bit_pp": 4 * 2 * 2}
VARIANT = {"v6": "f32_cuda", "bit_pp": "small_m"}
# fp32 with TF32 off, one step, against one process: the row-parallel Linears and the
# input-split transposed convs sum their partial products over the ranks, the gathered
# convs add their bias after; BatchNorm sees the same rows. The bounds of
# tools/check_pipeline.py, whose runs move the same sums
LOSS_RTOL = 1e-5
CM_PIXELS = 64
# SegCD's BatchNorms after layer4 see 8 x 8 x 8 values a
# channel at 256x256, which turns float32 noise into more (a float64 run of the split
# step equals one process's to 3e-14, tests/test_torch_tensor_parallel.py): its bounds
# are chip_smoke.py's data-parallel ones for the same step (DP_PARAM_SHARE,
# DP_STATS_SHARE)
PARAM_SHARE = {"segcd": 3e-5, "v6": 1e-5, "bit_pp": 1e-5}
STATS_SHARE = {"segcd": 5e-4, "v6": 1e-5, "bit_pp": 1e-5}
LOGIT_SHARE = 1e-4
DROPOUT = 0.1


def _batch(n: int, size: int, device) -> dict:
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch

    return seeded_cd_batch(n, size, seed=7, device=device)


def adam_bytes(model) -> int:
    """The bytes of ``model``'s parameters and of an Adam's moments over them
    (one step at rate 0, so the moments exist at the parameters' shapes)."""
    from stcd_tpu_torch.parallel import tensor

    params = [p for p in model.parameters()]
    grads = [p.grad for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    opt = torch.optim.Adam(params, lr=0.0)
    opt.step()
    n = tensor.state_bytes(model, opt)
    for p, g in zip(params, grads):
        p.grad = g
    del opt
    return n


def _counted(counts: dict, name: str, fn):
    """``fn()`` and its host ms, with the launches of kernels #1 and #2 (and
    of the augmentation kernel) it made, counted from 0, in ``counts[name]``."""
    from stcd_tpu_torch.ops.attention import cross_attention_kernel as kern
    from stcd_tpu_torch.ops.augment import apply_augment_kernel as aug

    kern.kernel_launches = kern.backward_launches = aug.kernel_launches = 0
    kern.forward_variants.clear()
    kern.backward_variants.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts[name] = {"fwd": kern.kernel_launches, "bwd": kern.backward_launches,
                    "aug": aug.kernel_launches,
                    "variants": sorted(set(kern.forward_variants)
                                       | set(kern.backward_variants))}
    return out, ms


def _full_state(model) -> dict:
    from stcd_tpu_torch.parallel import tensor

    return {k: v.detach().to("cpu", copy=True)
            for k, v in tensor.full_state_dict(model).items()}


def segcd_run(grid=None, device="cuda") -> dict:
    """``segcd``: one process (``grid`` None) or this rank of a data x model
    grid of ``grid = (model, stage)``, through the stage CLIs' mesh helpers."""
    import argparse as ap

    from stcd_tpu_torch.cli import common
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.parallel.mesh import batch_sharding
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps

    _, n, size = RUNS["segcd"]
    model = init_weights(SegCD("resnet50", classes=1, decoder_channels=(256, 128, 64, 32, 16)),
                         seed=0)
    state = create_train_state(model, SGDConfig(lambda step: 0.01), device=device)
    rows = slice(None)
    if grid is not None:
        mesh = common.make_mesh(ap.Namespace(device=str(device), data_axis=None,
                                             model_axis=grid[0], space_axis=1, batch_size=n))
        state = common.place_state(mesh, state)
        rows = batch_sharding(mesh)
    train_step = make_cd_steps(augment=True)[0]
    batch = {k: v[rows] for k, v in _batch(n, size, device).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    gen = torch.Generator(device=device).manual_seed(2)
    out, first_ms = _counted(counts, "train", lambda: train_step(state, batch, gen))
    res = {"loss": float(out["loss"]), "cm": out["cm"].cpu().tolist(), "first_ms": first_ms,
           "state": _full_state(state.model)}
    _, res["step_ms"] = _counted(counts, "warm", lambda: train_step(state, batch, gen))
    counts.pop("warm")
    return {**res, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts, "adam_bytes": adam_bytes(state.model)}


def _dropout(model, rate: float) -> None:
    """The encoder's Dropouts and attention dropout at ``rate``; every other
    dropout and DropPath off."""
    from stcd_tpu_torch.layers.stochastic import Dropout
    from stcd_tpu_torch.tools.check_pipeline import no_dropout

    no_dropout(model)
    enc = getattr(model, "Tenc_x2", None)
    for m in enc.modules() if enc is not None and rate else ():
        if isinstance(m, Dropout):
            m.p = rate
        elif hasattr(m, "attn_drop"):
            m.attn_drop = rate


def trainer_run(kind: str, grid=None, device="cuda") -> dict:
    """``v6`` or ``bit_pp``: one process (``grid`` None) or this rank of the
    data x model x stage grid ``grid = (model, stage)``: the loss, the counts,
    this rank's eval logits and the gathered state after the step, the first
    step's ms and a warm second step's, the peak GiB, the launches."""
    from stcd_tpu_torch.parallel.mesh import batch_sharding
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    net_G, n, size = RUNS[kind]
    model, stage = grid or (1, 1)
    cfg = TrainerConfig(net_G=net_G, img_size=size, batch_size=n, device=str(device),
                        embed_dim=256, tp_axis=model, pp_stages=stage)
    trainer = CDTrainer(cfg, steps_per_epoch=2)
    state = trainer.init_state(device, init_seed=0)
    _dropout(state.model, 0.0)
    rows = slice(None) if grid is None else batch_sharding(trainer.mesh)
    data = _batch(n, size, device)
    a, b, label = (data[k][rows] for k in ("A", "B", "label"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    (loss, cm), first_ms = _counted(counts, "train",
                                    lambda: trainer.train_step(state, a, b, label))
    (logits, cm_eval), _ = _counted(counts, "eval",
                                    lambda: trainer.eval_step(state, a, b, label))
    out = {"loss": loss.item(), "cm": cm.cpu().tolist(), "cm_eval": cm_eval.cpu().tolist(),
           "logits": logits.float().cpu(), "first_ms": first_ms,
           "state": _full_state(state.model)}
    _, out["step_ms"] = _counted(counts, "warm", lambda: trainer.train_step(state, a, b, label))
    counts.pop("warm")
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=counts,
               adam_bytes=adam_bytes(state.model))
    if kind == "v6" and grid is not None:
        _dropout(state.model, DROPOUT)
        out["dropout"] = {}
        _, _ = _counted(out["dropout"], "train", lambda: trainer.train_step(state, a, b, label))
        digest = hashlib.sha256()
        for k, v in _full_state(state.model).items():
            digest.update(k.encode())
            digest.update(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        out["dropout"]["state"] = digest.hexdigest()
        out["dropout"]["generator"] = hashlib.sha256(
            state.generator.get_state().cpu().numpy().tobytes()).hexdigest()
    return out


def run(kind: str, grid=None, device="cuda") -> dict:
    return segcd_run(grid, device) if kind == "segcd" else trainer_run(kind, grid, device)


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1.0)).item()


def _pixels(got, want) -> int:
    return sum(abs(x - y) for ga, wa in zip(got, want) for x, y in zip(ga, wa)) // 2


def compare(kind: str, ref: dict, got: dict, rank: int, grid) -> dict:
    """This rank's run against the one-process run: the errors, and the
    failures against the bounds (an empty list passes)."""
    from stcd_tpu_torch.parallel import distributed

    model, stage = grid
    worst = {}
    for k, v in ref["state"].items():
        if v.is_floating_point():
            group = "stats_share" if "running" in k else "param_share"
            worst[group] = max(worst.get(group, (-1.0, "")), (share(got["state"][k], v), k))
    errs = {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "cm_pixels": _pixels(got["cm"], ref["cm"]),
            **{group: e for group, (e, _) in worst.items()}}
    if "logits" in ref:
        rows = slice(distributed.data_rank(), None, distributed.data_size())
        errs["cm_eval_pixels"] = _pixels(got["cm_eval"], ref["cm_eval"])
        errs["logit_share"] = share(got["logits"], ref["logits"][rows])
    fails = []
    if errs["loss_rel"] > LOSS_RTOL:
        fails.append(f"loss {got['loss']} against {ref['loss']}")
    if max(errs["cm_pixels"], errs.get("cm_eval_pixels", 0)) > CM_PIXELS:
        fails.append(f"counts differ in {errs['cm_pixels']} / {errs.get('cm_eval_pixels')} "
                     "pixels")
    for group, bound in (("param_share", PARAM_SHARE), ("stats_share", STATS_SHARE)):
        if group in worst and worst[group][0] > bound[kind]:
            fails.append(f"{worst[group][1]} {worst[group][0]:.3e} of max(1, |w|)")
    if errs.get("logit_share", 0.0) > LOGIT_SHARE:
        fails.append(f"eval logits {errs['logit_share']:.3e}")
    want = LAUNCHES[kind]
    seen = got["launches"]
    if (seen["train"]["fwd"], seen["train"]["bwd"]) != (want, want) or (
            "eval" in seen and seen["eval"]["fwd"] != want):
        fails.append(f"launched {seen}, not {want} of each")
    if want and {v for p in seen.values() for v in p["variants"]} != {VARIANT[kind]}:
        fails.append(f"launched variants {seen}")
    if got["adam_bytes"] >= ref["adam_bytes"]:
        fails.append(f"holds {got['adam_bytes']} bytes, one process {ref['adam_bytes']}")
    return {"errors": errs, "fails": fails,
            "bytes_ratio": got["adam_bytes"] / ref["adam_bytes"]}


def rank_checks(ref: dict, device) -> dict:
    """Every run of GRIDS[world] on this rank of the launch, against ``ref``
    (the one-process runs), V6's dropout step gathered to every rank.
    Returns this rank's report."""
    import torch.distributed as dist

    from stcd_tpu_torch.parallel import distributed

    world = distributed.world_size()
    report = {"rank": distributed.rank(), "backend": dist.get_backend(),
              "device": str(device)}
    for kind, grid in GRIDS[world].items():
        got = run(kind, grid, device)
        res = compare(kind, ref[kind], got, distributed.rank(), grid)
        if "dropout" in got:
            mine = got["dropout"]
            gathered = [None] * world
            dist.all_gather_object(gathered, mine)
            for r, other in enumerate(gathered):
                if (other["state"], other["generator"]) != (mine["state"], mine["generator"]):
                    res["fails"].append(f"after the dropout step rank {r}'s state or "
                                        "generator differs")
            if (mine["train"]["fwd"], mine["train"]["bwd"]) != (LAUNCHES[kind],) * 2:
                res["fails"].append(f"dropout step launched {mine['train']}")
            res["dropout_launches"] = mine["train"]
        report[kind] = {**res, "grid": grid, "model_rank": distributed.model_rank(),
                        **{k: got[k] for k in ("first_ms", "step_ms", "peak_gib", "launches",
                                               "adam_bytes")}}
        del got
        torch.cuda.empty_cache()
    return report


def reference(kinds=None, device="cuda") -> dict:
    """The one-process runs of ``kinds`` (default all of RUNS)."""
    out = {}
    for kind in kinds or RUNS:
        out[kind] = run(kind, None, device)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reference", help="write the one-process runs here")
    p.add_argument("--against", help="the reference file the ranks are held against")
    p.add_argument("--device", default="cuda",
                   help="cuda: one card a rank under NCCL; cuda:0: every rank on card 0 "
                        "under gloo")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_tensor_parallel: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.reference:
        torch.save(reference(), args.reference)
        return 0
    from stcd_tpu_torch.parallel import distributed

    device = distributed.initialize(args.device)
    if distributed.world_size() not in GRIDS:
        raise ValueError(f"launch {sorted(GRIDS)} ranks, not {distributed.world_size()}")
    ref = torch.load(args.against, weights_only=False)
    report = rank_checks(ref, device)
    reports = [None] * distributed.world_size()
    torch.distributed.all_gather_object(reports, report)
    kinds = GRIDS[distributed.world_size()]
    fails = [f"rank {r['rank']} {kind}: {f}" for r in reports for kind in kinds
             for f in r[kind]["fails"]]
    if distributed.is_primary():
        print("CHECK_TENSOR_PARALLEL " + json.dumps({
            "world": distributed.world_size(), "backend": report["backend"],
            "reference": {k: {x: ref[k][x] for x in ("first_ms", "step_ms", "peak_gib",
                                                     "adam_bytes")} for k in kinds},
            "ranks": reports, "fails": fails}), flush=True)
    distributed.barrier("check_tensor_parallel done")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
