"""Pipeline parallelism on cards: ``CDTrainer(pp_stages)``'s step and eval batch
through ``parallel/pipeline.py``'s three routes, against the one-process step.

Usage (the reference first, in a plain process on one card; then the ranks):

  python -m stcd_tpu_torch.tools.check_pipeline --reference ref.pt
  torchrun --nproc_per_node 4 -m stcd_tpu_torch.tools.check_pipeline --against ref.pt

Four ranks, one a card under NCCL (``--device cuda:0`` puts them all on card 0
under gloo, as ``chip_smoke.py``'s phase 24 does), run RUNS in turn:

- ``v6``: ChangeFormerV6 at its published widths, 256x256 pairs, global batch 8,
  fp32 (TF32 off), the MiT encoder's 4 stages over the 4 ranks (data 1), 4
  microbatches (kernels #1 and #2, ``f32_cuda``, on every stage);
- ``bit``: ``base_transformer_pos_s4_dd8``, the same batch, the decoder's 8
  blocks over 2 stages at data 2, 2 microbatches (``small_m``);
- ``vig``: ChangeGNNV2, the same batch, the ViG encoder's 4 stages.

Each takes one SGD step (the trainer's defaults) and one eval batch with the
dropouts off, from one set of seeded weights, and is held against the one
process's step on the same global batch (a second step and eval batch are
timed warm, host clock): the loss within LOSS_RTOL, the
counts but for CM_PIXELS, every state tensor within STATE_SHARE of its
largest magnitude, this rank's eval logits within LOGIT_SHARE. ViG's
reference runs its route without a stage axis: inside the pipeline its
stages run frozen-BN, JAX's documented deviation. Then ``v6`` takes a second
step with the attention dropout at 0.1: every stage's microbatches must
draw the same seeds (the same masks) and every rank must end it with the
state and generator of every other. Each rank counts its launches of
kernels #1 and #2, which must be its stages' blocks times the microbatches.
Rank 0 prints one ``CHECK_PIPELINE {json}`` line with every rank's numbers;
a failed check exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import torch

# name: (net_G, global batch, image size, stages, microbatches, data shards of 4 ranks)
RUNS = {"v6": ("ChangeFormerV6", 8, 256, 4, 4, 1),
        "bit": ("base_transformer_pos_s4_dd8", 8, 256, 2, 2, 2),
        "vig": ("ChangeGNNV2", 8, 256, 4, 4, 1)}
# the attention blocks of each stage: V6's encoder depths, BIT's decoder blocks a stage
BLOCKS = {"v6": (3, 3, 4, 3), "bit": (4, 4), "vig": (0, 0, 0, 0)}
DECODES = {"v6": 1, "bit": 2, "vig": 1}  # pipelined calls a forward (BIT decodes A, B)
VARIANT = {"v6": "f32_cuda", "bit": "small_m"}
# fp32 with TF32 off, one step, against one process: the same products, blocked by
# microbatch in the encoder's and decoder's matmuls and convs, summed in another order
# in BatchNorm's moments and the gradients; the counts move at pixels on the threshold.
# Measured with four gloo ranks on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 24),
# the worst of the three runs: loss 9.4e-8 relative, 1 pixel of 524288, state 7.1e-7
# of max(1, |w|) (BIT), eval logits 1.3e-5 of max(1, max |logit|) (BIT)
LOSS_RTOL = 1e-5
CM_PIXELS = 64
STATE_SHARE = 1e-5
LOGIT_SHARE = 1e-4
ATTN_DROPOUT = 0.1


def no_dropout(model, attention: float = 0.0):
    """Every Dropout and DropPath rate of ``model`` to 0, its attention dropout
    to ``attention``."""
    from stcd_tpu_torch.layers.stochastic import Dropout, DropPath
    from stcd_tpu_torch.models.changeformer import SRAttention

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, DropPath):
            m.rate = 0.0
        elif isinstance(m, SRAttention):
            m.attn_drop = attention
    return model


def _batch(n: int, size: int, device) -> tuple:
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch

    data = seeded_cd_batch(n, size, seed=7, device=device)
    return data["A"], data["B"], data["label"]


def trainer_run(kind: str, mesh=None, device="cuda") -> dict:
    """RUNS[kind]'s step and eval batch: one process on the global batch
    (``mesh`` None; ViG with its route on and no stage axis), or this rank of
    ``mesh`` (a data x stage grid of RUNS' shape) on its data shard's rows.
    Returns the loss, the counts, this rank's eval logits and the state after
    the step, the first step's host ms, a second step's and eval batch's
    (warm), the peak GiB and the launches of the compared step and eval."""
    from stcd_tpu_torch.ops.attention import cross_attention_kernel as kern
    from stcd_tpu_torch.parallel import pipeline as pp
    from stcd_tpu_torch.parallel.mesh import batch_sharding
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    net_G, n, size, stages, micro, _ = RUNS[kind]
    cfg = TrainerConfig(net_G=net_G, img_size=size, batch_size=n, device=str(device),
                        pp_stages=stages if mesh is not None else 1,
                        pp_microbatches=micro if mesh is not None else 0)
    trainer = CDTrainer(cfg, steps_per_epoch=2)
    if mesh is None and kind == "vig":
        pp.set_pipeline(trainer.model, None)
    state = trainer.init_state(device, init_seed=0)
    no_dropout(state.model)
    rows = slice(None) if mesh is None else batch_sharding(mesh)
    a, b, label = (t[rows] for t in _batch(n, size, device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {}

    def counted(fn, name):
        kern.kernel_launches = kern.backward_launches = 0
        kern.forward_variants.clear()
        kern.backward_variants.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts[name] = {"fwd": kern.kernel_launches, "bwd": kern.backward_launches,
                        "variants": sorted(set(kern.forward_variants)
                                           | set(kern.backward_variants))}
        return out, ms

    (loss, cm), first_ms = counted(lambda: trainer.train_step(state, a, b, label), "train")
    (logits, cm_eval), _ = counted(lambda: trainer.eval_step(state, a, b, label), "eval")
    out = {"loss": loss.item(), "cm": cm.cpu().tolist(), "cm_eval": cm_eval.cpu().tolist(),
           "logits": logits.float().cpu(), "first_ms": first_ms,
           "state": {k: v.detach().to("cpu", copy=True)
                     for k, v in state.model.state_dict().items()}}
    # warm times: a second step and eval batch, after the compared ones (host clock,
    # synchronized)
    _, out["step_ms"] = counted(lambda: trainer.train_step(state, a, b, label), "warm")
    _, out["eval_ms"] = counted(lambda: trainer.eval_step(state, a, b, label), "warm_eval")
    counts.pop("warm"), counts.pop("warm_eval")
    return {**out, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts, "trainer": trainer, "train_state": state,
            "batch": (a, b, label)}


def dropout_step(run: dict) -> dict:
    """A second step of ``run`` (a pipelined V6 run) with the attention
    dropout at ATTN_DROPOUT: this rank's attention calls (seed, rows, query
    shape) in order, and digests of its state and its generator's state after
    the step (equal digests: equal bytes)."""
    from stcd_tpu_torch.models import changeformer

    state, calls = run["train_state"], []
    plain = changeformer.cross_attention

    def record(q, k, v, scale=None, dropout_rate=0.0, dropout_seed=None, impl=None,
               dropout_rows=(0, 1), dropout_heads=None):
        if dropout_rate > 0.0:
            calls.append([int(dropout_seed), list(dropout_rows), list(q.shape)])
        return plain(q, k, v, scale, dropout_rate, dropout_seed, impl, dropout_rows,
                     dropout_heads)

    no_dropout(state.model, attention=ATTN_DROPOUT)
    changeformer.cross_attention = record
    try:
        run["trainer"].train_step(state, *run["batch"])
    finally:
        changeformer.cross_attention = plain
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return {"calls": calls,
            "generator": hashlib.sha256(state.generator.get_state().numpy().tobytes()).hexdigest(),
            "state": digest.hexdigest()}


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1.0)).item()


def compare(kind: str, ref: dict, got: dict, rank: int, mesh) -> dict:
    """This rank's run against the one-process run: the errors, and the
    failures against the bounds (an empty list passes)."""
    n_data = mesh.data
    rows = slice(rank // mesh.stage, None, n_data)
    flips = sum(abs(x - y) for ga, wa in zip(got["cm"], ref["cm"])
                for x, y in zip(ga, wa)) // 2
    flips_eval = sum(abs(x - y) for ga, wa in zip(got["cm_eval"], ref["cm_eval"])
                     for x, y in zip(ga, wa)) // 2
    state_err = max(share(got["state"][k], v) for k, v in ref["state"].items()
                    if v.is_floating_point())
    errs = {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "cm_pixels": flips, "cm_eval_pixels": flips_eval, "state_share": state_err,
            "logit_share": share(got["logits"], ref["logits"][rows])}
    fails = []
    if errs["loss_rel"] > LOSS_RTOL:
        fails.append(f"loss {got['loss']} against {ref['loss']}")
    if max(flips, flips_eval) > CM_PIXELS:
        fails.append(f"counts differ in {flips} / {flips_eval} pixels")
    if state_err > STATE_SHARE:
        fails.append(f"state {state_err:.3e} of max(1, |w|)")
    if errs["logit_share"] > LOGIT_SHARE:
        fails.append(f"eval logits {errs['logit_share']:.3e}")
    s = rank % mesh.stage
    want = BLOCKS[kind][s] * RUNS[kind][4] * DECODES[kind]
    launches = got["launches"]
    if (launches["train"]["fwd"], launches["train"]["bwd"], launches["eval"]["fwd"]) != (
            want, want, want):
        fails.append(f"stage {s} launched {launches}, not {want} of each")
    if want and {v for p in launches.values() for v in p["variants"]} != {VARIANT[kind]}:
        fails.append(f"stage {s} launched variants {launches}")
    return {"errors": errs, "fails": fails}


def masks_check(ranks: list, n_micro: int) -> list:
    """Across the ranks' dropout steps: each stage's microbatches drew the same
    seeds and rows, the stages drew distinct seeds, and the ranks' states
    and generators are one. Returns the failures."""
    fails, seen = [], []
    for r, d in enumerate(ranks):
        calls = d["calls"]
        per = len(calls) // n_micro
        if not calls or any(calls[i * per:(i + 1) * per] != calls[:per] for i in range(n_micro)):
            fails.append(f"rank {r}: its microbatches drew {calls}")
        seen.append({c[0] for c in calls})
    if any(seen[i] & seen[j] for i in range(len(seen)) for j in range(i + 1, len(seen))):
        fails.append(f"two stages drew one seed: {seen}")
    for r, d in enumerate(ranks[1:], start=1):
        if d["generator"] != ranks[0]["generator"]:
            fails.append(f"rank {r}'s generator differs from rank 0's")
        if d["state"] != ranks[0]["state"]:
            fails.append(f"rank {r}'s state differs from rank 0's")
    return fails


def rank_checks(ref: dict, device) -> dict:
    """Every run of RUNS on this rank of the launch, against ``ref`` (the
    one-process runs), and V6's dropout step gathered to every rank. Returns
    this rank's report."""
    import torch.distributed as dist

    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh

    rank = distributed.rank()
    report = {"rank": rank, "backend": dist.get_backend(), "device": str(device)}
    for kind, (_, _, _, stages, micro, n_data) in RUNS.items():
        mesh = create_mesh(stage=stages)
        if mesh.data != n_data:
            raise ValueError(f"{kind} runs on {stages * n_data} ranks, not {mesh.data * stages}")
        got = trainer_run(kind, mesh, device)
        res = compare(kind, ref[kind], got, rank, mesh)
        if kind == "v6":
            mine = dropout_step(got)
            gathered = [None] * distributed.world_size()
            dist.all_gather_object(gathered, mine)
            res["fails"] += masks_check(gathered, micro)
            res["dropout_calls"] = len(mine["calls"])
        report[kind] = {**res, **{k: got[k] for k in ("first_ms", "step_ms", "eval_ms",
                                                      "peak_gib", "launches")}}
        del got
        torch.cuda.empty_cache()
    return report


def reference(device="cuda") -> dict:
    """The one-process runs of RUNS, without their trainer objects."""
    out = {}
    for kind in RUNS:
        run = trainer_run(kind, None, device)
        out[kind] = {k: run[k] for k in ("loss", "cm", "cm_eval", "logits", "state", "first_ms",
                                         "step_ms", "eval_ms", "peak_gib", "launches")}
        del run
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
        print("check_pipeline: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.reference:
        torch.save(reference(), args.reference)
        return 0
    from stcd_tpu_torch.parallel import distributed

    device = distributed.initialize(args.device)
    ref = torch.load(args.against, weights_only=False)
    report = rank_checks(ref, device)
    reports = [None] * distributed.world_size()
    torch.distributed.all_gather_object(reports, report)
    fails = [f"rank {r['rank']} {kind}: {f}" for r in reports for kind in RUNS
             for f in r[kind]["fails"]]
    if distributed.is_primary():
        print("CHECK_PIPELINE " + json.dumps({
            "world": distributed.world_size(), "backend": report["backend"],
            "reference": {k: {x: ref[k][x] for x in ("first_ms", "step_ms", "eval_ms",
                                                     "peak_gib")}
                          for k in RUNS},
            "ranks": reports, "fails": fails}), flush=True)
    distributed.barrier("check_pipeline done")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
