"""Serving split over the cards of one process (``serving/replicas.py``,
``BatchingEngine(devices=...)``, ``cli.predict``), against one card.

Usage, on a host with several cards (one process; no process group):

  python -m stcd_tpu_torch.tools.check_sharded_serving [--out result.json]

- (a) ChangeFormerV6 at its published widths (embed 256), seeded weights,
  fp32 with TF32 off as ``cli.serve`` runs it, tile 256, batch 16, behind the
  engine on 1, 2 and 4 cards (every count up to the visible cards): a closed
  loop of CALLERS concurrent ``predict_pair`` callers, each sending its own
  512x512 scene REQUESTS times after a warm-up batch on every card. Reports
  tiles/s over the loop (host clock), ``step_ms`` and ``request_latency_ms``
  p50 / p99 from ``/stats``, kernel #1's launches by card and each card's peak
  GiB. The stitched maps on D cards must equal one card's within PROBS_ATOL,
  the launches must be 13 a replica step, all ``f32_cuda``, spread evenly over
  the cards.
- (b) the same under ``--bf16`` (``mma_bf16``). bf16 rounds the logits of
  these random weights (magnitudes near 30, an ulp of 0.125) to P(changed)
  that moves by up to about 0.19 with the kernels cuDNN picks for another
  batch size (a one-card bf16 map against fp32 is as far off, chip_smoke
  phase 4), so D cards are held to one card run at their own rows a card,
  batch 16 / D, within PROBS_ATOL; their distance to one card at batch 16 is
  reported.
- (c) SegCD-r50 (decoder 256..16) with ``--int8``: one scale table calibrated
  on card 0, a replica on each card, against the one-card int8 engine: the
  decisions at 0.5 agree on at least 1 - INT8_F1_TOL of the pixels (chip_smoke
  phase 16's tolerance), and /stats says quantized.
- (d) ``cli.predict`` over every card (its default batch, 4 x the cards)
  against ``--no_shard`` on one 1024x1024 scene: probabilities within
  PROBS_ATOL.
- (e) one launch of kernel #1 on the last card from the main thread, whose
  current card is 0: the thread's current card is still 0 after it.
- (f) where a step's host time goes (V6 fp32 and bf16, batch 16 over D
  cards, median of DISPATCH_REPS, host clock to the copies back): one
  replica's forward of 16 / D rows alone, the D replicas' forwards issued in
  turn and then collected (``Replicas.run``, as the engine runs a step), and
  the same at batch 16 D (16 rows a card).

Prints one ``CHECK_SHARDED_SERVING {json}`` line (and writes it to ``--out``);
a failed check exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

TILE, BATCH, SCENE = 256, 16, 512
CALLERS, REQUESTS = 8, 6  # 8 x 4 tiles in flight: two full batches queued
PROBS_ATOL = 1e-3  # chip_smoke.py's: stitched fp32 P(changed)
DISPATCH_REPS = 5
INT8_F1_TOL = 0.02  # chip_smoke.py phase 16's tolerance (the JAX int8 gate)
SRA_LAUNCHES = 13  # ChangeFormerV6's SRA blocks: kernel #1 launches a forward


def _args(extra=()):
    from stcd_tpu_torch.cli.predict import add_model_args
    p = argparse.ArgumentParser()
    add_model_args(p)
    return p.parse_args(["--init_seed", "0", "--device", "cuda", "--tile", str(TILE),
                         *extra])


def _scenes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 1, (SCENE, SCENE, 3)).astype(np.float32) for _ in range(2))
            for _ in range(n)]


def closed_loop(engine, scenes, requests: int):
    """``len(scenes)`` callers, caller i sending scene i ``requests`` times
    back to back. Returns each caller's last map and the loop's seconds."""
    results = [None] * len(scenes)
    errors = []

    def caller(i):
        try:
            for _ in range(requests):
                results[i] = engine.predict_pair(*scenes[i])
        except Exception as exc:  # re-raised in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(scenes))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a caller did not finish in 900 s")
    return results, seconds


def serve_run(model, args, cards: int, scenes, requests: int, calib=None,
              batch: int = BATCH) -> dict:
    """One engine over cards 0 .. cards - 1: the loop's maps and readings."""
    from stcd_tpu_torch.cli.predict import make_replicas
    from stcd_tpu_torch.ops import attention
    from stcd_tpu_torch.serving.server import BatchingEngine

    devices = [torch.device("cuda", i) for i in range(cards)]
    kernel = attention.cross_attention_kernel
    engine = BatchingEngine(make_replicas(args, model, devices, calib), tile=TILE,
                            batch=batch, max_wait_ms=20.0, devices=devices,
                            quantized=bool(args.int8))
    try:
        engine.warm()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        kernel.kernel_launches = 0
        kernel.forward_variants.clear()
        kernel.launches_by_device.clear()
        maps, seconds = closed_loop(engine, scenes, requests)
        launches = {"total": kernel.kernel_launches,
                    "by_card": {str(i): kernel.launches_by_device[i] for i in range(cards)},
                    "variants": dict(kernel.forward_variants)}
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    tiles = len(scenes) * requests * (SCENE // TILE) ** 2
    return {"maps": maps, "cards": cards, "tiles_per_s": tiles / seconds,
            "seconds": seconds, "tiles": tiles, "stats": stats, "launches": launches,
            "peak_gib": [torch.cuda.max_memory_allocated(d) / 2 ** 30 for d in devices]}


def max_dp(got, want) -> float:
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def check(failures: list, cond: bool, msg: str) -> None:
    if not cond:
        failures.append(msg)
        print(f"FAILED: {msg}", flush=True)


def summary(run: dict) -> dict:
    s = run["stats"]
    return {"cards": run["cards"], "tiles_per_s": run["tiles_per_s"],
            "seconds": run["seconds"], "tiles": run["tiles"], "batches": s["batches"],
            "occupancy": s["mean_batch_occupancy"],
            "step_ms_p50": s["step_ms"].get("p50"), "step_ms_p99": s["step_ms"].get("p99"),
            "latency_ms_p50": s["request_latency_ms"].get("p50"),
            "latency_ms_p99": s["request_latency_ms"].get("p99"),
            "devices": s["devices"], "mesh_sharded": s["mesh_sharded"],
            "quantized": s["quantized"], "errors": s["errors"],
            "launches": run["launches"], "peak_gib": run["peak_gib"]}


def v6_runs(failures: list, counts, requests: int, bf16: bool) -> list:
    from stcd_tpu_torch.cli.predict import build_model

    args = _args(["--net_G", "ChangeFormerV6", "--embed_dim", "256"]
                 + (["--bf16"] if bf16 else []))
    model = build_model(args)
    scenes = _scenes(1, CALLERS)
    variant = "mma_bf16" if bf16 else "f32_cuda"
    runs, out = [], []
    for cards in counts:
        run = serve_run(model, args, cards, scenes, requests)
        row = summary(run)
        s, launches = run["stats"], run["launches"]
        steps = s["batches"] * cards
        check(failures, s["errors"] == 0 and s["devices"] == cards
              and s["mesh_sharded"] is (cards > 1), f"{variant} {cards} cards: /stats {s}")
        check(failures, launches["total"] == SRA_LAUNCHES * steps
              and launches["variants"] == {variant: launches["total"]}
              and set(launches["by_card"].values()) == {SRA_LAUNCHES * s["batches"]},
              f"{variant} {cards} cards: launches {launches} for {s['batches']} steps")
        if runs:
            err = max_dp(run["maps"], runs[0]["maps"])
            row["max_abs_dp_vs_1_card"] = err
            if bf16:  # held to one card at the same rows a card
                own = serve_run(model, args, 1, scenes, 1, batch=BATCH // cards)
                err = row["max_abs_dp_vs_1_card_same_rows"] = max_dp(run["maps"], own["maps"])
            check(failures, err <= PROBS_ATOL, f"{variant} {cards} cards: max|dP| {err}")
        runs.append(run)
        out.append(row)
        print(f"{'bf16' if bf16 else 'fp32'} V6 on {cards} card(s): "
              f"{row['tiles_per_s']:.2f} tiles/s, step_ms p50 {row['step_ms_p50']} p99 "
              f"{row['step_ms_p99']}, latency_ms p50 {row['latency_ms_p50']} p99 "
              f"{row['latency_ms_p99']}, launches by card {launches['by_card']}, peak GiB "
              f"{[round(g, 3) for g in row['peak_gib']]}"
              + (f", max|dP| vs 1 card {row['max_abs_dp_vs_1_card']:.3e}" if cards > 1 else "")
              + (f" (vs 1 card at batch {BATCH // cards}: "
                 f"{row['max_abs_dp_vs_1_card_same_rows']:.3e})" if bf16 and cards > 1 else ""),
              flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def dispatch_run(counts, bf16: bool) -> list:
    """(f): the host time of one replica's forward alone, and of a step's
    forwards issued in turn over the cards as the engine issues them."""
    from stcd_tpu_torch.cli.predict import build_model, make_replicas
    from stcd_tpu_torch.serving.replicas import Replicas

    args = _args(["--net_G", "ChangeFormerV6", "--embed_dim", "256"]
                 + (["--bf16"] if bf16 else []))
    model = build_model(args)
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0, 1, (BATCH * max(counts), TILE, TILE, 3)).astype(np.float32)
            for _ in range(2))

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(DISPATCH_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    rows = []
    for cards in counts:
        devices = [torch.device("cuda", i) for i in range(cards)]
        replicas = Replicas(make_replicas(args, model, devices), devices)
        k = BATCH // cards
        alone = Replicas(replicas.fns[:1], devices[:1])
        row = {"cards": cards, "bf16": bf16, "rows_a_card": k,
               "one_forward_ms": median_ms(lambda: alone.run(a[:k], b[:k])),
               "step_in_turn_ms": median_ms(lambda: replicas.run(a[:BATCH], b[:BATCH])),
               "step_16_a_card_ms": median_ms(lambda: replicas.run(a[:BATCH * cards],
                                                                   b[:BATCH * cards]))}
        rows.append(row)
        print(f"dispatch, {'bf16' if bf16 else 'fp32'} V6, batch {BATCH} over {cards} card(s): "
              f"one forward of {k} rows {row['one_forward_ms']:.1f} ms; the {cards} forwards "
              f"issued in turn {row['step_in_turn_ms']:.1f} ms; batch {BATCH * cards} "
              f"({BATCH} a card) {row['step_16_a_card_ms']:.1f} ms (median of "
              f"{DISPATCH_REPS})", flush=True)
    del model
    torch.cuda.empty_cache()
    return rows


def int8_run(failures: list, cards: int) -> dict:
    from stcd_tpu_torch.cli.predict import build_model

    args = _args(["--int8"])
    model = build_model(args)
    scenes = _scenes(2, 4)
    calib = [torch.from_numpy(np.stack([s[k][:TILE, :TILE] for s in scenes])).cuda()
             for k in (0, 1)]
    one = serve_run(model, args, 1, scenes, 1, calib)
    many = serve_run(model, args, cards, scenes, 1, calib)
    agree = float(np.mean([np.mean((g > 0.5) == (w > 0.5))
                           for g, w in zip(many["maps"], one["maps"])]))
    err = max_dp(many["maps"], one["maps"])
    check(failures, many["stats"]["quantized"] is True and one["stats"]["quantized"] is True
          and many["stats"]["devices"] == cards, f"int8 /stats {many['stats']}")
    check(failures, agree >= 1 - INT8_F1_TOL, f"int8 {cards} cards: decisions agree {agree}")
    print(f"int8 SegCD-r50 on {cards} cards against 1: decisions agree on {agree:.6f} of the "
          f"pixels, max|dP| {err:.3e}", flush=True)
    return {"cards": cards, "decisions_agree": agree, "max_abs_dp": err,
            "one_card": summary(one), "many_cards": summary(many)}


def predict_cli_run(failures: list, cards: int) -> dict:
    from PIL import Image

    from stcd_tpu_torch.cli import predict

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name in ("a.png", "b.png"):
            img = (rng.uniform(0, 1, (1024, 1024, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(tmp, name))
            paths.append(os.path.join(tmp, name))
        common = ["--image_a", paths[0], "--image_b", paths[1], "--init_seed", "0",
                  "--out", os.path.join(tmp, "m.png")]
        probs = {}
        for name, extra in (("sharded", []), ("no_shard", ["--no_shard"])):
            t0 = time.monotonic()
            predict.main(common + ["--prob_out", os.path.join(tmp, f"{name}.npy"), *extra])
            probs[name] = (np.load(os.path.join(tmp, f"{name}.npy")), time.monotonic() - t0)
    err = float(np.abs(probs["sharded"][0] - probs["no_shard"][0]).max())
    check(failures, err <= PROBS_ATOL, f"cli.predict over {cards} cards: max|dP| {err}")
    print(f"cli.predict over {cards} cards against --no_shard: max|dP| {err:.3e}; "
          f"{probs['sharded'][1]:.2f} s against {probs['no_shard'][1]:.2f} s (model build "
          "included)", flush=True)
    return {"cards": cards, "max_abs_dp": err, "sharded_s": probs["sharded"][1],
            "no_shard_s": probs["no_shard"][1]}


def device_restore_run(failures: list, cards: int) -> dict:
    from stcd_tpu_torch.ops import attention

    last = cards - 1
    torch.cuda.set_device(0)
    q, k, v = (torch.randn(1, 2, 300, 64, device=f"cuda:{last}") for _ in range(3))
    out = attention.cross_attention(q, k, v, impl="kernel")
    torch.cuda.synchronize(last)
    after = torch.cuda.current_device()
    want = attention.cross_attention(q, k, v, impl="plain")
    err = float((out - want).abs().max())
    check(failures, after == 0, f"a launch on cuda:{last} left the thread on cuda:{after}")
    check(failures, err <= 2e-5, f"kernel #1 on cuda:{last} against plain: {err}")
    print(f"device restore: after a launch on cuda:{last}, current device {after}; kernel "
          f"against plain {err:.3e}", flush=True)
    return {"card": last, "current_device_after": after, "max_abs_err": err}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--requests", type=int, default=REQUESTS,
                   help="requests each caller sends in (a) and (b)")
    p.add_argument("--out", default=None, help="also write the result JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_sharded_serving: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    counts = [c for c in (1, 2, 4) if c <= n]
    failures: list = []
    t0 = time.monotonic()
    result = {"cards": n, "names": [torch.cuda.get_device_name(i) for i in range(n)]}
    try:
        result["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        result["nvidia_smi"] = None
    print(f"cards: {result['nvidia_smi']}", flush=True)
    result["device_restore"] = device_restore_run(failures, n)
    result["fp32"] = v6_runs(failures, counts, args.requests, bf16=False)
    result["bf16"] = v6_runs(failures, counts, args.requests, bf16=True)
    result["dispatch"] = dispatch_run(counts, bf16=False) + dispatch_run(counts, bf16=True)
    result["int8"] = int8_run(failures, n)
    result["predict_cli"] = predict_cli_run(failures, n)
    result["seconds"] = time.monotonic() - t0
    result["failures"] = failures
    line = "CHECK_SHARDED_SERVING " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
