"""Device-step profile of the port on one CUDA card: the ChangeFormerV6
serving step, or the SegCD stage-2 train step (the counterpart of
benchmarks/profile_changeformer.py and of bench.py's timed loop).

Usage, from the root of a checkout, on a machine with a CUDA card:

  python -m stcd_tpu_torch.tools.profile_step [--out profile.json] \\
      [--init_seed 0 | --weights v6.pt] [--tile 256]
  python -m stcd_tpu_torch.tools.profile_step --mode train [--out profile.json]

``--mode train`` runs the step that ``create_train_state`` and
``make_cd_steps(augment=True)`` build for SegCD with a ResNet-50 encoder and
the (256, 128, 64, 32, 16) decoder on 256x256 pairs, seeded random weights and
a fixed seeded uint8 batch on the card: in bf16 autocast at batch 64, and in
fp32 with TF32 off at batch 8. For each it gives step ms (median of 10, host
clock and CUDA events), a torch.profiler trace of 3 steps (device ms per
kernel name, busy share of the profiled window, and the kernel time as a
share of the unprofiled step), the device ms per step of the augmentation
kernel and of the optimizer's kernels, and the peak memory.

``--mode serve`` (the default) profiles the serving step. A step there
is what the serving engine's worker runs for one device batch: two
(16, tile, tile, 3) float32 tile stacks to the card, the full-width model
(seeded random weights unless ``--weights``), P(changed) back to the host.
It is run in three precisions: fp32 with TF32 off (what ``cli.serve``
runs), fp32 with TF32 on (cuDNN's default, which
``cli.predict.build_model`` turns off), and bf16 autocast (``--bf16``).
For each:

- step ms: the median of 10 steps, host clock and CUDA events, in
  four groups with the SRA attention plain, kernel, kernel, plain;
- a torch.profiler trace of 3 steps with the kernel attention: device ms
  per kernel name, and the busy share of the device, i.e. the union of its
  kernel and copy intervals over the span from the first to the last.

Prints a summary; ``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import time

import numpy as np
import torch

BATCH = 16  # the serving default of cli.serve
STEPS = 10  # per timed group
PRECISIONS = (("fp32", False, False), ("fp32_tf32", True, False), ("bf16", False, True))


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@contextlib.contextmanager
def plain_attention():
    """Run every SRA block with the plain PyTorch attention."""
    from stcd_tpu_torch.models import changeformer
    from stcd_tpu_torch.ops import attention

    changeformer.cross_attention = functools.partial(attention.cross_attention,
                                                     impl="plain")
    try:
        yield
    finally:
        changeformer.cross_attention = attention.cross_attention


def time_steps(step, n: int):
    """Median host-clock and CUDA-event ms of ``n`` steps."""
    host, dev = [], []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        step()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    return float(np.median(host)), float(np.median(dev))


def profile_steps(step, n: int = 3, top: int = 15, groups=None):
    """Device ms per step by kernel name, and the device's busy share.
    ``groups`` maps a label to substrings of kernel names; the result then
    holds the device ms per step of the kernels that match each label."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    # device-side events are kernels and copies, and the mirrors of the host's
    # record_function spans (e.g. the optimizer's step), which carry a host
    # event's name and would count their kernels twice
    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name not in host_names]
    if not events:
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    by_name = {}
    for e, (s, t) in zip(events, spans):
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t - s) / 1e3, calls + 1)
    window = max(t for _, t in spans) - min(s for s, _ in spans)
    busy = union_length(spans)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    group_ms = {label: sum(ms for name, (ms, _) in by_name.items()
                           if any(part in name for part in parts)) / n
                for label, parts in (groups or {}).items()}
    return {
        "group_ms_per_step": group_ms,
        "steps": n,
        "device_ms_per_step": sum(ms for ms, _ in by_name.values()) / n,
        "busy_ms": busy / 1e3, "window_ms": window / 1e3,
        "busy_share": busy / window,
        "top": [{"name": name[:120], "ms_per_step": ms / n, "calls_per_step": calls / n}
                for name, (ms, calls) in kernels],
    }


TRAIN_PRECISIONS = (("bf16", True, 64), ("fp32", False, 8))  # name, autocast, batch
TRAIN_GROUPS = {
    "augment_kernel": ("gray_mean_partials", "pointwise_chain", "blur_normalize"),
    "optimizer": ("multi_tensor_apply", "adam"),
}


def seeded_cd_batch(batch: int, size: int, seed: int, device) -> dict:
    """A fixed train batch: uint8 image pairs and a 20 % positive label."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a, b = (torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                          dtype=torch.uint8).to(device) for _ in range(2))
    label = (torch.rand(batch, size, size, 1, generator=gen) > 0.8).float().to(device)
    return {"A": a, "B": b, "label": label}


def print_profile(prof) -> None:
    if prof is None:
        print("  torch.profiler recorded no device events: profile not measured")
        return
    print(f"  device busy {prof['busy_ms']:.2f} of {prof['window_ms']:.2f} ms over "
          f"{prof['steps']} steps ({100 * prof['busy_share']:.1f} %); "
          f"kernel time {prof['device_ms_per_step']:.3f} ms per step")
    for label, ms in prof["group_ms_per_step"].items():
        print(f"  {label}: {ms:.3f} ms per step")
    for k in prof["top"]:
        print(f"  {k['ms_per_step']:9.3f} ms {k['calls_per_step']:6.1f}x  "
              f"{k['name'][:100]}")


def profile_train(gpu: str, size: int = 256) -> dict:
    """The SegCD-r50 stage-2 train step in each of TRAIN_PRECISIONS."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
           "model": "SegCD resnet50 (256,128,64,32,16)", "size": size, "precisions": {}}
    train_step, _ = make_cd_steps(augment=True)
    for name, bf16, batch in TRAIN_PRECISIONS:
        model = init_weights(SegCD("resnet50", classes=1), seed=0)
        state = create_train_state(model, adam_poly(1e-3, 60, 1000), device="cuda",
                                   bf16=bf16)
        data = seeded_cd_batch(batch, size, seed=1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)

        def step():
            return train_step(state, data, gen)

        torch.cuda.reset_peak_memory_stats()
        time_steps(step, 3)  # warm: cuDNN picks its algorithms
        host, dev = time_steps(step, STEPS)
        prof = profile_steps(step, groups=TRAIN_GROUPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res["precisions"][name] = {"batch": batch, "host_ms": host, "event_ms": dev,
                                   "pairs_per_s": batch / dev * 1e3, "peak_gib": peak,
                                   "profile": prof}
        print(f"== train {name} batch {batch} on {gpu}: step ms (median of {STEPS}; "
              f"host / events) {host:.3f} / {dev:.3f}; {batch / dev * 1e3:.1f} pairs/s; "
              f"peak device memory {peak:.3f} GiB", flush=True)
        print_profile(prof)
        if prof is not None:
            # the profiler slows the host, so its window understates the busy
            # share of a plain run: one stream, so kernel time over step time
            share = prof["device_ms_per_step"] / dev
            res["precisions"][name]["busy_share_unprofiled"] = share
            print(f"  kernel time over the unprofiled step: {100 * share:.1f} %")
        del state, model, data
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    from stcd_tpu_torch.cli.predict import add_model_args, build_model, make_base_fn

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None, help="write the numbers as JSON here")
    p.add_argument("--mode", choices=("serve", "train"), default="serve")
    add_model_args(p)
    p.set_defaults(net_G="ChangeFormerV6")  # the serving step profiled here is V6's
    args = p.parse_args(argv)
    if args.init_seed is None and args.weights is None:
        args.init_seed = 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.mode == "train":
        res = profile_train(gpu, args.tile)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return res
    model = build_model(args)
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(0, 1, (BATCH, args.tile, args.tile, 3)).astype(np.float32)
            for _ in range(2))
    res = {"gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
           "net_G": args.net_G, "batch": BATCH, "tile": args.tile,
           "precisions": {}}
    for name, tf32, bf16 in PRECISIONS:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        base_fn = make_base_fn(argparse.Namespace(**{**vars(args), "bf16": bf16}), model)

        def step():
            ta = torch.from_numpy(a).to(device)
            tb = torch.from_numpy(b).to(device)
            return base_fn(ta, tb).float().cpu()

        with torch.inference_mode():
            groups = []
            for attn in ("plain", "kernel", "kernel", "plain"):
                with plain_attention() if attn == "plain" else contextlib.nullcontext():
                    time_steps(step, 3)  # warm this path
                    host, dev = time_steps(step, STEPS)
                groups.append({"attention": attn, "host_ms": host, "event_ms": dev})
            prof = profile_steps(step)
        res["precisions"][name] = {"groups": groups, "profile": prof}
        print(f"== {name} on {gpu}, step ms (median of {STEPS}; host / events):",
              flush=True)
        for g in groups:
            print(f"  {g['attention']:6s} {g['host_ms']:.3f} / {g['event_ms']:.3f}")
        print_profile(prof)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak device memory {res['peak_gib']:.3f} GiB", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
