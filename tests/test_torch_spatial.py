"""Spatial partitioning of stcd_tpu_torch (parallel/spatial.py, the space axis
of parallel/mesh.py and cli/common.py) against the global op, one process and
the JAX package.

The ranks are processes that run this file as a script (``--worker``) over
gloo with a ``file://`` rendezvous under the test's tmp_path, one torch
thread each, and import no JAX: the jobs of JOBS (two of 2 ranks at a space
axis of 2, one of 4 ranks, one process for the CLIs' one-process references)
run at once, while the parent computes the steps' one-process and JAX
references; the tests then read what each wrote.

1. halo_geometry equals JAX's on every case of tests/test_spatial_shardmap.py
   (the L = 2 cases included), and both raise JAX's ValueErrors word for word.
2. Ops on strips against the op on the whole map, in float64, through gloo's
   exchange (the all_gather of the edge rows; a card's NCCL exchange is
   tools/check_spatial.py's): the halo conv over the cases that F.conv2d
   expresses (L = 1: the stem, strided, dilated, 1x1, 1-row strips, a halo
   wider than a strip) on 2 and 4 ranks, forward, input gradient and weight
   and bias gradients (summed over the ranks), within OP_TOL; the max pool
   k3s2p1 over negative inputs, nearest x2 and bilinear x2 and x16
   upsampling, means over the rows and columns and over the rows alone, and
   layers/se.py's channel squeeze-and-excitation, forward and gradients. The
   divisibility error raises inside the mode, a transposed conv, a pool to a
   size and an average pool raise, the mode is gone after an exception, and a
   nested context of the same size is the context already entered. The
   exchange follows the backend, and ranks that share one card run gloo.
3. Each stage's train step (1: UnetSeg, 2: SegCD, 3: SegCD on synthesized and
   real pairs; resnet18, decoder (32, 24, 16, 12, 8), 64x64, augmentation on
   with injected draws, 3 SGD steps) at space 2 equals the one-process step:
   every loss term of every step within LOSS_RTOL, the counts but for pixels
   at the threshold, the parameters and running statistics after the steps
   within STATE_SHARE of each tensor's largest magnitude; stage 2 with
   accum_steps 2, without augmentation, and at data 2 x space 2 (4 ranks).
   The eval step's probabilities equal one process's, and its counts summed
   over the ranks.
4. Stage 2 without augmentation at space 2 equals JAX's make_spatial_cd_steps
   on a (data 1, space 2) mesh of CPU devices, at tests/test_torch_parallel.py's
   tolerances against JAX.
5. The four stage CLIs with --space_axis 2 log the loss that one process
   logs (LOSS_RTOL) and train the state that it trains (CLI_ATOL,
   CLI_AGREE); --space_axis 3, a non-resnet encoder and --remat raise, and
   --space_axis 2 with --model_axis 2 on two ranks says to launch four.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC = (32, 24, 16, 12, 8)
HW = 64
STEPS = 3
SCHEDULE = (1e-3, 2, 4)
# name: (stage, global batch, accum_steps, augment, data axis); space 2 throughout
CASES = {"stage1": (1, 4, 1, True, 1), "stage2_accum2": (2, 2, 2, True, 1),
         "stage3": (3, 2, 1, True, 1), "stage2_noaug": (2, 2, 1, False, 1),
         "stage2_data2": (2, 4, 1, True, 2)}
# Strips against the whole map in float64: the same products summed in another order.
# A share of the largest magnitude (measured on a CPU host: 5.4e-13 absolute on the x16
# upsampling's input gradient, whose elements sum 256 products).
OP_TOL = 1e-12
# Two strips against one process in float32: the BatchNorm moments and the Dice sums
# summed in another order, the convs on strips run by other blockings. Measured on a
# CPU host: loss terms within 1.2e-7 relative, parameters and running statistics within
# 3.2e-6 of the tensor's largest magnitude, eval probabilities within 6.3e-6 (stage 1).
LOSS_RTOL = 1e-5
STATE_SHARE = 5e-6
EVAL_ATOL = 1e-5
PORT_SHARE, JAX_SHARE = 4e-2, 1e-2  # tests/test_torch_train_steps.py, against float64
# The CLIs train with Adam (lr 1e-3), whose first update is lr times the sign of each
# gradient: an element whose gradient is within float32 noise of 0 moves either way, in
# a data-parallel run as much as in a spatial one (measured on a CPU host after 2 steps
# of train_ffctl: 22 % of the elements differ by more than 1e-5 at --data_axis 2 and at
# --space_axis 2 alike). Adam moves an element at most lr a step, so two runs of
# CLI_STEPS stay within 2 lr a step and float32 rounding (CLI_ATOL; measured 2.0e-3, a
# flipped sign, in stage 3), and nearly every element agrees within 1e-5 (CLI_AGREE;
# measured 0.99993 at the least, stage 3).
CLI_STEPS = 1  # 2 train tiles in global batches of 2
CLI_ATOL = 2 * 1e-3 * CLI_STEPS
CLI_AGREE = 0.999
CLI_FLAGS = ["--encoder", "resnet18", "--decoder_channels", "16,12,8,8,8", "--img_height",
             str(HW), "--img_width", str(HW), "--n_epochs", "1", "--n_cpu", "1",
             "--device", "cpu", "--no_preempt", "--batch_size", "2"]
CLIS = {"train_sup": ["--dataset_name", "WHU-AB", "--CDdataset_name", "WHU-AB"],
        "train_pse_cd": ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"],
        "train_stcd": ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"],
        "train_ffctl": ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"]}
WORKER_TIMEOUT = 240
# the spawned jobs and their ranks: the ops and steps at space 2, the CLIs at space 2,
# the ops at space 4 and stage 2 at data 2 x space 2, the CLIs in one process
JOBS = {"space2": 2, "cli_space2": 2, "space4": 4, "cli_one": 1}

# tests/test_spatial_shardmap.py:41-53
CONV_CASES = [
    # name,            H,  W, cin, cout, kh, sh, pt, pb, dh, L, S
    ("k3s1p1",         16, 16, 8, 8, 3, 1, 1, 1, 1, 1, 2),
    ("k7s2p3_stem",    32, 32, 3, 8, 7, 2, 3, 3, 1, 1, 2),
    ("k1s1",           16, 16, 8, 8, 1, 1, 0, 0, 1, 1, 2),
    ("k1s2_downsample", 16, 16, 8, 8, 1, 2, 0, 0, 1, 1, 2),
    ("k3s2p1",         16, 16, 8, 8, 3, 2, 1, 1, 1, 1, 2),
    ("k3d2p2_dilated", 16, 16, 8, 8, 3, 1, 2, 2, 2, 1, 2),
    ("k4L2p2_fusedup", 8,  8,  8, 8, 4, 1, 2, 2, 1, 2, 2),
    ("k4L2p2_tiny",    2,  2,  8, 8, 4, 1, 2, 2, 1, 2, 2),  # 1-row strips
    ("k3_1row_strips", 4,  4,  8, 8, 3, 1, 1, 1, 1, 1, 4),
    ("k7_gather_path", 8,  8,  8, 8, 7, 1, 3, 3, 1, 1, 4),  # halo > strip
]
TORCH_CASES = [c for c in CONV_CASES if c[10] == 1]  # F.conv2d has no lhs dilation
UPSAMPLES = {"nearest_x2": (8, "nearest", 2), "bilinear_x2": (8, "bilinear", 2),
             "bilinear_x16": (4, "bilinear", 16)}  # global rows, mode, factor
MEANS = ("mean_hw", "mean_rows")  # x.mean((2, 3)), torch.mean(x, -2, keepdim=True)


# --------------------------------------------------------------------------
# shared by the ranks and the parent (no JAX)
# --------------------------------------------------------------------------

def _conv_inputs(case):
    name, H, W, cin, cout, kh, sh, pt, pb, dh, L, S = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy(rng.standard_normal((2, cin, H, W)))
    k = torch.from_numpy(rng.standard_normal((cout, cin, kh, kh)) * 0.1)
    b = torch.from_numpy(rng.standard_normal(cout))
    return x, k, b


def _conv_run(case, x, k, b):
    """Forward and gradients of sum(sin(conv)) (on a strip inside the mode)."""
    import torch.nn.functional as F

    name, H, W, cin, cout, kh, sh, pt, pb, dh, L, S = case
    x, k, b = (t.clone().requires_grad_(True) for t in (x, k, b))
    y = F.conv2d(x, k, b, sh, pt, dh)
    torch.sin(y).sum().backward()
    return {"y": y.detach(), "gx": x.grad, "gk": k.grad, "gb": b.grad}


def _pool_input():
    return torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4, 16, 16))) - 5.0


def _upsample_input(rows):
    return torch.from_numpy(np.random.default_rng(rows).standard_normal((2, 3, rows, 5)))


def _grad_run(fn, x):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    torch.sin(y).sum().backward()
    return {"y": y.detach(), "gx": x.grad}


def _mean_op(name):
    if name == "mean_hw":
        return lambda x: x.mean((2, 3))
    return lambda x: torch.mean(x, -2, keepdim=True)


def _se_run(x):
    """Forward and gradients of sum(sin(ChannelSELayer(x))), seeded float64
    weights (on a strip inside the mode)."""
    from stcd_tpu_torch.layers.se import ChannelSELayer

    torch.manual_seed(3)
    se = ChannelSELayer(x.shape[1], 1).double()
    x = x.clone().requires_grad_(True)
    y = se(x)
    torch.sin(y).sum().backward()
    return {"y": y.detach(), "gx": x.grad, **{k: p.grad for k, p in se.named_parameters()}}


def _upsample(mode, factor):
    from stcd_tpu_torch.layers.modules import resize_bilinear, upsample_nearest

    if mode == "nearest":
        return lambda x: upsample_nearest(x, factor)
    return lambda x: resize_bilinear(x, (x.shape[2] * factor, x.shape[3] * factor))


def _local(x, data_index, data_size):
    """A data shard's rows of a global batch (or of nested draws)."""
    if data_index is None:
        return x
    if isinstance(x, dict):
        return {k: _local(v, data_index, data_size) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_local(v, data_index, data_size) for v in x)
    return x[data_index::data_size]


def _state(stage, sd):
    from stcd_tpu_torch.models.segcd import SegCD, UnetSeg
    from stcd_tpu_torch.train.schedules import poly_schedule
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state

    model = (UnetSeg if stage == 1 else SegCD)("resnet18", decoder_channels=DEC, classes=1)
    model.load_state_dict(sd, strict=True)
    return create_train_state(model, SGDConfig(poly_schedule(*SCHEDULE), momentum=0.9,
                                               weight_decay=0.0), device="cpu")


def run_case(inputs, name, mesh=None):
    """Case ``name``'s 3 train steps on the global batches (mesh None: one
    process) or on this rank's data shard of them through the spatial steps,
    then the eval step on the first batch. Returns the loss terms and counts of
    each step, the state_dict after the last, and the eval's counts and
    probabilities."""
    from stcd_tpu_torch.parallel import spatial
    from stcd_tpu_torch.train import steps

    stage, _, accum, augment, data = CASES[name]
    state = _state(stage, inputs[f"sd{1 if stage == 1 else 2}"])
    if mesh is None:
        make = {1: steps.make_seg_steps, 2: steps.make_cd_steps, 3: steps.make_semi_cd_steps}
        train_step, eval_step = make[stage](augment=augment, accum_steps=accum)
        shard = (None, None)
    else:
        make = {1: spatial.make_spatial_seg_steps, 2: spatial.make_spatial_cd_steps,
                3: spatial.make_spatial_semi_cd_steps}
        train_step, eval_step = make[stage](None, mesh, augment=augment, accum_steps=accum)
        shard = (mesh.rank // mesh.space, mesh.data)
    terms, counts = [], []
    batches = inputs[f"batches{stage}_{CASES[name][1]}"]
    for batch, draws in zip(batches, inputs[f"draws{stage}_{CASES[name][1]}"]):
        out = train_step(state, _local(batch, *shard), aug_params=draws if augment else None)
        terms.append({k: v.item() for k, v in out.items() if k != "cm"})
        counts.append(out["cm"].tolist())
    assert state.step == STEPS
    first = _local(batches[0], *shard)
    if stage == 1:
        ev = eval_step(state, first)
    else:
        ev = eval_step(state, {"A": first["A"], "B": first["B"],
                               "label": first["label" if stage == 2 else "c_label"]})
    return {"terms": terms, "counts": counts, "eval_cm": ev["cm"].tolist(),
            "eval_probs": ev["probs"], "stats0": None,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def run_cli(name, data, save, extra=()):
    """Stage CLI ``name`` for one epoch on the demo tree; its state_dict and
    the train losses that this rank logged."""
    import importlib
    import json

    from stcd_tpu_torch.parallel import distributed

    cli = importlib.import_module(f"stcd_tpu_torch.cli.{name}")
    got = cli.main(["--root_path", data, *CLIS[name], *CLI_FLAGS, "--save_name", save,
                    *extra])
    rank = distributed.rank()
    log = os.path.join(save, "logs", "scalars.jsonl" if rank == 0 else f"scalars.p{rank}.jsonl")
    with open(log) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    return {"step": got["state"].step, "losses": losses,
            "state": {k: v.clone() for k, v in got["state"].model.state_dict().items()}}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _ops(world):
    """Every op of section 2 whose space axis is ``world``, on this rank's strip."""
    import torch.nn.functional as F
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.spatial import active_space_size, spatial_context

    s, out = distributed.space_rank(), {}

    def strip(x):
        hl = x.shape[2] // world
        return x[:, :, s * hl:(s + 1) * hl]

    for case in TORCH_CASES:
        if case[11] != world:
            continue
        x, k, b = _conv_inputs(case)
        with spatial_context(world):
            out[case[0]] = _conv_run(case, strip(x), k, b)
    with spatial_context(world):
        out["max_pool"] = _grad_run(lambda t: F.max_pool2d(t, 3, 2, 1), strip(_pool_input()))
        for name, (rows, mode, factor) in UPSAMPLES.items():
            out[name] = _grad_run(_upsample(mode, factor), strip(_upsample_input(rows)))
        for name in MEANS:
            out[name] = _grad_run(_mean_op(name), strip(_upsample_input(8)))
        out["channel_se"] = _se_run(strip(_upsample_input(8)))

    refusals = {}
    for what, fn in (
            ("divide", lambda t: F.conv2d(t, torch.zeros(4, 4, 3, 3), None, 2, 1)),
            ("conv_transpose", lambda t: F.conv_transpose2d(t, torch.zeros(4, 4, 2, 2))),
            ("adaptive_pool", lambda t: F.adaptive_avg_pool2d(t, 1)),
            ("avg_pool", lambda t: F.avg_pool2d(t, 2))):
        try:
            with spatial_context(world):
                fn(torch.zeros(1, 4, 6 // world if what == "divide" else 4, 6))
            refusals[what] = None
        except (ValueError, NotImplementedError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals
    with spatial_context(world):
        with spatial_context(world):  # the same context
            nested = tuple(F.max_pool2d(torch.zeros(1, 1, 4, 4), 3, 1, 1).shape)
        try:
            with spatial_context(world * 2):
                pass
            other = None
        except RuntimeError as e:
            other = str(e)
    out["nesting"] = {"nested": nested, "other": other,
                      "after": (active_space_size(),
                                len(torch.overrides._get_current_function_mode_stack()))}
    return out


def _cli_refusals(tmp):
    refusals = {}
    for flags in (["--space_axis", "3"], ["--space_axis", "2", "--encoder", "se_resnet50"],
                  ["--space_axis", "2", "--remat"],
                  ["--space_axis", "2", "--model_axis", "2"]):
        try:
            run_cli("train_pse_cd", os.path.join(tmp, "demo"), os.path.join(tmp, "refused"),
                    flags)
            refusals[" ".join(flags)] = None
        except (ValueError, NotImplementedError) as e:
            refusals[" ".join(flags)] = f"{type(e).__name__}: {e}"
    return refusals


def _worker(job: str, rank: int, tmp: str) -> int:
    """Rank ``rank`` of ``job`` (JOBS): writes what it computed to
    ``{job}_rank{rank}.pt``."""
    # tensorboard imports TensorFlow where it is installed, and TensorFlow may import
    # JAX: the ranks keep both out (tensorboard then uses its own stub)
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    data, world = os.path.join(tmp, "demo"), JOBS[job]
    if job == "cli_one":
        out = {"cli": {name: run_cli(name, data, os.path.join(tmp, f"one_{name}"))
                       for name in CLIS}}
        torch.save(out, os.path.join(tmp, f"{job}_rank0.pt"))
        return 0
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh

    distributed.initialize("cpu", init_method="file://" + os.path.join(tmp, f"rdv_{job}"),
                           world_size=world, rank=rank)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    mesh = create_mesh(space=world)
    out = {}
    if job == "space2":
        out["ops"] = _ops(world)
        for name, case in CASES.items():
            if case[4] == 1:
                out[name] = run_case(inputs, name, mesh)
    elif job == "cli_space2":
        out["cli"] = {name: run_cli(name, data, os.path.join(tmp, f"sp_{name}"),
                                    ["--space_axis", "2"]) for name in CLIS}
        out["cli_refusals"] = _cli_refusals(tmp)
    else:
        out["ops"] = _ops(world)
        out["stage2_data2"] = run_case(inputs, "stage2_data2", create_mesh(data=2, space=2))
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "stcd_tpu"))
    torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
    distributed.barrier("done")
    return 0


# --------------------------------------------------------------------------
# the parent: references, spawn, checks
# --------------------------------------------------------------------------

def _jax_variables(model, args, seed):
    """Seeded float32 variables of a JAX model (tests/test_torch_parallel.py)."""
    import jax

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches(stage, n, seed):
    rng = np.random.default_rng(seed)

    def images():
        return torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))

    def label():
        return torch.from_numpy((rng.uniform(size=(n, HW, HW, 1)) > 0.8).astype(np.float32))

    out = []
    for _ in range(STEPS):
        if stage == 1:
            out.append({"image": images(), "label": label()})
        elif stage == 2:
            out.append({"A": images(), "B": images(), "label": label()})
        else:
            out.append({"A": images(), "B": images(), "s_label_A": label(), "c_label": label(),
                        "CA": images(), "CB": images(), "CL": label()})
    return out


def _draws(stage, n, seed):
    from stcd_tpu_torch.data.augment import sample_augment_params, sample_pair_params

    g = torch.Generator().manual_seed(seed)
    if stage == 1:
        return sample_augment_params(g, n, 0.5)
    if stage == 2:
        return sample_pair_params(g, n, 0.5)
    return (sample_pair_params(g, n, 0.5), sample_pair_params(g, n, 0.8))


def _jax_run(model, variables, inputs):
    """JAX's make_spatial_cd_steps (augment off, SGD) on a (data 1, space 2)
    mesh over the stage-2 global batches."""
    import jax
    import optax
    from jax.sharding import Mesh
    from stcd_tpu.parallel.spatial import make_spatial_cd_steps
    from stcd_tpu.train.schedules import poly_schedule
    from stcd_tpu.train.state import TrainState

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "space"))
    state = TrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=optax.sgd(poly_schedule(*SCHEDULE), momentum=0.9))
    train_step, _ = make_spatial_cd_steps(model, mesh, augment=False)
    terms, counts, stats = [], [], None
    for i, batch in enumerate(inputs[f"batches2_{CASES['stage2_noaug'][1]}"]):
        state, out = train_step(state, {k: v.numpy() for k, v in batch.items()},
                                jax.random.PRNGKey(i))
        terms.append({k: float(v) for k, v in out.items() if k != "cm"})
        counts.append(np.asarray(out["cm"]))
        if i == 0:
            stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return {"terms": terms, "counts": counts, "stats0": stats,
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Prepare the inputs, spawn the 2 and the 4 ranks and the CLIs' one
    process, compute the steps' one-process and JAX references while they
    run."""
    import jax.numpy as jnp
    from stcd_tpu.models.segcd import SegCD as JaxSegCD
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
    from stcd_tpu_torch.models.segcd import UnetSeg, init_weights

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("spatial"))
    z = jnp.zeros((1, HW, HW, 3))
    jax_model = JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    variables = _jax_variables(jax_model, (z, z), 2)
    inputs = {"sd1": init_weights(UnetSeg("resnet18", decoder_channels=DEC, classes=1),
                                  seed=1).state_dict(),
              "sd2": unetseg_from_flax(variables["params"], variables["batch_stats"],
                                       encoder_name="resnet18")}
    for stage, n in {(c[0], c[1]) for c in CASES.values()}:
        inputs[f"batches{stage}_{n}"] = _batches(stage, n, seed=10 * stage + n)
        inputs[f"draws{stage}_{n}"] = [_draws(stage, n, 100 * stage + 10 * n + i)
                                       for i in range(STEPS)]
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    data = os.path.join(tmp, "demo")
    make_demo_data.make_tree(data, n=2 * CLI_STEPS, size=HW)
    shutil.copytree(os.path.join(data, "LEVIR", "train", "pseudo_label_WHU"),
                    os.path.join(data, "LEVIR", "train", "ff_label"))

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [(job, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", job, str(r), tmp],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for job, world in JOBS.items() for r in range(world)]
    try:
        one = {name: run_case(inputs, name) for name in CASES}
        jax_out = _jax_run(jax_model, variables, inputs)
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    for (job, p), log in zip(procs, logs):
        assert p.returncode == 0, f"a rank of {job}:\n{log[-4000:]}"
    got = {job: [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"), weights_only=True)
                 for r in range(world)] for job, world in JOBS.items()}
    # by the size of the space axis, each rank's outputs of every job
    ranks = {2: [{**a, **b} for a, b in zip(got["space2"], got["cli_space2"])],
             4: got["space4"]}
    cli_one = got["cli_one"][0]["cli"]
    yield {"inputs": inputs, "ranks": ranks, "one": one, "cli_one": cli_one, "jax": jax_out,
           "variables": variables}
    torch.set_num_threads(threads)


# --- 1. halo_geometry ---

@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_halo_geometry_equals_jax(case):
    from stcd_tpu.parallel import spatial as jspatial
    from stcd_tpu_torch.parallel.spatial import halo_geometry

    name, H, W, cin, cout, kh, sh, pt, pb, dh, L, S = case
    with jspatial.spatial_context(S):
        want = jspatial.halo_geometry(H, kh, sh, pt, pb, dh, L)
    assert halo_geometry(H, kh, sh, pt, pb, dh, L, size=S) == want


@pytest.mark.parametrize("geometry", [(6, 3, 2, 1, 1, 1, 1, 2), (4, 3, 1, 1, 0, 1, 2, 2)],
                         ids=["height", "lhs_dilation"])
def test_halo_geometry_errors_equal_jax(geometry):
    """tests/test_spatial_shardmap.py:270-287 (a stage height that stops
    dividing) and the lhs-dilation error: the same ValueError, word for word."""
    from stcd_tpu.parallel import spatial as jspatial
    from stcd_tpu_torch.parallel.spatial import halo_geometry

    *args, S = geometry
    with jspatial.spatial_context(S), pytest.raises(ValueError) as want:
        jspatial.halo_geometry(*args)
    with pytest.raises(ValueError) as got:
        halo_geometry(*args, size=S)
    assert str(got.value) == str(want.value)
    assert "divide" in str(got.value) or "dilated taps" in str(got.value)


# --- 2. ops on strips ---

def _strips_equal(ranks, key, want, what):
    S = len(ranks)
    for s, rank in enumerate(ranks):
        got = rank["ops"][key][what]
        h = want.shape[2] // S
        atol = OP_TOL * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want[:, :, s * h:(s + 1) * h], atol=atol, rtol=0,
                                   msg=f"{key} {what} of strip {s}")


@pytest.mark.parametrize("case", TORCH_CASES, ids=[c[0] for c in TORCH_CASES])
def test_halo_conv_equals_global_conv(run, case):
    ranks = run["ranks"][case[11]]
    want = _conv_run(case, *_conv_inputs(case))
    key = case[0]
    for what in ("y", "gx"):
        _strips_equal(ranks, key, want[what], what)
    for what in ("gk", "gb"):
        got = sum(r["ops"][key][what] for r in ranks)
        atol = OP_TOL * max(1.0, want[what].abs().max().item())
        torch.testing.assert_close(got, want[what], atol=atol, rtol=0,
                                   msg=f"{key} {what}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["max_pool", *UPSAMPLES, *MEANS, "channel_se"])
def test_halo_pool_upsample_and_mean_equal_global(run, op, world):
    if op == "max_pool":
        want = _grad_run(lambda t: torch.nn.functional.max_pool2d(t, 3, 2, 1), _pool_input())
    elif op in MEANS:
        want = _grad_run(_mean_op(op), _upsample_input(8))
    elif op == "channel_se":
        want = _se_run(_upsample_input(8))
    else:
        rows, mode, factor = UPSAMPLES[op]
        want = _grad_run(_upsample(mode, factor), _upsample_input(rows))
    ranks = run["ranks"][world]
    if op in MEANS:
        # every rank holds the whole image's mean, and its own copy of the loss on it:
        # the strips' gradients sum the S copies (the steps' mean over the ranks
        # divides that back)
        for rank in ranks:
            torch.testing.assert_close(rank["ops"][op]["y"], want["y"], atol=OP_TOL, rtol=0)
        _strips_equal(ranks, op, want["gx"] * world, "gx")
        return
    for what in ("y", "gx"):
        _strips_equal(ranks, op, want[what], what)
    # the squeeze's parameters: each strip's share of the gradient, summed over the ranks
    for what in (k for k in want if k not in ("y", "gx")):
        got = sum(r["ops"][op][what] for r in ranks)
        atol = OP_TOL * max(1.0, want[what].abs().max().item())
        torch.testing.assert_close(got, want[what], atol=atol, rtol=0, msg=f"{op} {what}")


@pytest.mark.parametrize("backend,p2p", [("nccl", True), ("gloo", False), ("mpi", None)])
def test_exchange_follows_the_backend(monkeypatch, backend, p2p):
    """batch_isend_irecv under NCCL, the all_gather under gloo, another backend
    refused; the neighbours are the group's ranks above and below."""
    import torch.distributed as dist
    from stcd_tpu_torch.parallel import spatial

    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_global_rank", lambda group, r: 10 + r)
    if p2p is None:
        with pytest.raises(NotImplementedError, match="mpi"):
            spatial._Exchange(3, None)
        return
    ex = spatial._Exchange(3, None)
    assert (ex.p2p, ex.index, ex.above, ex.below) == (p2p, 1, 10, 12)


@pytest.mark.parametrize("device,local_world,want", [
    ("cpu", "2", "gloo"), ("cuda", "2", "nccl"), ("cuda:0", "2", "gloo"), ("cuda:0", "1", "nccl")],
    ids=["cpu", "card_a_rank", "one_card_two_ranks", "one_card_one_rank"])
def test_initialize_backend_follows_the_card_sharing(monkeypatch, device, local_world, want):
    """NCCL a card, gloo on the CPU and where the ranks of a host share the
    card that --device names (NCCL refuses two ranks on one device)."""
    import torch.distributed as dist
    from stcd_tpu_torch.parallel import distributed

    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    monkeypatch.setenv("LOCAL_RANK", "1")
    got = distributed.initialize(device, init_method="file:///unused", world_size=2, rank=1)
    assert seen["backend"] == want
    assert str(got) == {"cpu": "cpu", "cuda": "cuda:1"}.get(device, "cuda:0")


@pytest.mark.parametrize("world", [2, 4])
def test_mode_refusals_and_nesting(run, world):
    for rank in run["ranks"][world]:
        ref = rank["ops"]["refusals"]
        assert ref["divide"].startswith("ValueError") and "does not divide" in ref["divide"]
        assert ref["conv_transpose"].startswith("NotImplementedError")
        assert "conv_transpose2d" in ref["conv_transpose"]
        assert ref["adaptive_pool"].startswith("ValueError")
        assert "adaptive_avg_pool2d" in ref["adaptive_pool"]
        assert ref["avg_pool"].startswith("ValueError") and "avg_pool2d" in ref["avg_pool"]
        nest = rank["ops"]["nesting"]
        assert nest["nested"] == (1, 1, 4, 4)  # the strip's rows, through the halo
        assert nest["other"] is not None and "inside" in nest["other"]
        assert nest["after"] == (0, 0)
        assert rank["jax_imported"] == []


# --- 3. the spatial steps against one process ---

def _hold_counts(got, want, pixels=2):
    """Confusion counts of one step: the label's counts equal, the predicted
    ones but for ``pixels`` whose probability sits within float32 noise of the
    0.5 threshold (a flipped pixel moves two cells by one)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(1), want.sum(1))
    assert np.abs(got - want).sum() <= 2 * pixels, (got, want)


def _ranks_of(run, name):
    return run["ranks"][4] if CASES[name][4] == 2 else run["ranks"][2]


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_steps_equal_one_process(run, name):
    one = run["one"][name]
    ranks = _ranks_of(run, name)
    for rank in ranks:
        got = rank[name]
        for step, (g, w) in enumerate(zip(got["terms"], one["terms"])):
            assert g.keys() == w.keys()
            for term in w:
                np.testing.assert_allclose(g[term], w[term], rtol=LOSS_RTOL,
                                           err_msg=f"{term} of step {step}")
        for g, w in zip(got["counts"], one["counts"]):
            _hold_counts(g, w)
        for k, w in one["state"].items():
            atol = STATE_SHARE * max(1.0, w.abs().max().item())
            torch.testing.assert_close(got["state"][k], w, atol=atol, rtol=0, msg=k)
    # every rank ends with the same state
    for k, w in ranks[0][name]["state"].items():
        assert all(torch.equal(r[name]["state"][k], w) for r in ranks[1:]), k
    # eval: the whole images' probabilities on every rank of a space group (a data
    # shard's rows), the counts of the strips summed over the ranks
    data = CASES[name][4]
    for r, rank in enumerate(ranks):
        want = one["eval_probs"][r // (len(ranks) // data)::data]
        torch.testing.assert_close(rank[name]["eval_probs"], want, atol=EVAL_ATOL, rtol=0)
    _hold_counts(np.sum([r[name]["eval_cm"] for r in ranks], 0), one["eval_cm"])


def test_spatial_stage2_equals_jax_spatial_steps(run):
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax

    want = run["jax"]
    start = run["inputs"]["sd2"]
    after = unetseg_from_flax(want["params"], want["batch_stats"], encoder_name="resnet18")
    got = run["ranks"][2][0]["stage2_noaug"]
    for step, (g, w) in enumerate(zip(got["terms"], want["terms"])):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5, rtol=0,
                                   err_msg=f"loss of step {step}")
    for g, w in zip(got["counts"], want["counts"]):
        _hold_counts(g, w)
    for k, w in after.items():
        if "num_batches" in k:
            continue
        move = (w.double() - start[k].double()).abs().max().item()
        err = (got["state"][k].double() - w.double()).abs().max().item()
        ulps = 1e-6 * max(1.0, w.abs().max().item())
        assert err <= (PORT_SHARE + JAX_SHARE) * move + ulps, (k, err, move)


# --- 5. the CLIs ---

@pytest.mark.parametrize("name", list(CLIS))
def test_cli_space_axis_trains_what_one_process_trains(run, name):
    want = run["cli_one"][name]
    assert want["step"] == CLI_STEPS
    for rank in run["ranks"][2]:
        got = rank["cli"][name]
        assert got["step"] == want["step"]
        # the step's loss, of the whole images on every rank: the forward
        assert len(want["losses"]) == CLI_STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        agree = total = 0
        for k, w in want["state"].items():
            atol = CLI_ATOL + 1e-6 * max(1.0, w.abs().max().item())
            torch.testing.assert_close(got["state"][k], w, atol=atol, rtol=0, msg=k)
            if w.is_floating_point():
                agree += ((got["state"][k] - w).abs() <= 1e-5).sum().item()
                total += w.numel()
        assert agree >= CLI_AGREE * total, agree / total
    r0, r1 = (r["cli"][name]["state"] for r in run["ranks"][2])
    assert all(torch.equal(r1[k], v) for k, v in r0.items())


def test_cli_space_axis_refusals(run):
    for rank in run["ranks"][2]:
        ref = rank["cli_refusals"]
        assert ref["--space_axis 3"].startswith("ValueError")
        assert "torchrun --nproc_per_node" in ref["--space_axis 3"]
        assert ref["--space_axis 2 --encoder se_resnet50"].startswith("ValueError")
        assert "#11" in ref["--space_axis 2 --encoder se_resnet50"]
        assert ref["--space_axis 2 --remat"].startswith("ValueError")
        # space x model runs on a multiple of 4 ranks (tests/test_torch_space_model.py)
        assert ref["--space_axis 2 --model_axis 2"].startswith("ValueError")
        assert "torchrun --nproc_per_node 4" in ref["--space_axis 2 --model_axis 2"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
