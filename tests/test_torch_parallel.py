"""Data-parallel training of stcd_tpu_torch (parallel/) against one process
and against the JAX package.

The ranks are two processes that run this file as a script (``--worker``)
over gloo with a ``file://`` rendezvous under the test's tmp_path, one
torch thread each, and import no JAX. One spawn of the two ranks runs every
multi-process check (``_worker``) while the parent prepares the
one-process and JAX references; the tests then read what each rank wrote.

1. The loader's split: the port's per-process indices equal
   stcd_tpu.data.loader.DataLoader's for 2 and 3 processes, with and without
   shuffle and drop_last, over two epochs.
2. Placement invariance: each stage's train step (1: UnetSeg, 2: SegCD,
   3: SegCD on synthesized and real pairs) on two ranks, each holding rows
   ``r::2`` of the global batch, equals the one-process step on the global
   batch (resnet18, decoder (32, 24, 16, 12, 8), 32x32, augmentation on with
   injected draws, 3 SGD steps), with accum_steps 1 and 2: every loss term of
   every step within LOSS_RTOL, the counts but for a pixel at the threshold
   (float32 sums in another order move a probability by ~1e-7), and the
   parameters and the
   BatchNorm running statistics after the 3 steps within STATE_SHARE of each
   tensor's largest magnitude. With
   accum_steps 1 both equal the JAX step on that global batch (the draws are
   JAX's own, from its key structure) at tests/test_torch_train_steps.py's
   tolerances: the loss terms within 1e-5 at each step, the counts but for a
   pixel at the threshold, the first step's running statistics within 2e-4,
   and the parameters after 3 steps within the sum of that file's two shares
   of JAX's move (PORT_SHARE + JAX_SHARE) plus float32 ulps.
3. BatchNorm alone, over a partial batch of 5 rows (3 on rank 0, 2 on rank
   1): output, input gradient, parameter gradients and running statistics
   equal one process's within float32 rounding; assemble_global_batch gives
   back the global batch; the model's Dropout and DropPath masks, drawn for
   the global batch, are the one-process masks' rows.
4. Checkpoints: only rank 0 writes, both ranks restore the same bytes, no
   ``.tmp`` is left; place_train_state makes rank 1's state rank 0's.
5. Preemption: the flag raised on rank 0 only stops both ranks at the same
   iteration with one resume point (tests/test_multiprocess.py:149-164).
6. Logs: ``scalars.jsonl`` on rank 0, ``scalars.p1.jsonl`` on rank 1, the
   TensorBoard writer on rank 0 only.
7. The CLI surface: cli.train_pse_cd with --data_axis 2 trains the same state
   on both ranks; --data_axis 3, --model_axis 3 and a --batch_size that 2
   does not divide raise (the space axis: tests/test_torch_spatial.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DEC = (32, 24, 16, 12, 8)
HW = 32
STEPS = 3
SCHEDULE = (1e-3, 2, 4)
# (stage, global batch: images for stage 1, pairs for stage 2, pairs a half for stage 3)
CASES = {f"stage{stage}_accum{accum}": (stage, n, accum)
         for stage, n in ((1, 8), (2, 4), (3, 4)) for accum in (1, 2)}
# Two ranks against one process: the same arithmetic but for the order of float32 sums
# (the BatchNorm moments of two halves, the flat gradient mean). Measured on a CPU host:
# loss terms within 1.1e-6 relative (stage 3), parameters and running statistics within
# 1.6e-6 of the tensor's largest magnitude (a running variance of 3.7 off by 12 ulps).
LOSS_RTOL = 1e-5
STATE_SHARE = 5e-6
PORT_SHARE, JAX_SHARE = 4e-2, 1e-2  # tests/test_torch_train_steps.py, against float64
WORKER_TIMEOUT = 300


# --------------------------------------------------------------------------
# shared by the ranks and the parent (no JAX)
# --------------------------------------------------------------------------

def _local(x, rank):
    """A rank's rows of a global batch (or of nested draws)."""
    if rank is None:
        return x
    if isinstance(x, dict):
        return {k: _local(v, rank) for k, v in x.items()}
    return x[rank::WORLD]


def _state(stage, sd):
    from stcd_tpu_torch.models.segcd import SegCD, UnetSeg
    from stcd_tpu_torch.train.schedules import poly_schedule
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state

    model = (UnetSeg if stage == 1 else SegCD)("resnet18", decoder_channels=DEC, classes=1)
    model.load_state_dict(sd, strict=True)
    return create_train_state(model, SGDConfig(poly_schedule(*SCHEDULE), momentum=0.9,
                                               weight_decay=0.0), device="cpu")


def run_case(inputs, name, rank=None):
    """Stage ``name``'s 3 train steps on the global batches (rank None) or on a
    rank's rows of them, with the global draws. Returns the loss terms and
    counts of each step and the state_dict after the last."""
    from stcd_tpu_torch.train import steps

    stage, _, accum = CASES[name]
    make = {1: steps.make_seg_steps, 2: steps.make_cd_steps, 3: steps.make_semi_cd_steps}
    state = _state(stage, inputs[f"sd{1 if stage == 1 else 2}"])
    train_step, _ = make[stage](augment=True, accum_steps=accum)
    terms, counts, stats0 = [], [], None
    for batch, draws in zip(inputs[f"batches{stage}"], inputs[f"draws{stage}"]):
        out = train_step(state, _local(batch, rank), aug_params=draws)
        terms.append({k: v.item() for k, v in out.items() if k != "cm"})
        counts.append(out["cm"].tolist())
        if stats0 is None:
            stats0 = {k: v.clone() for k, v in state.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}
    assert state.step == STEPS
    return {"terms": terms, "counts": counts, "stats0": stats0,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _bn_and_draws(rank, out):
    """BatchNorm over a partial global batch of 5, the global batch back from
    its rows, and the model's masks of the global batch."""
    from stcd_tpu_torch.layers.norm import BatchNorm
    from stcd_tpu_torch.layers.stochastic import Dropout, DropPath, RowMap, set_generator
    from stcd_tpu_torch.parallel import distributed

    g = torch.Generator().manual_seed(5)
    x = torch.randn(5, 6, 3, 3, generator=g)
    grad_out = torch.randn(5, 6, 3, 3, generator=g)
    bn = BatchNorm(6).train()
    xl = x[rank::WORLD].clone().requires_grad_(True)
    y = bn(xl)
    (y * grad_out[rank::WORLD]).sum().backward()
    out["bn"] = {"count": xl.shape[0], "y": y.detach(), "x_grad": xl.grad,
                 "w_grad": bn.weight.grad, "b_grad": bn.bias.grad,
                 "running_mean": bn.running_mean, "running_var": bn.running_var}
    batch = {"x": x[rank::WORLD], "flag": (x[rank::WORLD, 0, 0, 0] > 0), "name": ["n"]}
    assembled = distributed.assemble_global_batch(batch)
    out["assembled"] = (torch.equal(assembled["x"], x)
                        and torch.equal(assembled["flag"], x[:, 0, 0, 0] > 0)
                        and assembled["name"] == ["n"])

    # two blocks of 3 local rows (SegCD folds A and B), 6 global rows a block
    layers = torch.nn.Sequential(Dropout(0.5), DropPath(0.3)).train()
    rows = RowMap(3, 3 * WORLD, torch.arange(rank, 3 * WORLD, WORLD))
    set_generator(layers, torch.Generator().manual_seed(9), rows)
    out["masks"] = layers(torch.ones(6, 4, 5))


def _checkpoints(rank, tmp, out):
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh, place_train_state
    from stcd_tpu_torch.train import checkpoint
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state

    torch.manual_seed(100 + rank)  # rank 1 starts from other weights
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    state = create_train_state(model, SGDConfig(lambda step: 0.1), device="cpu")
    model(torch.randn(2, 3, 5, 5)).sum().backward()
    state.apply_gradients()  # optimizer state (momentum) to place too
    place_train_state(create_mesh(), state)
    out["placed"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["placed_momentum"] = [s["momentum_buffer"].clone()
                              for s in state.optimizer.state.values()]

    writes = []
    save = checkpoint._save_atomic
    checkpoint._save_atomic = lambda payload, path: writes.append(os.path.basename(path)) \
        or save(payload, path)
    try:
        directory = os.path.join(tmp, "ckpt")
        mgr = checkpoint.CheckpointManager(directory)
        mgr.save_last(state, 3, 0.5, 2)
        mgr.save_best(state, 0.25)
        mgr.save_best(state, 0.5)
        mgr.save_snapshot(state, 3)
    finally:
        checkpoint._save_atomic = save
    out["writes"] = writes
    with open(os.path.join(directory, "last_ckpt"), "rb") as f:
        out["last_ckpt_bytes"] = f.read()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    restored = mgr.restore_last(state)
    out["restored"] = {"epoch": restored[1], "best": restored[2], "best_epoch": restored[3],
                       "state": {k: v.clone() for k, v in model.state_dict().items()}}
    distributed.barrier("listing")
    out["files"] = sorted(os.listdir(directory))


def _preemption_and_logs(rank, tmp, out):
    """run_training over a step that only counts, the flag raised on rank 0
    while train batch 1 is yielded; then the scalar logs."""
    from stcd_tpu_torch.train.loops import run_training
    from stcd_tpu_torch.train.preemption import PreemptionGuard
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    from stcd_tpu_torch.utils.logging import ScalarLogger

    model = torch.nn.Conv2d(1, 1, 1)
    state = create_train_state(model, SGDConfig(lambda step: 0.0), device="cpu")
    guard = PreemptionGuard(install=False, sync_every=2)
    calls = []

    def train_step(state, batch, rng):
        calls.append(int(batch["x"][0]))
        state.step += 1
        return {"loss": torch.zeros(()), "cm": torch.zeros(2, 2, dtype=torch.int64)}

    def loader():
        for i in range(4):
            if i == 1 and rank == 0:
                guard.trigger()
            yield {"x": np.array([i])}

    class Loader:
        def __iter__(self):
            return loader()

    save_dir = os.path.join(tmp, "preempt")
    run_training(train_step, lambda s, b: {"cm": torch.zeros(2, 2, dtype=torch.int64)},
                 state, Loader(), [], n_epochs=2, save_dir=save_dir, rng=None,
                 preemption=guard)
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    restored = CheckpointManager(save_dir).restore_last(state)
    out["preempt"] = {"fired": guard.fired, "steps": calls, "ckpt_epoch": restored[1],
                      "ckpt_step": state.step}

    logdir = os.path.join(tmp, "logs")
    logger = ScalarLogger(logdir)
    logger.add_scalar("train/loss", 0.5 + rank, 1)
    logger.close()
    out["log"] = {"path": os.path.basename(logger.path), "tensorboard": logger._tb is not None}


def _cli(rank, tmp, out):
    from stcd_tpu_torch.cli import train_pse_cd

    data = os.path.join(tmp, "demo")
    base = ["--root_path", data, "--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR",
            "--encoder", "resnet18", "--decoder_channels", "16,12,8,8,8", "--img_height", "32",
            "--img_width", "32", "--n_epochs", "1", "--n_cpu", "1", "--device", "cpu",
            "--no_preempt", "--save_name", os.path.join(tmp, "cli_run")]
    got = train_pse_cd.main([*base, "--batch_size", "4", "--data_axis", "2"])
    out["cli"] = {"step": got["state"].step, "history": got["history"],
                  "state": {k: v.clone() for k, v in got["state"].model.state_dict().items()}}
    refusals = {}
    for flags in (["--batch_size", "4", "--data_axis", "3"],
                  ["--batch_size", "4", "--model_axis", "3"],
                  ["--batch_size", "3"]):
        try:
            train_pse_cd.main([*base, *flags])
            refusals[" ".join(flags)] = None
        except (ValueError, NotImplementedError) as e:
            refusals[" ".join(flags)] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals


def _worker(rank: int, tmp: str) -> int:
    # tensorboard imports TensorFlow where it is installed, and TensorFlow may import
    # JAX: the ranks keep both out (tensorboard then uses its own stub)
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    from stcd_tpu_torch.parallel import distributed

    distributed.initialize("cpu", init_method="file://" + os.path.join(tmp, "rendezvous"),
                           world_size=WORLD, rank=rank)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    out = {name: run_case(inputs, name, rank) for name in CASES}
    _bn_and_draws(rank, out)
    _checkpoints(rank, tmp, out)
    _preemption_and_logs(rank, tmp, out)
    _cli(rank, tmp, out)
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "stcd_tpu"))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    distributed.barrier("done")
    return 0


# --------------------------------------------------------------------------
# the parent: references, spawn, checks
# --------------------------------------------------------------------------

def _jax_variables(model, args, seed):
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


def _pair_draws(key, n, jitter_p):
    """jaug._train_augment_pair_impl's draws for n pairs (as in
    tests/test_torch_train_steps.py)."""
    import jax
    from stcd_tpu.data import augment as jaug

    keys = jax.random.split(key, n)
    k_shared = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    coin = jax.vmap(lambda k: jax.random.uniform(k[0]) < jitter_p)(k_shared)
    return tuple({k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in jaug._batched_params(k_shared[:, i], jitter_p, coin).items()}
                 for i in (1, 2))


def _jax_draws(stage, step, n):
    """The draws of the JAX step at key PRNGKey(step) for a global batch of n."""
    import jax
    from stcd_tpu.data import augment as jaug

    aug_key, _ = jax.random.split(jax.random.PRNGKey(step))  # steps.py: aug, dropout
    if stage == 1:
        return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                jaug._batched_params(jax.random.split(aug_key, n), 0.5).items()}
    if stage == 2:
        return _pair_draws(jax.random.split(aug_key, 1)[0], n, 0.5)
    k_syn, k_real = jax.random.split(aug_key, 2)
    return (_pair_draws(k_syn, n, 0.5), _pair_draws(k_real, n, 0.8))


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Prepare the inputs, spawn the two ranks, compute the one-process and
    JAX references while they run; gives the inputs, the ranks' outputs, the
    references and the JAX variables."""
    import jax.numpy as jnp
    from stcd_tpu.models.segcd import SegCD as JaxSegCD
    from stcd_tpu.models.segcd import UnetSeg as JaxUnetSeg
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("parallel"))
    z = jnp.zeros((1, HW, HW, 3))
    models = {1: JaxUnetSeg(encoder_name="resnet18", classes=1, decoder_channels=DEC),
              2: JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)}
    variables = {1: _jax_variables(models[1], (z,), 1), 2: _jax_variables(models[2], (z, z), 2)}
    inputs = {}
    for key, v in variables.items():
        inputs[f"sd{key}"] = unetseg_from_flax(v["params"], v["batch_stats"],
                                               encoder_name="resnet18")
    for stage, n in ((1, 8), (2, 4), (3, 4)):
        inputs[f"batches{stage}"] = _batches(stage, n, seed=stage)
        inputs[f"draws{stage}"] = [_jax_draws(stage, i, n) for i in range(STEPS)]
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    make_demo_data.make_tree(os.path.join(tmp, "demo"), n=4, size=HW)

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                               tmp], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        one = {name: run_case(inputs, name) for name in CASES}
        jax_out = {stage: _jax_run(models[1 if stage == 1 else 2], variables[
            1 if stage == 1 else 2], inputs, stage) for stage in (1, 2, 3)}
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(WORLD)]
    yield {"inputs": inputs, "ranks": ranks, "one": one, "jax": jax_out,
           "variables": variables, "tmp": tmp}
    torch.set_num_threads(threads)


def _jax_run(model, variables, inputs, stage):
    """The JAX step (accum_steps 1, SGD) on the global batches at keys 0, 1, 2,
    which draw what ``inputs`` injects into the port."""
    import jax
    import optax
    from stcd_tpu.train.schedules import poly_schedule
    from stcd_tpu.train.state import TrainState
    from stcd_tpu.train.steps import make_cd_steps, make_seg_steps, make_semi_cd_steps

    make = {1: make_seg_steps, 2: make_cd_steps, 3: make_semi_cd_steps}[stage]
    state = TrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=optax.sgd(poly_schedule(*SCHEDULE), momentum=0.9))
    train_step, _ = make(model, augment=True)
    terms, counts, stats = [], [], None
    for i, batch in enumerate(inputs[f"batches{stage}"]):
        state, out = train_step(state, {k: v.numpy() for k, v in batch.items()},
                                jax.random.PRNGKey(i))
        terms.append({k: float(v) for k, v in out.items() if k != "cm"})
        counts.append(np.asarray(out["cm"]))
        if i == 0:
            stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return {"terms": terms, "counts": counts, "stats0": stats,
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


# --- 1. the loader's split ---

@pytest.mark.parametrize("process_count", [2, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_loader_split_equals_jax(process_count, shuffle, drop_last):
    from stcd_tpu.data.loader import DataLoader as JaxDataLoader
    from stcd_tpu_torch.data.loader import DataLoader

    class Indices:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"i": np.array([i])}

    for r in range(process_count):
        kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last, num_workers=1, seed=3,
                  process_index=r, process_count=process_count)
        want = JaxDataLoader(Indices(), prefetch=0, **kw)
        got = DataLoader(Indices(), device="cpu", **kw)
        assert len(got) == len(want)
        for _ in range(2):
            w = [b["i"].ravel().tolist() for b in want]
            g = [b["i"].ravel().tolist() for b in got]
            assert g == w and len(g) == len(want)


def test_loader_rows_of_the_one_process_batch():
    """Until a rank wraps, rank r's batch b holds rows r::W of the one-process
    loader's batch b at W times the batch."""
    from stcd_tpu_torch.data.loader import DataLoader

    class Indices:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return {"i": np.array([i])}

    one = [b["i"].ravel() for b in DataLoader(Indices(), 8, shuffle=True, drop_last=True,
                                              device="cpu", num_workers=1)]
    for r in range(WORLD):
        mine = [b["i"].ravel() for b in DataLoader(Indices(), 4, shuffle=True, drop_last=True,
                                                   device="cpu", num_workers=1,
                                                   process_index=r, process_count=WORLD)]
        assert [m.tolist() for m in mine] == [o[r::WORLD].tolist() for o in one]


# --- 2. placement invariance and the JAX step ---

def _hold_counts(got, want):
    """Confusion counts of one step: the label's counts equal, the predicted
    ones but for at most 2 pixels whose probability sits within float32 noise
    of the 0.5 threshold (a flipped pixel moves two cells by one), as
    tests/test_torch_train_steps.py holds them."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(1), want.sum(1))
    assert np.abs(got - want).sum() <= 2 * 2, (got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_process(run, name):
    one = run["one"][name]
    for rank in run["ranks"]:
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
    for k, w in run["ranks"][0][name]["state"].items():
        assert torch.equal(run["ranks"][1][name]["state"][k], w), k


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_two_ranks_and_one_process_equal_jax(run, stage):
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax

    want = run["jax"][stage]
    name = f"stage{stage}_accum1"
    start = run["inputs"][f"sd{1 if stage == 1 else 2}"]
    after = unetseg_from_flax(want["params"], want["batch_stats"], encoder_name="resnet18")
    for got in (run["one"][name], run["ranks"][0][name]):
        for step, (g, w) in enumerate(zip(got["terms"], want["terms"])):
            for term in w:
                np.testing.assert_allclose(g[term], w[term], atol=1e-5, rtol=0,
                                           err_msg=f"{term} of step {step}")
        _hold_counts(got["counts"][0], want["counts"][0])
        stats0 = unetseg_from_flax(run["variables"][1 if stage == 1 else 2]["params"],
                                   want["stats0"], encoder_name="resnet18")
        assert len(got["stats0"]) >= 60
        for k, w in got["stats0"].items():
            np.testing.assert_allclose(w.numpy(), stats0[k].numpy(), atol=2e-4, rtol=1e-4,
                                       err_msg=k)
        for k, w in after.items():
            if "running" in k or "num_batches" in k:
                continue
            move = (w.double() - start[k].double()).abs().max().item()
            err = (got["state"][k].double() - w.double()).abs().max().item()
            ulps = 1e-6 * max(1.0, w.abs().max().item())
            assert err <= (PORT_SHARE + JAX_SHARE) * move + ulps, (k, err, move)


def test_steps_refuse_a_micro_batch_the_ranks_do_not_divide(run):
    """accum_steps 3 over a rank's 2 pairs: the message names the ranks."""
    from stcd_tpu_torch.train import steps

    state = _state(2, run["inputs"]["sd2"])
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        steps.make_cd_steps(augment=False, accum_steps=3)[0](
            state, run["inputs"]["batches2"][0])


# --- 3. BatchNorm alone, the assembled batch, the masks ---

def test_batchnorm_moments_and_gradients_are_global(run):
    from stcd_tpu_torch.layers.norm import BatchNorm

    g = torch.Generator().manual_seed(5)
    x = torch.randn(5, 6, 3, 3, generator=g)
    grad_out = torch.randn(5, 6, 3, 3, generator=g)
    bn = BatchNorm(6).train()
    x.requires_grad_(True)
    y = bn(x)
    (y * grad_out).sum().backward()
    bns = [r["bn"] for r in run["ranks"]]
    assert [b["count"] for b in bns] == [3, 2]
    for r, b in enumerate(bns):
        torch.testing.assert_close(b["y"], y.detach()[r::WORLD], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(b["x_grad"], x.grad[r::WORLD], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(b["running_mean"], bn.running_mean, atol=1e-7, rtol=1e-6)
        torch.testing.assert_close(b["running_var"], bn.running_var, atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(bns[0]["w_grad"] + bns[1]["w_grad"], bn.weight.grad,
                               atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(bns[0]["b_grad"] + bns[1]["b_grad"], bn.bias.grad,
                               atol=1e-6, rtol=1e-5)
    assert all(r["assembled"] for r in run["ranks"])


def test_dropout_and_droppath_draw_for_the_global_batch(run):
    from stcd_tpu_torch.layers.stochastic import Dropout, DropPath, set_generator

    layers = torch.nn.Sequential(Dropout(0.5), DropPath(0.3)).train()
    set_generator(layers, torch.Generator().manual_seed(9))
    full = layers(torch.ones(2 * 3 * WORLD, 4, 5))  # two blocks of 6 global rows
    for r, rank in enumerate(run["ranks"]):
        rows = torch.cat([torch.arange(r, 6, WORLD), 6 + torch.arange(r, 6, WORLD)])
        assert torch.equal(rank["masks"], full[rows])
    assert not torch.equal(run["ranks"][0]["masks"], run["ranks"][1]["masks"])


# --- 4. checkpoints and placement ---

def test_checkpoints_written_by_rank_0_and_restored_alike(run):
    r0, r1 = run["ranks"]
    assert r0["writes"] == ["last_ckpt", "25.00_best_model", "50.00_best_model", "3.00_model"]
    assert r1["writes"] == []
    assert r0["files"] == r1["files"] == ["3.00_model", "50.00_best_model", "last_ckpt"]
    assert r0["last_ckpt_bytes"] == r1["last_ckpt_bytes"]
    for r in (r0, r1):
        assert (r["restored"]["epoch"], r["restored"]["best"], r["restored"]["best_epoch"]) \
            == (3, 0.5, 2)
    for k, w in r0["restored"]["state"].items():
        assert torch.equal(r1["restored"]["state"][k], w), k
    # place_train_state: rank 1 started from other weights and holds rank 0's
    for k, w in r0["placed"].items():
        assert torch.equal(r1["placed"][k], w), k
    for a, b in zip(r0["placed_momentum"], r1["placed_momentum"]):
        assert torch.equal(a, b)


# --- 5. preemption, 6. logs ---

def test_preemption_on_rank_0_stops_both_ranks_at_one_iteration(run):
    # the loop asks before each step: call 1 (batch 0) is off the cadence
    # (sync_every 2), so batch 0 trains; call 2 (batch 1, the flag raised on rank 0
    # as it was yielded) agrees on the stop on both ranks, and the resume point says
    # epoch 0 after 1 step
    pre = [r["preempt"] for r in run["ranks"]]
    assert pre[0] == pre[1]
    assert pre[0]["fired"] and pre[0]["steps"] == [0]
    assert pre[0]["ckpt_epoch"] == 0 and pre[0]["ckpt_step"] == 1
    assert os.path.isfile(os.path.join(run["tmp"], "preempt", "last_ckpt"))


def test_logs_per_rank_and_tensorboard_on_rank_0(run):
    r0, r1 = (r["log"] for r in run["ranks"])
    assert r0 == {"path": "scalars.jsonl", "tensorboard": True}
    assert r1 == {"path": "scalars.p1.jsonl", "tensorboard": False}
    logdir = os.path.join(run["tmp"], "logs")
    for name, value in (("scalars.jsonl", 0.5), ("scalars.p1.jsonl", 1.5)):
        with open(os.path.join(logdir, name)) as f:
            assert [json.loads(line)["value"] for line in f] == [value]
    assert sum(f.startswith("events.out.tfevents") for f in os.listdir(logdir)) == 1


# --- 7. the CLI surface ---

def test_cli_data_axis_and_refusals(run):
    r0, r1 = (r["cli"] for r in run["ranks"])
    assert r0["step"] == r1["step"] == 1  # 4 train pairs in global batches of 4
    assert json.dumps(r0["history"]) == json.dumps(r1["history"])  # NaN where nothing is
    for k, w in r0["state"].items():
        assert torch.equal(r1["state"][k], w), k
    for rank in run["ranks"]:
        refusals = rank["refusals"]
        assert refusals["--batch_size 4 --data_axis 3"].startswith("ValueError")
        assert "torchrun --nproc_per_node 3" in refusals["--batch_size 4 --data_axis 3"]
        assert refusals["--batch_size 4 --model_axis 3"].startswith("ValueError")
        assert "torchrun --nproc_per_node 3" in refusals["--batch_size 4 --model_axis 3"]
        assert refusals["--batch_size 3"].startswith("ValueError")
        assert rank["jax_imported"] == []


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(int(sys.argv[2]), sys.argv[3]))
