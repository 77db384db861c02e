"""Spatial partitioning beside tensor parallelism in stcd_tpu_torch: the data x
model x space grid of parallel/mesh.py, the split convs of parallel/tensor.py on
the strips of parallel/spatial.py, the three stage steps and cli.train_pse_cd
on it, against the JAX package and against one process.

The ranks are processes that run this file as a script (``--worker``) over
gloo with a ``file://`` rendezvous under the test's tmp_path, one torch thread
each, and import no JAX: the job ``grid`` runs four ranks at data 1 x model 2 x
space 2 (rank r: model index r // 2, strip r % 2), the job ``one`` one process
for the port's one-process references, while the parent computes JAX's. The
tests then read what each wrote.

The models are SegCD and UnetSeg over resnet18 with the decoder (32, 24, 16, 12,
8) at 64x64 (strips of 32 rows), split with JAX's ``min_size_to_shard`` of
2^12, as tests/test_spatial_shardmap.py::test_dp_tp_sp_2x2x2_direct_grads
splits them, so that at least 10 conv kernels split.

(a) One stage-2 step of the four ranks (``make_spatial_cd_steps``, no
    augmentation, 2 pairs) against JAX's single-placement ``make_cd_steps`` on
    the same weights: the loss within LOSS_RTOL_JAX, and the gradient of every
    parameter within the JAX test's bounds. Both sides step plain SGD at a rate
    of 1, so the gradient is the weights before less the weights after (JAX's
    train step is its ``value_and_grad`` and one optax update).
(b) The same step against ``make_cd_steps`` as
    tests/test_spatial_shardmap.py::test_spatial_cd_steps_match_reference_steps
    holds JAX's composed mesh: the counts within CM_DELTA, the BatchNorm
    statistics after the step within STATS_ATOL, the eval step's
    probabilities from the same (initial) state within EVAL_ATOL_JAX.
(c) Stages 1 and 3 (augmentation on with injected draws, STEPS SGD steps)
    against the port's one process: every loss term, the counts but for pixels
    at the threshold, the state after the steps within STATE_SHARE of each
    tensor's largest magnitude, the eval step's probabilities and counts.
(d) ``grid_ranks`` against the device layout of JAX's ``create_mesh`` (the
    ranks along each axis, the D x S data and shard sets), and each rank's
    helpers and groups in the run.
(e) A checkpoint round trip of the split stage-3 state: the file is the
    one-process layout, and a fresh split state restored from it holds the
    shards and momentum it was saved from.
(f) cli.train_pse_cd --space_axis 2 --model_axis 2 on the four ranks trains
    what one process trains (one Adam step, tests/test_torch_spatial.py's
    bounds).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC = (32, 24, 16, 12, 8)
HW = 64
N = 2  # pairs (images) of a global batch
MODEL, SPACE = 2, 2
MIN_SIZE = 2 ** 12  # tests/test_spatial_shardmap.py:187-189
STEPS = 2
SCHEDULE = (1e-3, 2, 4)
JOBS = {"grid": MODEL * SPACE, "one": 1}
WORKER_TIMEOUT = 300
# (a) and (b): tests/test_spatial_shardmap.py's bounds for JAX's composed mesh against
# its single placement. Measured on a CPU host: the loss 2.7e-7 relative, the largest
# gradient error 0.13 of its bound, equal counts, statistics within 1.5e-6,
# probabilities within 2.4e-7
LOSS_RTOL_JAX = 5e-5
GRAD_ATOL, GRAD_SHARE, GRAD_RTOL = 2e-3, 1e-4, 1e-3  # atol max(2e-3, 1e-4 max |g|)
CM_DELTA = 16
STATS_ATOL = 1e-5
EVAL_ATOL_JAX = 1e-4
# (c): tests/test_torch_spatial.py's bounds for space 2 against one process; the state
# within what space 2 alone measured there (3.2e-6). Measured here on a CPU host: loss
# terms within 1.1e-6 relative, the state within 2.0e-6 (stage 3), eval probabilities
# within 4.1e-6
LOSS_RTOL = 1e-5
STATE_SHARE = 3.2e-6
EVAL_ATOL = 1e-5
# (f): one Adam step (lr 1e-3), as tests/test_torch_spatial.py holds its CLIs
CLI_ATOL = 2 * 1e-3
CLI_AGREE = 0.999
CLI_FLAGS = ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR", "--encoder", "resnet18",
             "--decoder_channels", "16,12,8,8,8", "--img_height", str(HW), "--img_width",
             str(HW), "--n_epochs", "1", "--n_cpu", "1", "--device", "cpu", "--no_preempt",
             "--batch_size", "2"]


# --------------------------------------------------------------------------
# shared by the ranks and the one process (no JAX)
# --------------------------------------------------------------------------

def _state(stage, sd, lr=None):
    """UnetSeg (stage 1) or SegCD loaded with ``sd``, under SGD: the poly
    schedule with momentum 0.9, or a constant ``lr`` without momentum."""
    from stcd_tpu_torch.models.segcd import SegCD, UnetSeg
    from stcd_tpu_torch.train.schedules import poly_schedule
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state

    model = (UnetSeg if stage == 1 else SegCD)("resnet18", decoder_channels=DEC, classes=1)
    model.load_state_dict(sd, strict=True)
    tx = (SGDConfig(poly_schedule(*SCHEDULE), momentum=0.9, weight_decay=0.0) if lr is None
          else SGDConfig(lambda step: lr, momentum=0.0, weight_decay=0.0))
    return create_train_state(model, tx, device="cpu")


def _place(mesh, state) -> int:
    """Split ``state`` over the model axis at MIN_SIZE and place it; the count
    of split parameters."""
    from stcd_tpu_torch.parallel import distributed, tensor
    from stcd_tpu_torch.parallel.mesh import place_train_state

    tensor.split_model(state.model, mesh.model, distributed.model_rank(), state.optimizer,
                       min_size_to_shard=MIN_SIZE)
    place_train_state(mesh, state)
    return sum(hasattr(p, "tp_split") for p in state.model.parameters())


def _full(state) -> dict:
    from stcd_tpu_torch.parallel import tensor
    return {k: v.clone() for k, v in tensor.full_state_dict(state.model).items()}


def _steps(stage, mesh, augment):
    from stcd_tpu_torch.parallel import spatial
    from stcd_tpu_torch.train import steps

    if mesh is None:
        make = {1: steps.make_seg_steps, 2: steps.make_cd_steps, 3: steps.make_semi_cd_steps}
        return make[stage](augment=augment)
    make = {1: spatial.make_spatial_seg_steps, 2: spatial.make_spatial_cd_steps,
            3: spatial.make_spatial_semi_cd_steps}
    return make[stage](None, mesh, augment=augment)


def run_stage(inputs, stage, mesh=None):
    """Stage ``stage``'s STEPS train steps on the global batches with the
    injected draws (data 1: every rank holds them whole), then the eval step
    on the first: the loss terms and counts of each step, the eval's counts
    and probabilities, the full state after, and the state object."""
    state = _state(stage, inputs[f"sd{1 if stage == 1 else 2}"])
    n_split = 0 if mesh is None else _place(mesh, state)
    train_step, eval_step = _steps(stage, mesh, augment=True)
    terms, counts = [], []
    for batch, draws in zip(inputs[f"batches{stage}"], inputs[f"draws{stage}"]):
        out = train_step(state, batch, aug_params=draws)
        terms.append({k: v.item() for k, v in out.items() if k != "cm"})
        counts.append(out["cm"].tolist())
    first = inputs[f"batches{stage}"][0]
    if stage == 1:
        ev = eval_step(state, first)
    else:
        ev = eval_step(state, {"A": first["A"], "B": first["B"],
                               "label": first["label" if stage == 2 else "c_label"]})
    return {"terms": terms, "counts": counts, "eval_cm": ev["cm"].tolist(),
            "eval_probs": ev["probs"], "state": _full(state), "n_split": n_split,
            "step": state.step}, state


def run_cli(data, save, extra=()):
    """cli.train_pse_cd for one epoch on the demo tree: its full state and the
    train losses this rank logged."""
    import json

    from stcd_tpu_torch.cli import train_pse_cd
    from stcd_tpu_torch.parallel import distributed, tensor

    got = train_pse_cd.main(["--root_path", data, *CLI_FLAGS, "--save_name", save, *extra])
    rank = distributed.rank()
    log = os.path.join(save, "logs", "scalars.jsonl" if rank == 0 else f"scalars.p{rank}.jsonl")
    with open(log) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    return {"step": got["state"].step, "losses": losses,
            "split": tensor.is_split(got["state"].model),
            "state": {k: v.clone() for k, v in
                      tensor.full_state_dict(got["state"].model).items()}}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _differs_from_rank0(sd: dict) -> float:
    """The largest |x - rank 0's x| over a full state_dict (every rank calls
    it together)."""
    import torch.distributed as dist

    worst = 0.0
    for v in sd.values():
        theirs = v.clone()
        dist.broadcast(theirs, 0)
        worst = max(worst, (v.double() - theirs.double()).abs().max().item())
    return worst


def _grid_facts(mesh):
    """This rank's indices and the global ranks of each of its groups."""
    import torch.distributed as dist
    from stcd_tpu_torch.parallel import distributed

    groups = {"space": distributed.space_group(), "model": distributed.model_group(),
              "data": distributed.data_group(), "shard": distributed.shard_group()}
    return {"mesh": tuple(mesh), "model_rank": distributed.model_rank(),
            "space_rank": distributed.space_rank(), "data_rank": distributed.data_rank(),
            "data_group_size": distributed.data_group_size(),
            "groups": {k: dist.get_process_group_ranks(g) for k, g in groups.items()}}


def _checkpoint(state, mesh, tmp):
    """Save the split stage-3 ``state``, restore it into a fresh split state of
    other weights, and compare that with what was saved."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    mgr.save_last(state, 4, 0.25, 3)
    fresh = _state(3, init_weights(SegCD("resnet18", decoder_channels=DEC, classes=1),
                                   seed=7).state_dict())
    _place(mesh, fresh)
    restored = mgr.restore_last(fresh)
    local = state.model.state_dict()
    mom = {id(p): state.optimizer.state[p]["momentum_buffer"]
           for p in state.model.parameters()}
    return {"restored": restored[1:], "step": (fresh.step, state.step),
            "tensors_equal": all(torch.equal(v, local[k])
                                 for k, v in fresh.model.state_dict().items()),
            "momentum_equal": all(
                torch.equal(fresh.optimizer.state[q]["momentum_buffer"], mom[id(p)])
                for p, q in zip(state.model.parameters(), fresh.model.parameters())),
            "split_equal": all(hasattr(p, "tp_split") == hasattr(q, "tp_split")
                               for p, q in zip(state.model.parameters(),
                                               fresh.model.parameters()))}


def _worker(job: str, rank: int, tmp: str) -> int:
    """Rank ``rank`` of ``job`` (JOBS): writes what it computed to
    ``{job}_rank{rank}.pt``."""
    # tensorboard imports TensorFlow where it is installed, and TensorFlow may import JAX
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    data = os.path.join(tmp, "demo")
    if job == "one":
        out = {f"stage{s}": run_stage(inputs, s)[0] for s in (1, 3)}
        out["cli"] = run_cli(data, os.path.join(tmp, "cli_one"))
        torch.save(out, os.path.join(tmp, "one_rank0.pt"))
        return 0
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh

    distributed.initialize("cpu", init_method="file://" + os.path.join(tmp, "rdv"),
                           world_size=JOBS[job], rank=rank)
    mesh = create_mesh(model=MODEL, space=SPACE)
    out = {"grid": _grid_facts(mesh)}
    # (a), (b): one stage-2 step under SGD at a rate of 1, the eval step before it
    state = _state(2, inputs["sd2"], lr=1.0)
    n_split = _place(mesh, state)
    train_step, eval_step = _steps(2, mesh, augment=False)
    batch = inputs["batch2"]
    ev = eval_step(state, batch)
    got = train_step(state, batch)
    full = _full(state)
    out["cd"] = {"loss": got["loss"].item(), "cm": got["cm"].tolist(),
                 "eval_probs": ev["probs"], "eval_cm": ev["cm"].tolist(), "n_split": n_split,
                 "differs": _differs_from_rank0(full), "state": full if rank == 0 else None}
    # (c), (e)
    for stage in (1, 3):
        res, state = run_stage(inputs, stage, mesh)
        res["differs"] = _differs_from_rank0(res["state"])
        if rank:
            res["state"] = None
        out[f"stage{stage}"] = res
    out["ckpt"] = _checkpoint(state, mesh, tmp)
    # (f)
    cli = run_cli(data, os.path.join(tmp, "cli_grid"),
                  ["--space_axis", str(SPACE), "--model_axis", str(MODEL)])
    cli["differs"] = _differs_from_rank0(cli["state"])
    if rank:
        cli["state"] = None
    out["cli"] = cli
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "stcd_tpu"))
    torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
    distributed.barrier("done")
    return 0


# --------------------------------------------------------------------------
# the parent: references, spawn, checks
# --------------------------------------------------------------------------

def _jax_variables(model, args, seed):
    """Seeded float32 variables of a JAX model (tests/test_torch_spatial.py)."""
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


def _images(rng, n):
    return torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))


def _label(rng, n):
    return torch.from_numpy((rng.uniform(size=(n, HW, HW, 1)) > 0.8).astype(np.float32))


def _inputs(variables):
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
    from stcd_tpu_torch.data.augment import sample_augment_params, sample_pair_params
    from stcd_tpu_torch.models.segcd import UnetSeg, init_weights

    rng = np.random.default_rng(22)
    inputs = {"sd1": init_weights(UnetSeg("resnet18", decoder_channels=DEC, classes=1),
                                  seed=1).state_dict(),
              "sd2": unetseg_from_flax(variables["params"], variables["batch_stats"],
                                       encoder_name="resnet18"),
              "batch2": {"A": _images(rng, N), "B": _images(rng, N), "label": _label(rng, N)},
              "batches1": [{"image": _images(rng, N), "label": _label(rng, N)}
                           for _ in range(STEPS)],
              "batches3": [{"A": _images(rng, N), "B": _images(rng, N),
                            "s_label_A": _label(rng, N), "c_label": _label(rng, N),
                            "CA": _images(rng, N), "CB": _images(rng, N),
                            "CL": _label(rng, N)} for _ in range(STEPS)]}
    g = torch.Generator().manual_seed(23)
    inputs["draws1"] = [sample_augment_params(g, N, 0.5) for _ in range(STEPS)]
    inputs["draws3"] = [(sample_pair_params(g, N, 0.5), sample_pair_params(g, N, 0.8))
                        for _ in range(STEPS)]
    return inputs


def _jax_cd_step(model, variables, batch):
    """JAX's single-placement make_cd_steps (no augmentation) under SGD at a
    rate of 1: the eval step on the initial state, then one train step."""
    import jax
    import optax
    from stcd_tpu.train.state import TrainState
    from stcd_tpu.train.steps import make_cd_steps

    batch = {k: v.numpy() for k, v in batch.items()}
    state = TrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=optax.sgd(1.0))
    train_step, eval_step = make_cd_steps(model, augment=False)
    ev = eval_step(state, batch)
    probs = np.asarray(ev["probs"])
    state, out = train_step(state, batch, jax.random.PRNGKey(0))
    return {"loss": float(out["loss"]), "cm": np.asarray(out["cm"], np.int64),
            "eval_probs": probs, "eval_cm": np.asarray(ev["cm"], np.int64),
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Prepare the inputs, spawn the four ranks and the one process, compute
    JAX's step while they run."""
    import jax.numpy as jnp
    from stcd_tpu.models.segcd import SegCD as JaxSegCD
    from stcd_tpu_torch.cli import make_demo_data
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("space_model"))
    z = jnp.zeros((1, HW, HW, 3))
    jax_model = JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    variables = _jax_variables(jax_model, (z, z), 2)
    inputs = _inputs(variables)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    make_demo_data.make_tree(os.path.join(tmp, "demo"), n=2, size=HW)

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [(job, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", job, str(r), tmp],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for job, world in JOBS.items() for r in range(world)]
    try:
        jax_out = _jax_cd_step(jax_model, variables, inputs["batch2"])
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        torch.set_num_threads(threads)
    for (job, p), log in zip(procs, logs):
        assert p.returncode == 0, f"a rank of {job}:\n{log[-4000:]}"
    got = {job: [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"), weights_only=True)
                 for r in range(world)] for job, world in JOBS.items()}
    jax_out["state"] = unetseg_from_flax(jax_out.pop("params"), jax_out.pop("batch_stats"),
                                         encoder_name="resnet18")
    yield {"inputs": inputs, "ranks": got["grid"], "one": got["one"][0], "jax": jax_out,
           "tmp": tmp}


def _hold_counts(got, want, pixels=2):
    """Confusion counts: the label's counts equal, the predicted ones but for
    ``pixels`` whose probability sits within float32 noise of 0.5."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(1), want.sum(1))
    assert np.abs(got - want).sum() <= 2 * pixels, (got, want)


# --- (d) the grid ---

@pytest.mark.parametrize("axes", [(2, 2, 2, 1), (1, 2, 2, 1), (2, 1, 2, 1), (4, 2, 1, 1),
                                  (2, 2, 1, 2), (1, 2, 1, 4), (1, 4, 2, 1)],
                         ids=lambda a: "x".join(map(str, a)))
def test_grid_ranks_equal_jax_mesh_layout(axes):
    """The groups of grid_ranks are the device sets of JAX's create_mesh over
    devices 0..W-1 (stcd_tpu/parallel/mesh.py:29-48): along each axis of size
    > 1 the devices that differ in it alone, in its order; the data sets the
    devices of one model and stage index (data x space), the shard sets those
    of one model index."""
    import jax
    from stcd_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from stcd_tpu_torch.parallel.mesh import grid_ranks

    D, T, S, G = axes
    ids = np.vectorize(lambda d: d.id)(
        jax_create_mesh(D, T, S, G, devices=jax.devices()[:D * T * S * G]).devices)
    assert ids.shape == (D, T, S, G)

    def along(axis):
        moved = np.moveaxis(ids, axis, -1).reshape(-1, ids.shape[axis])
        return sorted(map(list, moved))

    want = {name: along(axis) for name, axis in
            (("model", 1), ("space", 2), ("stage", 3)) if axes[axis] > 1}
    if T * G > 1:
        want["data"] = sorted(list(ids[:, m, :, g].reshape(-1))
                              for m in range(T) for g in range(G))
    if T > 1:
        want["shard"] = sorted(list(ids[:, m].reshape(-1)) for m in range(T))
    got = grid_ranks(D, T, S, G)
    assert {k: sorted(v) for k, v in got.items()} == {k: [list(map(int, r)) for r in v]
                                                       for k, v in want.items()}
    for sets in got.values():  # each group's members lie in one order, every rank in one
        assert sorted(r for ranks in sets for r in ranks) == list(range(D * T * S * G))


def test_rank_helpers_and_groups_follow_the_grid(run):
    from stcd_tpu_torch.parallel.mesh import grid_ranks

    layout = grid_ranks(1, MODEL, SPACE, 1)
    for r, rank in enumerate(run["ranks"]):
        facts = rank["grid"]
        assert facts["mesh"] == (1, r, SPACE, 1, MODEL)  # data, rank, space, stage, model
        assert (facts["model_rank"], facts["space_rank"], facts["data_rank"]) == (
            r // SPACE, r % SPACE, 0)
        assert facts["data_group_size"] == SPACE
        for name, ranks in facts["groups"].items():
            assert ranks in layout[name] and r in ranks, (name, ranks)
        assert facts["groups"]["data"] == facts["groups"]["shard"] == [
            r - r % SPACE + s for s in range(SPACE)]


# --- (a) and (b) against JAX's single placement ---

def test_loss_and_gradients_equal_jax_single_placement(run):
    want, start = run["jax"], run["inputs"]["sd2"]
    for rank in run["ranks"]:
        assert rank["cd"]["n_split"] >= 10  # conv kernels split over 'model'
        np.testing.assert_allclose(rank["cd"]["loss"], want["loss"], rtol=LOSS_RTOL_JAX)
        assert rank["cd"]["differs"] == 0.0
    got = run["ranks"][0]["cd"]["state"]
    assert got.keys() == start.keys()
    for k, w in want["state"].items():
        if "running" in k or "num_batches" in k:
            continue
        g_want = (start[k].double() - w.double()).numpy()
        g_got = (start[k].double() - got[k].double()).numpy()
        atol = max(GRAD_ATOL, GRAD_SHARE * float(np.abs(g_want).max()))
        np.testing.assert_allclose(g_got, g_want, atol=atol, rtol=GRAD_RTOL, err_msg=k)


def test_cd_steps_equal_jax_cd_steps(run):
    want = run["jax"]
    for rank in run["ranks"]:
        delta = np.abs(np.asarray(rank["cd"]["cm"]) - want["cm"]).sum()
        assert delta <= CM_DELTA, f"confusion counts moved by {delta}"
        np.testing.assert_allclose(rank["cd"]["eval_probs"].numpy(), want["eval_probs"],
                                   atol=EVAL_ATOL_JAX, rtol=0)
    # the eval counts of the strips of one model index make the whole images' once
    for m in range(MODEL):
        strips = np.sum([run["ranks"][m * SPACE + s]["cd"]["eval_cm"] for s in range(SPACE)], 0)
        assert np.abs(strips - want["eval_cm"]).sum() <= CM_DELTA
    got = run["ranks"][0]["cd"]["state"]
    for k, w in want["state"].items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=STATS_ATOL, rtol=0,
                                       err_msg=k)


# --- (c) stages 1 and 3 against one process ---

@pytest.mark.parametrize("stage", [1, 3])
def test_stage_steps_equal_one_process(run, stage):
    one = run["one"][f"stage{stage}"]
    ranks = [r[f"stage{stage}"] for r in run["ranks"]]
    for got in ranks:
        assert got["n_split"] >= 10 and got["step"] == one["step"] == STEPS
        assert got["differs"] == 0.0
        for step, (g, w) in enumerate(zip(got["terms"], one["terms"])):
            assert g.keys() == w.keys()
            for term in w:
                np.testing.assert_allclose(g[term], w[term], rtol=LOSS_RTOL,
                                           err_msg=f"{term} of step {step}")
        for g, w in zip(got["counts"], one["counts"]):
            _hold_counts(g, w)
        torch.testing.assert_close(got["eval_probs"], one["eval_probs"], atol=EVAL_ATOL,
                                   rtol=0)
    for m in range(MODEL):
        _hold_counts(np.sum([ranks[m * SPACE + s]["eval_cm"] for s in range(SPACE)], 0),
                     one["eval_cm"])
    state = ranks[0]["state"]
    assert state.keys() == one["state"].keys()
    for k, w in one["state"].items():
        atol = STATE_SHARE * max(1.0, w.abs().max().item())
        torch.testing.assert_close(state[k], w, atol=atol, rtol=0, msg=k)


# --- (e) checkpoints ---

def test_checkpoint_round_trip_of_the_split_state(run):
    saved = torch.load(os.path.join(run["tmp"], "ckpt", "last_ckpt"), weights_only=True)
    want = run["ranks"][0]["stage3"]["state"]
    assert saved["model"].keys() == want.keys()
    for k, v in want.items():  # the one-process layout: the split tensors whole
        assert torch.equal(saved["model"][k], v), k
    for rank in run["ranks"]:
        got = rank["ckpt"]
        assert got["restored"] == (4, 0.25, 3) and got["step"] == (STEPS, STEPS)
        assert got["tensors_equal"] and got["momentum_equal"] and got["split_equal"]


# --- (f) the CLI ---

def test_cli_space_and_model_axes_train_what_one_process_trains(run):
    want = run["one"]["cli"]
    assert want["step"] == 1 and len(want["losses"]) == 1 and not want["split"]
    for rank in run["ranks"]:
        got = rank["cli"]
        assert got["step"] == want["step"] and got["split"] and got["differs"] == 0.0
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    state = run["ranks"][0]["cli"]["state"]
    agree = total = 0
    for k, w in want["state"].items():
        atol = CLI_ATOL + 1e-6 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(state[k], w, atol=atol, rtol=0, msg=k)
        if w.is_floating_point():
            agree += ((state[k] - w).abs() <= 1e-5).sum().item()
            total += w.numel()
    assert agree >= CLI_AGREE * total, agree / total


def test_no_jax_in_the_ranks(run):
    for rank in run["ranks"]:
        assert rank["jax_imported"] == []


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
