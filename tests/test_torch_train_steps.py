"""stcd_tpu_torch's make_cd_steps, make_seg_steps and make_semi_cd_steps
against the JAX functions of the same names: the same
init (one JAX init, perturbed, converted), the same batches (numpy, from a
seed), float32 on the CPU. SegCD resnet18, decoder (32, 24, 16, 12, 8),
32x32, batch 2.

Adam moves a parameter with a near-zero gradient by +-lr whatever the
gradient's size, so float32 noise shows after the first update: the first
loss is held tightly and the later ones loosely."""

import contextlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.data import augment as jaug
from stcd_tpu.losses.functional import bce_dice as jax_bce_dice
from stcd_tpu.models.segcd import SegCD as JaxSegCD
from stcd_tpu.models.segcd import UnetSeg as JaxUnetSeg
from stcd_tpu.train.schedules import poly_schedule as jax_poly_schedule
from stcd_tpu.train.state import TrainState as JaxTrainState
from stcd_tpu.train.steps import make_cd_steps as jax_make_cd_steps
from stcd_tpu.train.steps import make_seg_steps as jax_make_seg_steps
from stcd_tpu.train.steps import make_semi_cd_steps as jax_make_semi_cd_steps
from stcd_tpu_torch.convert.from_flax import resnet_from_flax, unetseg_from_flax
from stcd_tpu_torch.models.segcd import SegCD, UnetSeg
from stcd_tpu_torch.train.state import (AdamConfig, AdamWConfig, SGDConfig, adam_poly,
                                        create_train_state)
from stcd_tpu_torch.train.schedules import poly_schedule
from stcd_tpu_torch.train.steps import make_cd_steps, make_seg_steps, make_semi_cd_steps


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once, and at these sizes more threads
    cost CPU time and buy little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

DEC = (32, 24, 16, 12, 8)
N, HW = 2, 32
SCHEDULE = (1e-3, 2, 4)  # base rate, epochs, iterations per epoch: 8 steps


def _perturb(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _batches(seed, count, uint8=False, n=N):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        if uint8:
            a, b = (rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8) for _ in range(2))
        else:
            a, b = (rng.uniform(0, 1, (n, HW, HW, 3)).astype(np.float32) for _ in range(2))
        label = (rng.uniform(size=(n, HW, HW, 1)) > 0.8).astype(np.float32)
        out.append({"A": a, "B": b, "label": label})
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def init():
    model = JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    z = jnp.zeros((1, HW, HW, 3))
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), z, z), seed=1)
    return model, variables


def _jax_state(init):
    model, variables = init
    return JaxTrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.adam(jax_poly_schedule(*SCHEDULE)))


def _port_state(init):
    _, variables = init
    port = SegCD("resnet18", decoder_channels=DEC, classes=1)
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return create_train_state(port, AdamConfig(poly_schedule(*SCHEDULE)), device="cpu")


def _hold_counts(got, want):
    """Confusion counts of one step: equal, but for at most 2 of the
    pixels, whose probability may sit within float32 noise of the 0.5
    threshold (a flipped pixel moves two cells by one)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.sum() == want.sum()
    np.testing.assert_array_equal(got.sum(1), want.sum(1))  # the label's counts
    assert np.abs(got - want).sum() <= 2 * 2, (got, want)


def _hold_running_stats(state, batch_stats, variables, atol):
    want = unetseg_from_flax(variables["params"], batch_stats)
    got = state.model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) >= 60
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol, rtol=1e-4,
                                   err_msg=name)


def test_four_steps_without_augmentation(init):
    model, variables = init
    batches = _batches(2, 4)
    jtrain, _ = jax_make_cd_steps(model, augment=False)
    train_step, _ = make_cd_steps(augment=False)
    jstate, state = _jax_state(init), _port_state(init)

    # the gradients of step 0, from the JAX loss as the step composes it
    a, b = (jaug.eval_preprocess(jnp.asarray(batches[0][k])) for k in "AB")

    def loss_fn(params):
        (_, _, diff), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, a, b, True,
            mutable=["batch_stats"])
        return jax_bce_dice(jax.nn.sigmoid(diff), jnp.asarray(batches[0]["label"]))

    want_grads = unetseg_from_flax(jax.jit(jax.grad(loss_fn))(variables["params"]),
                                   variables["batch_stats"])

    for i, batch in enumerate(batches):
        jstate, want = jtrain(jstate, _to_jax(batch), jax.random.PRNGKey(i))
        got = train_step(state, _to_torch(batch))
        # the first loss tightly; later ones after Adam's sign-like updates
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   atol=1e-5 if i == 0 else 2e-3, rtol=0,
                                   err_msg=f"loss of step {i}")
        assert int(got["cm"].sum()) == N * HW * HW
        if i == 0:
            _hold_counts(got["cm"], want["cm"])
            # running stats after the first step: the shallow layers at 1e-5; the
            # deep ones normalise over 4 to 64 values, which amplifies the noise
            _hold_running_stats(state, jstate.batch_stats, variables, atol=2e-4)
            shallow = unetseg_from_flax(variables["params"], jstate.batch_stats)
            for name in ("encoder.bn1.running_mean", "encoder.bn1.running_var",
                         "encoder.layer1.0.bn1.running_mean",
                         "decoder.blocks.4.conv2.1.running_var"):
                np.testing.assert_allclose(state.model.state_dict()[name].numpy(),
                                           shallow[name].numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=name)
            grads = dict(state.model.named_parameters())
            for name in ("segmentation_head.0.weight", "segmentation_head.0.bias",
                         "decoder.blocks.4.conv2.0.weight", "decoder.blocks.0.conv1.0.weight",
                         "decoder.blocks.2.conv1.1.weight", "encoder.conv1.weight",
                         "encoder.layer1.0.bn1.bias", "encoder.layer2.0.downsample.0.weight"):
                w = want_grads[name].numpy()
                # rtol 1e-3 of each element, and of the largest for the small ones
                np.testing.assert_allclose(grads[name].grad.numpy(), w, rtol=1e-3,
                                           atol=1e-3 * np.abs(w).max(), err_msg=name)
    assert state.step == 4 and int(jstate.step) == 4
    # the rate used by the last update is the schedule at the count before it
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jax_poly_schedule(*SCHEDULE)(3)), rel=1e-6)


def test_first_step_with_injected_augmentation(init):
    """The JAX step samples its draws from the rng; the same draws, made here
    with its key structure, are injected into the port's step."""
    model, _ = init
    batch = _batches(3, 1, uint8=True)[0]
    rng = jax.random.PRNGKey(11)
    aug_key, _ = jax.random.split(rng)  # steps.py: aug_key, drop_key = split(rng)
    key = jax.random.split(aug_key, 1)[0]  # _augment_pairs: one pair list entry
    keys = jax.random.split(key, N)  # _train_augment_pair_impl: per-sample keys
    k_shared = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    coin = jax.vmap(lambda k: jax.random.uniform(k[0]) < 0.5)(k_shared)
    draws = tuple({k: torch.from_numpy(np.asarray(v).copy())
                   for k, v in jaug._batched_params(k_shared[:, i], 0.5, coin).items()}
                  for i in (1, 2))
    assert torch.equal(draws[0]["jitter_apply"], draws[1]["jitter_apply"])

    jtrain, _ = jax_make_cd_steps(model, augment=True)
    _, want = jtrain(_jax_state(init), _to_jax(batch), rng)
    train_step, _ = make_cd_steps(augment=True)
    got = train_step(_port_state(init), _to_torch(batch), aug_params=draws)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), atol=1e-4, rtol=0)
    # sampling from a generator instead: a finite loss, another batch of draws
    state = _port_state(init)
    sampled = train_step(state, _to_torch(batch), torch.Generator().manual_seed(0))
    assert torch.isfinite(sampled["loss"]) and state.step == 1


def test_gradient_accumulation_matches_jax(init):
    model, variables = init
    # batch 4: each micro-batch folds 2 pairs into 4 images, as the other tests do
    # (over the 2 values of one pair at the 1x1 deepest level BatchNorm is all noise)
    batches = _batches(4, 2, n=4)
    jtrain, _ = jax_make_cd_steps(model, augment=False, accum_steps=2)
    train_step, _ = make_cd_steps(augment=False, accum_steps=2)
    jstate, state = _jax_state(init), _port_state(init)
    for i, batch in enumerate(batches):
        jstate, want = jtrain(jstate, _to_jax(batch), jax.random.PRNGKey(i))
        got = train_step(state, _to_torch(batch))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   atol=1e-5 if i == 0 else 2e-3, rtol=0)
        if i == 0:  # summed over the micro-batches
            _hold_counts(got["cm"], want["cm"])
            # two BatchNorm updates, one per micro-batch
            _hold_running_stats(state, jstate.batch_stats, variables, atol=2e-4)
            assert int(state.model.encoder.bn1.num_batches_tracked) == 2
    with pytest.raises(ValueError, match="not divisible"):
        make_cd_steps(augment=False, accum_steps=3)[0](state, _to_torch(batches[0]))


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_equals_no_remat(init, accum):
    """Recomputing the forward in the backward changes nothing: not the
    loss, not the gradients, and not the BatchNorm running statistics, which
    the recomputation must not update a second time."""
    batch = _to_torch(_batches(5, 1)[0])
    outs = {}
    for remat in (False, True):
        state = _port_state(init)
        out = make_cd_steps(augment=False, remat=remat, accum_steps=accum)[0](state, batch)
        outs[remat] = (out, state)
    (plain, s0), (remat, s1) = outs[False], outs[True]
    assert torch.equal(plain["loss"], remat["loss"]) and torch.equal(plain["cm"], remat["cm"])
    for (name, p0), (_, p1) in zip(s0.model.named_parameters(), s1.model.named_parameters()):
        torch.testing.assert_close(p1.grad, p0.grad, atol=1e-7, rtol=1e-5, msg=name)
    sd0, sd1 = s0.model.state_dict(), s1.model.state_dict()
    for name in sd0:
        if "running" in name or "num_batches" in name:
            assert torch.equal(sd0[name], sd1[name]), name
    assert int(sd1["encoder.bn1.num_batches_tracked"]) == accum


def test_eval_step_matches_jax(init):
    model, variables = init
    batch = _batches(6, 1)[0]
    _, jeval = jax_make_cd_steps(model, augment=False)
    want = jeval(_jax_state(init), _to_jax(batch))
    state = _port_state(init)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = make_cd_steps()[1](state, _to_torch(batch))
    assert got["probs"].shape == (N, HW, HW, 1) and not got["probs"].requires_grad
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]),
                               atol=2e-4, rtol=1e-3)
    # counts may differ only where a probability sits at the threshold
    near = int((np.abs(np.asarray(want["probs"]) - 0.5) < 2e-4).sum())
    assert np.abs(got["cm"].numpy() - np.asarray(want["cm"])).sum() <= 2 * near
    assert int(got["cm"].sum()) == N * HW * HW
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert not state.model.training and state.step == 0


def test_create_train_state_device_weights_and_bf16(init, tmp_path, monkeypatch):
    _, variables = init
    sd = resnet_from_flax(variables["params"]["encoder"], variables["batch_stats"]["encoder"])
    torch.save(sd, tmp_path / "resnet18.pt")
    model = SegCD("resnet18", decoder_channels=DEC)
    state = create_train_state(model, adam_poly(1e-3, 2, 4), device="cpu",
                               encoder_weights=str(tmp_path / "resnet18.pt"))
    assert state.device.type == "cpu" and state.step == 0 and not state.bf16
    assert torch.equal(state.model.encoder.layer2[0].downsample[0].weight,
                       sd["layer2.0.downsample.0.weight"])
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.defaults["betas"] == (0.9, 0.999)
    assert state.optimizer.defaults["eps"] == 1e-8

    torch.save({k: v for k, v in sd.items() if k != "conv1.weight"}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="conv1.weight"):
        create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(), device="cpu",
                           encoder_weights=str(tmp_path / "bad.pt"))
    monkeypatch.setenv("STCD_PRETRAINED_DIR", str(tmp_path / "pretrained"))
    with pytest.raises(FileNotFoundError, match="imagenet"):
        create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(), device="cpu",
                           encoder_weights="imagenet")
    (tmp_path / "pretrained").mkdir()
    torch.save(sd, tmp_path / "pretrained" / "resnet18.pth")
    resolved = create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(),
                                  device="cpu", encoder_weights="imagenet")
    assert torch.equal(resolved.model.encoder.conv1.weight, sd["conv1.weight"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly())

    # bf16 autocast on the CPU: float32 master weights, a finite float32 loss
    bf16 = create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(),
                              device="cpu", bf16=True)
    out = make_cd_steps(augment=False)[0](bf16, _to_torch(_batches(7, 1)[0]))
    assert out["loss"].dtype == torch.float32 and torch.isfinite(out["loss"])
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_steps_on_given_gradients_match_optax(optimizer):
    """Three updates of one weight tensor on given gradients, with a rate
    (0.1, halved each step) and a weight decay (0.5) large enough that every
    term shows: the decay joining the gradient ahead of the momentum trace
    (sgd), -lr (adam + wd p) against (1 - lr wd) p - lr adam (adamw), and the
    rate taken at the count before the update. The chains are those of the
    JAX trainer's _make_optimizer with these numbers. atol 3e-6, a few float32
    ulps of weights as large as 2, which move by 0.02 to 0.3 a step."""
    schedule = lambda step: 0.1 * 0.5 ** step
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]

    if optimizer == "sgd":
        tx = optax.chain(optax.add_decayed_weights(0.5), optax.sgd(schedule, momentum=0.99))
        cfg = SGDConfig(schedule, momentum=0.99, weight_decay=0.5)
    else:
        tx = optax.adamw(schedule, b1=0.9, b2=0.999, weight_decay=0.5)
        cfg = AdamWConfig(schedule, b1=0.9, b2=0.999, weight_decay=0.5)
    params, opt_state = jnp.asarray(w0), tx.init(jnp.asarray(w0))

    model = torch.nn.Linear(5, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    state = create_train_state(model, cfg, device="cpu")
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        moved = np.abs(np.asarray(updates)).max()
        params = optax.apply_updates(params, updates)
        model.weight.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        assert moved > 0.02, f"step {step} moves the weights by {moved}"
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(params),
                                   atol=3e-6, rtol=0, err_msg=f"step {step}")
    assert state.step == 3


# --- stage 1 (make_seg_steps) and stage 3 (make_semi_cd_steps) ---

def _seg_batches(seed, count, uint8=False, n=2 * N):
    """4 images by default: the deepest level then normalises over 4 values, as it
    does for the 2 folded pairs of the other tests (over 2 values BatchNorm is
    all noise)."""
    return [{"image": b["A"], "label": b["label"]} for b in _batches(seed, count, uint8, n)]


def _semi_batches(seed, count, uint8=False, n=N):
    """n synthesized pairs (A, B, s_label_A, c_label) and n real pairs (CA, CB, CL)."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for syn, real in zip(_batches(seed, count, uint8, n), _batches(seed + 50, count, uint8, n)):
        s_label = (rng.uniform(size=(n, HW, HW, 1)) > 0.8).astype(np.float32)
        out.append({"A": syn["A"], "B": syn["B"], "s_label_A": s_label,
                    "c_label": syn["label"], "CA": real["A"], "CB": real["B"],
                    "CL": real["label"]})
    return out


@pytest.fixture(scope="module")
def seg_init():
    model = JaxUnetSeg(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))),
                         seed=2)
    return model, variables


@contextlib.contextmanager
def _float64_through_the_losses():
    """The port's losses and BatchNorm take their sums in float32 (``.float()``
    on their inputs); inside this context that cast leaves float64 tensors as
    they are, so that a float64 run of the port is float64 end to end."""
    to_float32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *args, **kwargs: (
        self if self.dtype == torch.float64 else to_float32(self, *args, **kwargs))
    try:
        yield
    finally:
        torch.Tensor.float = to_float32


def _measure_moves(state, jstate, variables, state64):
    """For each parameter tensor: (name, the float64 run's largest move from
    the init, max |port float32 - float64|, max |JAX - float64|, max |weight|)."""
    want = unetseg_from_flax(jstate.params, jstate.batch_stats)
    start = unetseg_from_flax(variables["params"], variables["batch_stats"])
    got, exact = state.model.state_dict(), state64.model.state_dict()
    out = []
    for name in (k for k in want if "running" not in k and "num_batches" not in k):
        ref = exact[name].double()
        out.append((name, (ref - start[name].double()).abs().max().item(),
                    (got[name].double() - ref).abs().max().item(),
                    (want[name].double() - ref).abs().max().item(),
                    ref.abs().max().item()))
    return out


# Parameters after three SGD updates: both float32 runs against a float64 run of the
# port from the same init on the same batches (the pattern of test_torch_bit.py's
# gradient test), within a share of the float64 run's largest move in the tensor plus
# 4 float32 ulps of the weights (three roundings of the update). Measured on a CPU
# host, as the largest share beyond the ulps over all tensors:
# - stage 1: both float32 runs within the ulps alone;
# - stage 3: the port's float32 1.9e-2 (decoder.blocks.2.conv2.0.weight: 1.7e-6 of a
#   6.3e-5 move), JAX's 3.1e-3 (decoder.blocks.3.conv1.0.weight). Three updates move
#   the decoder's weights by only 1e-4 while the three loss terms sum gradients that
#   partly cancel, so float32 rounding is a visible share of the move; the port and
#   JAX round in different places, and held against each other (at 1e-2, as before)
#   the two noises added up to 1.4 times that bound on some hosts.
# The bounds are about twice the port's and three times JAX's measured noise. The
# BatchNorm layers of encoder.layer4, which normalise over 4 values at 32x32 and
# amplify float32 noise, need no bound of their own against float64.
PORT_SHARE, JAX_SHARE = 4e-2, 1e-2


def _hold_parameters(state, jstate, variables, state64):
    moves = _measure_moves(state, jstate, variables, state64)
    assert len(moves) >= 60
    for name, moved, port_err, jax_err, scale in moves:
        assert moved > 0, f"{name} did not move"
        ulps = 5e-7 * max(1.0, scale)
        assert port_err <= PORT_SHARE * moved + ulps, (
            name, "port float32 against float64", port_err, moved)
        assert jax_err <= JAX_SHARE * moved + ulps, (
            name, "JAX float32 against the port's float64", jax_err, moved)


STAGES = {
    1: (jax_make_seg_steps, make_seg_steps, _seg_batches),
    3: (jax_make_semi_cd_steps, make_semi_cd_steps, _semi_batches),
}


def _states(stage, init, seg_init, sgd=False, dtype=torch.float32):
    """(JAX model, variables, JAX state, port state) of a stage, with Adam as in
    the stage-2 tests or with SGD (momentum 0.9, no decay) at the same schedule;
    the port's weights in ``dtype``."""
    model, variables = seg_init if stage == 1 else init
    schedule = jax_poly_schedule(*SCHEDULE)
    jstate = JaxTrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=optax.sgd(schedule, momentum=0.9) if sgd else optax.adam(schedule))
    port = (UnetSeg if stage == 1 else SegCD)("resnet18", decoder_channels=DEC, classes=1)
    port.to(dtype).load_state_dict(
        unetseg_from_flax(variables["params"], variables["batch_stats"]), strict=True)
    tx = (SGDConfig(poly_schedule(*SCHEDULE), momentum=0.9, weight_decay=0.0) if sgd
          else AdamConfig(poly_schedule(*SCHEDULE)))
    return model, variables, jstate, create_train_state(port, tx, device="cpu")


@pytest.mark.parametrize("stage", [1, 3])
def test_three_steps_of_stages_1_and_3_without_augmentation(stage, init, seg_init):
    jmake, make, batches_of = STAGES[stage]
    # SGD, so that the parameters can be held after the updates: Adam moves a parameter
    # whose gradient is float32 noise around 0 by +-lr a step (the stage-2 test holds Adam)
    model, variables, jstate, state = _states(stage, init, seg_init, sgd=True)
    state64 = _states(stage, init, seg_init, sgd=True, dtype=torch.float64)[3]
    jtrain, _ = jmake(model, augment=False)
    train_step, _ = make(augment=False)
    terms = ("loss", "seg_loss", "cd_loss", "ct_loss") if stage == 3 else ("loss",)
    for i, batch in enumerate(batches_of(8, 3)):
        jstate, want = jtrain(jstate, _to_jax(batch), jax.random.PRNGKey(i))
        got = train_step(state, _to_torch(batch))
        with _float64_through_the_losses():
            train_step(state64, {k: v.double() for k, v in _to_torch(batch).items()})
        assert set(got) == set(want) == {*terms, "cm"}
        for term in terms:
            np.testing.assert_allclose(got[term].item(), float(want[term]), atol=1e-5, rtol=0,
                                       err_msg=f"{term} of step {i}")
        # 4 images, or all 2N pairs of stage 3's concatenated batch
        assert int(got["cm"].sum()) == 2 * N * HW * HW
        if i == 0:
            _hold_counts(got["cm"], want["cm"])
            _hold_running_stats(state, jstate.batch_stats, variables, atol=2e-4)
    assert state.step == 3 and int(jstate.step) == 3 and state64.step == 3
    assert all(p.dtype == torch.float64 for p in state64.model.parameters())
    _hold_parameters(state, jstate, variables, state64)


def _pair_draws(key, n, jitter_p):
    """The draws of jaug._train_augment_pair_impl for n pairs, as torch dicts."""
    keys = jax.random.split(key, n)
    k_shared = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    coin = jax.vmap(lambda k: jax.random.uniform(k[0]) < jitter_p)(k_shared)
    return tuple({k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in jaug._batched_params(k_shared[:, i], jitter_p, coin).items()}
                 for i in (1, 2))


@pytest.mark.parametrize("stage", [1, 3])
def test_first_step_of_stages_1_and_3_with_injected_augmentation(stage, init, seg_init):
    """The JAX step samples its draws from the rng; the same draws, made here
    with its key structure, drive the port's step. Stage 1: every image its
    own coins. Stage 3: one jitter coin per pair, p = 0.5 for the synthesized
    pairs and p = 0.8 for the real ones, the 4N images in one augmentation call."""
    from stcd_tpu_torch.ops import augment as ops_augment

    jmake, make, batches_of = STAGES[stage]
    model, _, jstate, state = _states(stage, init, seg_init)
    batch = batches_of(9, 1, uint8=True)[0]
    rng = jax.random.PRNGKey(13)
    aug_key, _ = jax.random.split(rng)  # steps.py: aug_key, drop_key = split(rng)
    if stage == 1:
        keys = jax.random.split(aug_key, 2 * N)  # _train_augment_impl: per-sample keys
        draws = {k: torch.from_numpy(np.asarray(v).copy())
                 for k, v in jaug._batched_params(keys, 0.5).items()}
    else:
        k_syn, k_real = jax.random.split(aug_key, 2)  # _augment_pairs: one key per pair list
        draws = (_pair_draws(k_syn, N, 0.5), _pair_draws(k_real, N, 0.8))
        for pa, pb in draws:
            assert torch.equal(pa["jitter_apply"], pb["jitter_apply"])
    _, want = jmake(model, augment=True)[0](jstate, _to_jax(batch), rng)
    train_step, _ = make(augment=True)

    calls = []
    plain = ops_augment.apply_augment_batch

    def counting(imgs, params, impl=None):
        calls.append(imgs.shape[0])
        return plain(imgs, params, impl=impl)

    ops_augment.apply_augment_batch = counting
    try:
        got = train_step(state, _to_torch(batch), aug_params=draws)
    finally:
        ops_augment.apply_augment_batch = plain
    assert calls == [2 * N if stage == 1 else 4 * N]  # one augmentation call a step
    for term in want:
        if term != "cm":
            np.testing.assert_allclose(got[term].item(), float(want[term]), atol=1e-4, rtol=0,
                                       err_msg=term)
    # sampling from a generator instead: finite losses, another batch of draws
    sampled = train_step(state, _to_torch(batch), torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in sampled.values()) and state.step == 2
    assert sampled["loss"].item() != got["loss"].item()


@pytest.mark.parametrize("stage", [1, 3])
def test_accumulation_of_stages_1_and_3_matches_jax(stage, init, seg_init):
    """accum_steps=2 against the JAX step: under accumulation stage 3 builds
    each micro-batch from its own slices of the synthesized and the real
    halves, not from a slice of the concatenation."""
    jmake, make, batches_of = STAGES[stage]
    model, variables, jstate, state = _states(stage, init, seg_init)
    # stage 1: 8 images, so a micro-batch normalises over 4 values at the deepest
    # level as the 2-pair batches of the other tests do; stage 3: 2 + 2 pairs each
    batch = batches_of(10, 1, n=8 if stage == 1 else 4)[0]
    jstate, want = jmake(model, augment=False, accum_steps=2)[0](
        jstate, _to_jax(batch), jax.random.PRNGKey(0))
    got = make(augment=False, accum_steps=2)[0](state, _to_torch(batch))
    for term in want:
        if term != "cm":
            np.testing.assert_allclose(got[term].item(), float(want[term]), atol=1e-5, rtol=0,
                                       err_msg=term)
    _hold_counts(got["cm"], want["cm"])
    _hold_running_stats(state, jstate.batch_stats, variables, atol=2e-4)
    assert int(state.model.encoder.bn1.num_batches_tracked) == 2 and state.step == 1
    with pytest.raises(ValueError, match="not divisible"):
        make(augment=False, accum_steps=3)[0](state, _to_torch(batch))


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_equals_no_remat_in_stages_1_and_3(stage, accum, init, seg_init):
    _, make, batches_of = STAGES[stage]
    batch = _to_torch(batches_of(11, 1, n=4)[0])
    outs = {}
    for remat in (False, True):
        state = _states(stage, init, seg_init)[3]
        outs[remat] = (make(augment=False, remat=remat, accum_steps=accum)[0](state, batch),
                       state)
    (plain, s0), (remat, s1) = outs[False], outs[True]
    assert all(torch.equal(plain[k], remat[k]) for k in plain)
    for (name, p0), (_, p1) in zip(s0.model.named_parameters(), s1.model.named_parameters()):
        torch.testing.assert_close(p1.grad, p0.grad, atol=1e-7, rtol=1e-5, msg=name)
    sd0, sd1 = s0.model.state_dict(), s1.model.state_dict()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0 if "running" in k or "num_batches" in k)
    assert int(sd1["encoder.bn1.num_batches_tracked"]) == accum


def test_stage_1_eval_step_matches_jax_and_stage_3_eval_is_stage_2s(init, seg_init):
    model, variables, jstate, state = _states(1, init, seg_init)
    batch = _seg_batches(12, 1)[0]
    want = jax_make_seg_steps(model, augment=False)[1](jstate, _to_jax(batch))
    got = make_seg_steps()[1](state, _to_torch(batch))
    assert got["probs"].shape == (2 * N, HW, HW, 1) and not got["probs"].requires_grad
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]),
                               atol=2e-4, rtol=1e-3)
    near = int((np.abs(np.asarray(want["probs"]) - 0.5) < 2e-4).sum())
    assert np.abs(got["cm"].numpy() - np.asarray(want["cm"])).sum() <= 2 * near
    assert not state.model.training and state.step == 0

    cd_batch = _to_torch(_batches(6, 1)[0])
    semi_eval, cd_eval = make_semi_cd_steps()[1], make_cd_steps()[1]
    a, b = semi_eval(_port_state(init), cd_batch), cd_eval(_port_state(init), cd_batch)
    assert torch.equal(a["probs"], b["probs"]) and torch.equal(a["cm"], b["cm"])


def test_stage_3_refuses_unequal_halves(init):
    batch = _to_torch(_semi_batches(13, 1)[0])
    batch["CA"], batch["CB"], batch["CL"] = (batch[k][:1] for k in ("CA", "CB", "CL"))
    with pytest.raises(ValueError, match="synthesized pairs but 1 real"):
        make_semi_cd_steps(augment=False)[0](_port_state(init), batch)
