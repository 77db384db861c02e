"""stcd_tpu_torch's make_cd_steps against the JAX make_cd_steps: the same
init (one JAX init, perturbed, converted), the same batches (numpy, from a
seed), float32 on the CPU. SegCD resnet18, decoder (32, 24, 16, 12, 8),
32x32, batch 2.

Adam moves a parameter with a near-zero gradient by +-lr whatever the
gradient's size, so float32 noise shows after the first update: the first
loss is held tightly and the later ones loosely."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.data import augment as jaug
from stcd_tpu.losses.functional import bce_dice as jax_bce_dice
from stcd_tpu.models.segcd import SegCD as JaxSegCD
from stcd_tpu.train.schedules import poly_schedule as jax_poly_schedule
from stcd_tpu.train.state import TrainState as JaxTrainState
from stcd_tpu.train.steps import make_cd_steps as jax_make_cd_steps
from stcd_tpu_torch.convert.from_flax import resnet_from_flax, unetseg_from_flax
from stcd_tpu_torch.models.segcd import SegCD
from stcd_tpu_torch.train.state import AdamConfig, adam_poly, create_train_state
from stcd_tpu_torch.train.schedules import poly_schedule
from stcd_tpu_torch.train.steps import make_cd_steps

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
    with pytest.raises(NotImplementedError, match="imagenet"):
        create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(), device="cpu",
                           encoder_weights="imagenet")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly())

    # bf16 autocast on the CPU: float32 master weights, a finite float32 loss
    bf16 = create_train_state(SegCD("resnet18", decoder_channels=DEC), adam_poly(),
                              device="cpu", bf16=True)
    out = make_cd_steps(augment=False)[0](bf16, _to_torch(_batches(7, 1)[0]))
    assert out["loss"].dtype == torch.float32 and torch.isfinite(out["loss"])
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
