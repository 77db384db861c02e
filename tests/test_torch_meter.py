"""stcd_tpu_torch/utils/meter.py against stcd_tpu/utils/meter.py on the CPU:
the meter, the metric and loss objects with their names and arithmetic, and
the fit loop (TrainEpoch / ValidEpoch) on the model of tests/test_meter.py:62-85
(UnetSeg over resnet18, decoder (16, 12, 10, 8, 8), 32x32 images), from one JAX
init (perturbed, converted) and the same numpy batches: 2 batches of 4, where
tests/test_meter.py takes 2 of 2. At 2 images of 32x32 the encoder's last
stage is 1x1, so its train-mode BatchNorm sees 2 values a channel, and there
the float32 gradients of both sides are off a float64 run of the port by up to
40 % (measured); at 4 they are within 4e-4 (JAX) and 1e-4 (the port).

Held to: objects within 1e-6; under SGD (lr 0.01) the logs within 1e-5
relative for the loss and METRIC_ATOL for the thresholded metrics (a pixel at
the 0.5 threshold may fall either way), the parameters and running statistics
after the two updates within PARAM_ATOL x max(1, max |JAX|). Adam moves a
parameter whose gradient is float32 noise by +-lr on either side, so under
Adam (the optimizer swap) only the logs are held, within ADAM_RTOL."""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.models.segcd import UnetSeg as JaxUnetSeg
from stcd_tpu.train.state import TrainState as JaxTrainState
from stcd_tpu.utils import meter as jm
from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
from stcd_tpu_torch.models.segcd import UnetSeg
from stcd_tpu_torch.train.state import AdamConfig, SGDConfig, create_train_state
from stcd_tpu_torch.utils import meter as tm

from test_torch_train_steps import _perturb

DEC = (16, 12, 10, 8, 8)
N, HW = 4, 32
METRIC_ATOL = 1e-3  # 4 of the 4096 pixels of a batch
PARAM_ATOL = 1e-5
ADAM_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the meter and the objects ------------------------------------------------------------


def test_average_value_meter_matches_jax_with_its_quirks():
    for seq in ([(1.0, 1), (2.0, 1), (3.0, 1), (4.0, 1)], [(3.0, 0), (4.0, 1), (5.0, 1)],
                [(2.5, 2), (1.0, 1), (7.0, 3)]):
        got, want = tm.AverageValueMeter(), jm.AverageValueMeter()
        for value, n in seq:
            got.add(value, n)
            want.add(value, n)
            assert (got.mean, got.std, got.sum, got.n) == (want.mean, want.std, want.sum, want.n)
        assert got.value() == want.value()
    m = tm.AverageValueMeter()
    for v in (1.0, 2.0, 3.0, 4.0):
        m.add(v)
    assert np.isclose(m.mean, 2.5) and np.isclose(m.std, np.std([1, 2, 3, 4], ddof=1))
    m.reset()
    assert m.n == 0 and np.isnan(m.mean)


def _maps(seed, c=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, c, 8, 8)).astype(np.float32)
    gt = (rng.random((2, c, 8, 8)) > 0.5).astype(np.float32)
    return logits, gt


@pytest.mark.parametrize("kw", [{}, {"activation": "sigmoid"}, {"threshold": 0.3},
                                {"activation": "sigmoid", "ignore_channels": [1]},
                                {"ignore_channels": [0, 2]}])
def test_metric_objects_match_jax(kw):
    logits, gt = _maps(0)
    probs = 1 / (1 + np.exp(-logits))
    x = logits if "activation" in kw else probs.astype(np.float32)
    for name in ("IoU", "Fscore", "Accuracy", "Precision", "Recall"):
        got_obj, want_obj = getattr(tm, name)(**kw), getattr(jm, name)(**kw)
        assert got_obj.__name__ == want_obj.__name__
        got = got_obj(torch.from_numpy(x), torch.from_numpy(gt))
        want = want_obj(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(np.moveaxis(gt, 1, -1)))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
    # the default activation is None: probabilities pass unchanged
    p = torch.tensor([0.3, 0.9, 0.6, 0.1]).reshape(1, 1, 2, 2)
    g = torch.tensor([0.0, 1.0, 1.0, 0.0]).reshape(1, 1, 2, 2)
    assert tm.IoU()(p, g).item() > 0.999 and tm.IoU(activation="sigmoid")(p, g).item() < 0.51


def test_loss_objects_match_jax():
    logits, gt = _maps(1)
    rng = np.random.default_rng(2)
    other = rng.normal(size=logits.shape).astype(np.float32)
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    cls = rng.integers(0, 3, (2, 8, 8))
    logp = np.log(probs / probs.sum(1, keepdims=True)).astype(np.float32)
    cases = [  # (name, keywords, port inputs (NCHW); JAX gets the channel-last ones)
        ("JaccardLoss", {"activation": "sigmoid"}, (logits, gt)),
        ("JaccardLoss", {"ignore_channels": [1]}, (probs, gt)),
        ("DiceLoss", {"activation": "sigmoid"}, (logits, gt)),
        ("DiceLoss", {"beta": 2.0, "ignore_channels": [0]}, (probs, gt)),
        ("L1Loss", {}, (logits, other)),
        ("MSELoss", {}, (logits, other)),
        ("BCELoss", {}, (probs, gt)),
        ("BCEWithLogitsLoss", {}, (logits, gt)),
        ("CrossEntropyLoss", {}, (logits, cls)),
        ("NLLLoss", {}, (logp, cls)),
    ]
    for name, kw, (pr, target) in cases:
        got_obj, want_obj = getattr(tm, name)(**kw), getattr(jm, name)(**kw)
        assert got_obj.__name__ == want_obj.__name__
        jt = target if target.ndim == 3 else np.moveaxis(target, 1, -1)
        want = want_obj(jnp.asarray(np.moveaxis(pr, 1, -1)), jnp.asarray(jt))
        got = got_obj(torch.from_numpy(pr), torch.from_numpy(target))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7, err_msg=name)


def test_loss_arithmetic_names_and_values_match_jax():
    logits, gt = _maps(3, c=1)
    x, y = torch.from_numpy(logits), torch.from_numpy(gt)
    d, j = tm.DiceLoss(activation="sigmoid"), tm.JaccardLoss(activation="sigmoid")
    jd, jj = jm.DiceLoss(activation="sigmoid"), jm.JaccardLoss(activation="sigmoid")
    for got, want in ((d + j, jd + jj), (0.5 * (d + j), 0.5 * (jd + jj)), (d * 2, jd * 2),
                      (3 * j, 3 * jj)):
        assert got.__name__ == want.__name__
        np.testing.assert_allclose(
            got(x, y).item(), float(want(jnp.asarray(np.moveaxis(logits, 1, -1)),
                                         jnp.asarray(np.moveaxis(gt, 1, -1)))), rtol=1e-6)
    assert (0.5 * (d + j)).__name__ == "0.5 * (dice_loss + jaccard_loss)"
    for bad in (lambda: d + 1.0, lambda: d * "x"):
        with pytest.raises(ValueError):
            bad()


# -- the fit loop -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def init():
    model = JaxUnetSeg(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))),
                         seed=1)
    rng = np.random.default_rng(4)
    data = [{"image": rng.random((N, HW, HW, 3), np.float32),
             "label": (rng.random((N, HW, HW, 1)) > 0.5).astype(np.float32)} for _ in range(2)]
    return model, variables, data


def _jax_state(init, tx):
    model, variables, _ = init
    return JaxTrainState.create_with_stats(apply_fn=model.apply, params=variables["params"],
                                           batch_stats=variables["batch_stats"], tx=tx)


def _port_state(init, tx):
    _, variables, _ = init
    port = UnetSeg("resnet18", decoder_channels=DEC, classes=1)
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"],
                                           encoder_name="resnet18"), strict=True)
    return create_train_state(port, tx, device="cpu", seed=0)


def _objects(side):
    return (side.DiceLoss(activation="sigmoid"),
            [side.IoU(activation="sigmoid"), side.Fscore(activation="sigmoid")],
            [side.Precision(activation="sigmoid"), side.Recall(activation="sigmoid")])


def _hold_logs(got, want, loss_rtol=1e-5, metric_atol=METRIC_ATOL):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    for k in set(got) - {"loss"}:
        np.testing.assert_allclose(got[k], want[k], atol=metric_atol, err_msg=k)


def test_fit_loop_under_sgd_matches_jax(init):
    model, variables, data = init
    loss, train_metrics, valid_metrics = _objects(jm)
    jstate = _jax_state(init, optax.sgd(0.01))
    jstate, want = jm.TrainEpoch(model.apply, loss, train_metrics).run(jstate, data)
    _, want_valid = jm.ValidEpoch(model.apply, loss, valid_metrics).run(jstate, data)

    loss, train_metrics, valid_metrics = _objects(tm)
    state = _port_state(init, SGDConfig(lambda step: 0.01, momentum=0.0, weight_decay=0.0))
    state, got = tm.TrainEpoch(None, loss, train_metrics).run(state, data)
    assert state.step == 2 and state.model.training
    _hold_logs(got, want)
    assert set(got) == {"loss", "iou_score", "fscore"}

    wanted = unetseg_from_flax(jstate.params, jstate.batch_stats, encoder_name="resnet18")
    have = state.model.state_dict()
    for name, w in wanted.items():
        if name.endswith("num_batches_tracked"):  # JAX keeps no such count
            continue
        w = w.numpy()
        np.testing.assert_allclose(have[name].numpy(), w,
                                   atol=PARAM_ATOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    _, got_valid = tm.ValidEpoch(None, loss, valid_metrics).run(state, data)
    assert not state.model.training and state.step == 2
    _hold_logs(got_valid, want_valid)
    assert set(got_valid) == {"loss", "precision", "recall"}


def test_fit_loop_takes_pair_and_single_image_batches_as_jax(init):
    """{"A", "B"} batches give the model both images, {"A"} one; here a model
    that sums its inputs' first channels, under ValidEpoch."""

    class Sum(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, *xs):
            return self.w * sum(x[:, :1] for x in xs)

    _, _, data = init
    pair = [{"A": d["image"], "B": d["image"][::-1].copy(), "label": d["label"]} for d in data]
    single = [{"A": d["image"], "label": d["label"]} for d in data]
    state = create_train_state(Sum(), SGDConfig(lambda s: 0.0), device="cpu")
    valid = tm.ValidEpoch(None, tm.MSELoss(), [tm.IoU()])
    for batches, n_inputs in ((pair, 2), (single, 1)):
        _, logs = valid.run(state, batches)
        want = np.mean([np.mean((sum(x[..., :1] for x in (
            [b["A"], b["B"]] if n_inputs == 2 else [b["A"]])) - b["label"]) ** 2)
            for b in batches])
        np.testing.assert_allclose(logs["loss"], want, rtol=1e-6)


def _adam_state_tensors(state):
    return [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()]


def test_tx_swap_adam_to_adam_keeps_moments_and_step(init):
    model, _, data = init
    loss, metrics, _ = _objects(jm)
    jstate = _jax_state(init, optax.adam(1e-3))
    jstate, _ = jm.TrainEpoch(model.apply, loss, metrics).run(jstate, data[:1])
    moments = jstate.opt_state
    jstate, want = jm.TrainEpoch(model.apply, loss, metrics, tx=optax.adam(1e-4)).run(
        jstate, data[1:])
    assert int(jstate.step) == 2 and int(jstate.opt_state[0].count) == 2
    assert jax.tree_util.tree_structure(moments) == jax.tree_util.tree_structure(
        jstate.opt_state)

    loss, metrics, _ = _objects(tm)
    state = _port_state(init, AdamConfig(lambda step: 1e-3))
    state, _ = tm.TrainEpoch(None, loss, metrics).run(state, data[:1])
    optimizer = state.optimizer
    state, got = tm.TrainEpoch(None, loss, metrics, tx=AdamConfig(lambda step: 1e-4)).run(
        state, data[1:])
    assert state.step == 2 and state.optimizer is optimizer
    assert state.optimizer.param_groups[0]["lr"] == 1e-4
    assert all(int(s["step"]) == 2 for s in state.optimizer.state.values())
    _hold_logs(got, want, loss_rtol=ADAM_RTOL)

    # the swap itself keeps the moments and takes the new hyperparameters
    before = _adam_state_tensors(state)
    tm.swap_optimizer(state, AdamConfig(lambda step: 1e-5, b1=0.8))
    assert state.optimizer is optimizer and state.step == 2
    after = _adam_state_tensors(state)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(before, after) for k in a)
    assert state.optimizer.param_groups[0]["betas"] == (0.8, 0.999)
    assert state.schedule(state.step) == 1e-5


class _Recorder:
    def __init__(self, schedule, seen):
        self.schedule, self.seen = schedule, seen

    def __call__(self, step):
        self.seen.append(step)
        return self.schedule(step)


def test_tx_swap_adam_to_sgd_starts_a_new_optimizer_and_keeps_the_step(init):
    model, _, data = init
    loss, metrics, _ = _objects(jm)
    sgd_rate = lambda step: 0.01 / (1 + step)  # noqa: E731
    jstate = _jax_state(init, optax.adam(1e-3))
    jstate, _ = jm.TrainEpoch(model.apply, loss, metrics).run(jstate, data[:1])
    jstate, want = jm.TrainEpoch(model.apply, loss, metrics, tx=optax.sgd(sgd_rate)).run(
        jstate, data)
    assert int(jstate.step) == 3

    loss, metrics, _ = _objects(tm)
    state = _port_state(init, AdamConfig(lambda step: 1e-3))
    state, _ = tm.TrainEpoch(None, loss, metrics).run(state, data[:1])
    seen = []
    sgd = SGDConfig(_Recorder(sgd_rate, seen), momentum=0.0, weight_decay=0.0)
    state, got = tm.TrainEpoch(None, loss, metrics, tx=sgd).run(state, data)
    assert isinstance(state.optimizer, torch.optim.SGD) and state.step == 3
    # the updates read the new optimizer's schedule from 0, as a fresh optax state does
    assert seen[-2:] == [0, 1]
    _hold_logs(got, want, loss_rtol=ADAM_RTOL)
    # a second swap to the same kind keeps the count its schedule reads
    tm.swap_optimizer(state, SGDConfig(_Recorder(sgd_rate, seen), momentum=0.0,
                                       weight_decay=0.0))
    state.apply_gradients()
    assert seen[-1] == 2


def test_train_epoch_dropout_draws_from_the_state_generator():
    """Two runs from one seed give the same logs and weights; TrainEpoch
    hands the state's generator to the model's dropouts."""
    from stcd_tpu_torch.layers.stochastic import Dropout

    def run():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 1, 1), Dropout(0.5))
        state = create_train_state(model, SGDConfig(lambda s: 0.1, momentum=0.0), device="cpu",
                                   seed=3)
        rng = np.random.default_rng(0)
        data = [{"image": rng.random((2, 8, 8, 3), np.float32),
                 "label": (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)}]
        state, logs = tm.TrainEpoch(None, tm.MSELoss(), []).run(state, data)
        assert model[1].generator is state.generator
        return logs, copy.deepcopy(model.state_dict())

    (l1, w1), (l2, w2) = run(), run()
    assert l1 == l2 and all(torch.equal(w1[k], w2[k]) for k in w1)
