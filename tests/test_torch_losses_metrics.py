"""stcd_tpu_torch's losses, confusion counts and schedules against the JAX
package, on inputs made with numpy from a seed. Values and gradients in
float32: atol 1e-6 on values, 1e-7 on per-element gradients of a mean loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.losses import functional as jloss
from stcd_tpu.metrics import confusion as jconf
from stcd_tpu.train import schedules as jsched
from stcd_tpu_torch.losses import functional as tloss
from stcd_tpu_torch.metrics import confusion as tconf
from stcd_tpu_torch.train import schedules as tsched


def _probs_and_target(seed, saturated):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.01, 0.99, (2, 8, 8, 1)).astype(np.float32)
    target = (rng.uniform(size=probs.shape) > 0.7).astype(np.float32)
    if saturated:  # exactly 0 and 1, on both sides of the target
        probs.reshape(-1)[:8] = [0, 0, 1, 1, 0, 1, 0, 1]
        target.reshape(-1)[:8] = [0, 1, 0, 1, 0, 1, 1, 0]
    return probs, target


@pytest.mark.parametrize("name", ["bce_loss", "dice_loss", "bce_dice", "cd_loss"])
@pytest.mark.parametrize("saturated", [False, True], ids=["inside", "saturated"])
def test_loss_value_and_gradient_match_jax(name, saturated):
    probs, target = _probs_and_target(0, saturated)
    want, want_grad = jax.value_and_grad(getattr(jloss, name))(jnp.asarray(probs),
                                                               jnp.asarray(target))
    p = torch.from_numpy(probs).requires_grad_()
    got = getattr(tloss, name)(p, torch.from_numpy(target))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=1e-5)


def test_bce_clamps_at_minus_100_with_zero_gradient():
    p = torch.tensor([0.0, 1.0], requires_grad=True)
    loss = tloss.bce_loss(p, torch.tensor([1.0, 0.0]))
    loss.backward()
    assert loss.item() == pytest.approx(100.0)
    assert torch.equal(p.grad, torch.zeros(2))
    # bf16 probabilities are taken to float32 first
    assert tloss.bce_dice(torch.tensor([0.25, 0.75]).bfloat16(),
                          torch.tensor([0, 1])).dtype == torch.float32


def test_confusion_matrix_matches_jax_and_a_hand_count():
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 2, (3, 16, 16, 1))
    label = rng.integers(0, 2, (3, 16, 16, 1))
    got = tconf.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label))
    want = jconf.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 2)
    assert got.shape == (2, 2) and not got.is_floating_point()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hand = [[int(((label == i) & (pred == j)).sum()) for j in (0, 1)] for i in (0, 1)]
    assert got.tolist() == hand  # rows = label, cols = pred
    # bool predictions (probs > 0.5), float labels, 3 classes, an absent class
    got = tconf.confusion_matrix(torch.tensor([True, False, True]),
                                 torch.tensor([1.0, 1.0, 0.0]))
    assert got.tolist() == [[0, 1], [1, 1]]
    got3 = tconf.confusion_matrix(torch.tensor([0, 1, 1]), torch.tensor([0, 0, 1]), 3)
    assert got3.tolist() == [[1, 1, 0], [0, 1, 0], [0, 0, 0]]


def test_segmentation_metric_methods_match_jax():
    rng = np.random.default_rng(2)
    tm, jm = tconf.SegmentationMetric(2), jconf.SegmentationMetric(2)
    for _ in range(3):
        pred = rng.integers(0, 2, (2, 12, 12))
        label = rng.integers(0, 2, (2, 12, 12))
        tm.addBatch(torch.from_numpy(pred), torch.from_numpy(label))
        jm.addBatch(pred, label)
    assert tm.getConfusionMatrix().dtype == np.float64
    np.testing.assert_array_equal(tm.getConfusionMatrix(), jm.getConfusionMatrix())
    for method in ("OverallAccuracy", "Precision", "Recall", "F1score",
                   "IntersectionOverUnion", "meanIntersectionOverUnion",
                   "Frequency_Weighted_Intersection_over_Union"):
        np.testing.assert_allclose(getattr(tm, method)(), getattr(jm, method)(),
                                   rtol=1e-12, err_msg=method)
    tm.reset()
    assert tm.getConfusionMatrix().sum() == 0


SCHEDULES = {
    "poly": (lambda m: m.poly_schedule(1e-3, 3, 10), 30),
    "poly_warmup": (lambda m: m.poly_schedule(1e-3, 4, 10, warmup_epochs=1), 40),
    "linear": (lambda m: m.get_scheduler("linear", 2e-3, 10, max_epochs=4), 40),
    "step": (lambda m: m.get_scheduler("step", 1e-3, 5, lr_decay_iters=2), 40),
    "exponential": (lambda m: m.get_scheduler("exponential", 1e-3, 7), 35),
    "poly_by_key": (lambda m: m.get_scheduler("poly", 1e-3, 10, max_epochs=3), 30),
    "constant": (lambda m: m.get_scheduler(None, 5e-4, 10), 20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    make, total = SCHEDULES[name]
    got, want = make(tsched), make(jsched)
    for step in (0, 1, 5, total // 2, total - 1, total, total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-6, atol=1e-12,
                                   err_msg=f"{name} at step {step}")
    assert isinstance(got(1), float)


def test_schedule_rejects_unknown_policy_and_poly_starts_at_base():
    with pytest.raises(NotImplementedError, match="cosine"):
        tsched.get_scheduler("cosine", 1e-3, 10)
    sched = tsched.poly_schedule(1e-3, 60, 1000)
    assert sched(0) == 1e-3  # step 0 uses the base rate
    assert sched(1) == pytest.approx(1e-3 * (1 - 1 / 60000) ** 0.9)
