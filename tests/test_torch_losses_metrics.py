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


def _logits_and_target(seed, n=2, c=3, hw=8, target_hw=None):
    rng = np.random.default_rng(seed)
    target_hw = target_hw or hw
    logits = rng.standard_normal((n, hw, hw, c)).astype(np.float32) * 2
    target = rng.integers(0, c, (n, target_hw, target_hw)).astype(np.int32)
    target.reshape(-1)[::7] = 255  # ignored pixels
    return logits, target


@pytest.mark.parametrize("case", ["plain", "weights", "resized", "resized_weights",
                                  "channel_axis_target", "all_ignored"])
def test_cross_entropy_value_and_gradient_match_jax(case):
    """NCHW logits in the port, NHWC in JAX; atol 1e-6 on the value and 1e-7
    on the gradient of a mean loss; 1e-5 and 1e-6 where the logits are first
    resized bilinearly (align_corners=True, another summation order)."""
    resized = case.startswith("resized")
    logits, target = _logits_and_target(3, target_hw=16 if resized else None)
    weight = np.array([0.2, 1.0, 2.5], np.float32) if "weights" in case else None
    if case == "all_ignored":
        target[:] = 255
    jt = jnp.asarray(target)[..., None] if case == "channel_axis_target" else jnp.asarray(target)
    want, want_grad = jax.value_and_grad(jloss.cross_entropy)(
        jnp.asarray(logits), jt, None if weight is None else jnp.asarray(weight))
    x = torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2))).requires_grad_()
    tt = torch.from_numpy(target)
    if case == "channel_axis_target":
        tt = tt[:, None]
    got = tloss.cross_entropy(x, tt, None if weight is None else torch.from_numpy(weight))
    got.backward()
    vtol, gtol = (1e-5, 1e-6) if resized else (1e-6, 1e-7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=vtol, rtol=vtol)
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want_grad),
                               atol=gtol)
    if case == "all_ignored":
        assert got.item() == 0.0


def test_cross_entropy_takes_bf16_logits_in_float32():
    logits, target = _logits_and_target(4)
    x = torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))
    got = tloss.cross_entropy(x.to(torch.bfloat16), torch.from_numpy(target))
    want = tloss.cross_entropy(x.to(torch.bfloat16).float(), torch.from_numpy(target))
    assert got.dtype == torch.float32 and got.item() == want.item()


def _logits_and_ids(seed, classes=3, ignore=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2, 6, 5, classes)).astype(np.float32)  # NHWC, as JAX takes it
    target = rng.integers(0, classes, (2, 6, 5))
    if ignore:  # ids outside [0, classes): the 255 ignore id and a negative one
        target[0, 0, :3] = 255
        target[1, 2, 1] = -1
    return logits, target.astype(np.int64)


def _nchw_leaf(logits):
    return torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous().requires_grad_()


def _hold_value_and_grad(got, leaf, want, want_grad):
    got.backward()
    assert got.dtype == torch.float32 and torch.isfinite(leaf.grad).all()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(leaf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grad),
                               atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("case", ["plain", "ignore_ids", "float_alpha", "array_alpha",
                                  "no_smooth_gamma2", "probabilities"])
def test_focal_loss_value_and_gradient_match_jax(case):
    """The port takes NCHW logits where JAX takes NHWC. Ids outside [0, C)
    fold to class 0 on both sides; a float alpha sits on balance_index, an
    array alpha is normalised and inverted."""
    logits, target = _logits_and_ids(3, ignore=case == "ignore_ids")
    kw = {"plain": {}, "ignore_ids": {"gamma": 2.0},
          "float_alpha": {"alpha": 0.25, "balance_index": 1, "gamma": 2.0},
          "array_alpha": {"alpha": [5.0, 1.0, 2.0]},
          "no_smooth_gamma2": {"smooth": 0.0, "gamma": 2.0},
          "probabilities": {"apply_nonlin": False}}[case]
    if case == "probabilities":
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jkw = {k: (jnp.asarray(v) if k == "alpha" else v) for k, v in kw.items()}
    want, want_grad = jax.value_and_grad(
        lambda x: jloss.focal_loss(x, jnp.asarray(target), **jkw))(jnp.asarray(logits))
    leaf = _nchw_leaf(logits)
    _hold_value_and_grad(tloss.focal_loss(leaf, torch.from_numpy(target), **kw), leaf,
                         want, want_grad)


@pytest.mark.parametrize("name,kw", [("miou_loss", {}), ("miou_loss", {"weight": [0.3, 0.7, 1.5]}),
                                     ("mmiou_loss", {})], ids=["miou", "miou_weighted", "mmiou"])
@pytest.mark.parametrize("ignore", [False, True], ids=["ids_in_range", "ignore_ids"])
def test_soft_iou_losses_match_jax(name, kw, ignore):
    """An id outside [0, C) has an all-zero one-hot row on both sides: it
    adds its probabilities to the union and nothing to the intersection."""
    logits, target = _logits_and_ids(4, ignore=ignore)
    want, want_grad = jax.value_and_grad(
        lambda x: getattr(jloss, name)(x, jnp.asarray(target), n_classes=3, **kw))(
            jnp.asarray(logits))
    leaf = _nchw_leaf(logits)
    got = getattr(tloss, name)(leaf, torch.from_numpy(target), n_classes=3, **kw)
    _hold_value_and_grad(got, leaf, want, want_grad)


@pytest.mark.parametrize("case", ["mixed", "all_agree", "all_disagree"])
def test_contrastive_loss_matches_jax(case):
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.01, 0.99, (4, 8, 8, 1)).astype(np.float32)
    first = (rng.uniform(size=(2, 8, 8, 1)) > 0.6).astype(np.float32)
    second = {"mixed": (rng.uniform(size=first.shape) > 0.6).astype(np.float32),
              "all_agree": first, "all_disagree": 1.0 - first}[case]
    want, want_grad = jax.value_and_grad(jloss.contrastive_loss)(
        jnp.asarray(pred), jnp.asarray(first), jnp.asarray(second))
    leaf = torch.from_numpy(pred).requires_grad_()
    got = tloss.contrastive_loss(leaf, torch.from_numpy(first), torch.from_numpy(second))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=1e-4)
    # the layout does not matter: the same numbers as NCHW give the same loss
    nchw = tloss.contrastive_loss(torch.from_numpy(pred).permute(0, 3, 1, 2),
                                  torch.from_numpy(first).permute(0, 3, 1, 2),
                                  torch.from_numpy(second).permute(0, 3, 1, 2))
    assert nchw.item() == pytest.approx(got.item(), abs=1e-7)


def test_get_alpha_matches_jax_on_arrays_and_tensors():
    rng = np.random.default_rng(6)
    labels = [rng.integers(0, 2, (2, 8, 8, 1)), rng.integers(0, 4, (2, 8, 8, 1))]
    labels[0][0, 0, :4] = 255  # folds into class 0
    want = jloss.get_alpha([{"label": lab} for lab in labels])
    got = tloss.get_alpha([{"label": torch.from_numpy(labels[0])}, {"L": labels[1]}])
    assert got.dtype == np.float64 and got.shape == (4,)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2 * 2 * 8 * 8


@pytest.mark.parametrize("loss", ["fl", "miou", "mmiou"])
def test_trainer_loss_dispatch_matches_the_jax_formulas(loss):
    """CDTrainer._pxl_loss with the class losses: focal with gamma 2 and the
    class counts as alpha, mIoU weighed by 1 - frequency, mmIoU; multi-scale
    with a nearest-downsampled label."""
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    rng = np.random.default_rng(7)
    full = rng.normal(0, 2, (2, 8, 8, 2)).astype(np.float32)
    half = rng.normal(0, 2, (2, 4, 4, 2)).astype(np.float32)
    gt = rng.integers(0, 2, (2, 8, 8, 1)).astype(np.float32)
    alpha = np.array([300.0, 84.0])
    cfg = TrainerConfig(net_G="base_resnet18", n_class=2, loss=loss, multi_scale_train=True,
                        multi_pred_weights=(0.5, 1.0))
    trainer = CDTrainer(cfg, alpha=alpha)
    got = trainer._pxl_loss([torch.from_numpy(half).permute(0, 3, 1, 2),
                             torch.from_numpy(full).permute(0, 3, 1, 2)],
                            torch.from_numpy(gt).permute(0, 3, 1, 2))

    def jax_one(pred, g):
        if loss == "fl":
            return jloss.focal_loss(pred, g[..., 0], alpha=alpha, gamma=2.0, smooth=1e-5)
        if loss == "miou":
            return jloss.miou_loss(pred, g[..., 0], weight=1.0 - alpha / alpha.sum(),
                                   n_classes=2)
        return jloss.mmiou_loss(pred, g[..., 0], n_classes=2)

    want = (0.5 * jax_one(jnp.asarray(half), jnp.asarray(gt)[:, ::2, ::2])
            + 1.0 * jax_one(jnp.asarray(full), jnp.asarray(gt)))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-5)
    if loss == "miou":
        with pytest.raises(ValueError, match="get_alpha"):
            CDTrainer(cfg)._pxl_loss([torch.from_numpy(full).permute(0, 3, 1, 2)],
                                     torch.from_numpy(gt).permute(0, 3, 1, 2))
