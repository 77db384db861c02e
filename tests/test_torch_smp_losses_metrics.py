"""stcd_tpu_torch's smp losses (losses/smp.py) and functional metrics
(metrics/functional.py) against the JAX package's, on the CPU, in float32.

The port is NCHW and the JAX package channel-last: the tests transpose the
same numpy inputs (made from a seed) for JAX and transpose JAX's gradients
back. Held to: loss values within 1e-5 relative (LOSS_RTOL, atol 1e-6),
gradients within GRAD_ATOL + 1e-4 relative per element (the sums run in
another order), get_stats counts exactly, metrics within 1e-6 relative.
The Lovasz losses sort the errors; the logits are continuous draws, so no
two errors tie and both sides sort alike."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.losses import smp as jsmp
from stcd_tpu.metrics import functional as jmf
from stcd_tpu_torch.losses import smp as tsmp
from stcd_tpu_torch.metrics import functional as tmf

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-7
N, C, HW = 2, 3, 8


def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits1 = rng.standard_normal((N, 1, HW, HW)).astype(np.float32) * 2
    logits = rng.standard_normal((N, C, HW, HW)).astype(np.float32) * 2
    return {
        "binary": (logits1, (rng.random((N, 1, HW, HW)) > 0.5).astype(np.float32)),
        "multiclass": (logits, rng.integers(0, C, (N, HW, HW)).astype(np.int64)),
        "multilabel": (logits, (rng.random((N, C, HW, HW)) > 0.5).astype(np.float32)),
    }


DATA = _data()


def _to_jax(mode, logits, target):
    if mode == "multiclass":
        return jnp.asarray(_nhwc(logits)), jnp.asarray(target)
    return jnp.asarray(_nhwc(logits)), jnp.asarray(_nhwc(target))


def _with_ignored(mode, target, value=-1):
    """A copy of ``target`` with every 5th pixel set to ``value``."""
    target = target.copy()
    flat = target.reshape(-1)
    flat[::5] = value
    return target


# (loss class, mode, keywords, target edit): every loss in every mode it has, and its options
LOSS_CASES = [
    ("DiceLoss", "binary", {}, None),
    ("DiceLoss", "multiclass", {}, None),
    ("DiceLoss", "multilabel", {}, None),
    ("DiceLoss", "binary", {"log_loss": True, "smooth": 0.5}, None),
    ("DiceLoss", "multiclass", {"classes": [0, 2], "log_loss": True}, None),
    ("DiceLoss", "binary", {"ignore_index": -1}, "ignore"),
    ("DiceLoss", "multiclass", {"ignore_index": -1}, "ignore"),
    ("DiceLoss", "multilabel", {"ignore_index": -1}, "ignore"),
    ("DiceLoss", "multiclass", {}, "absent"),
    ("JaccardLoss", "binary", {}, None),
    ("JaccardLoss", "multiclass", {}, None),
    ("JaccardLoss", "multilabel", {"log_loss": True, "smooth": 1.0}, None),
    ("TverskyLoss", "binary", {"alpha": 0.3, "beta": 0.7}, None),
    ("TverskyLoss", "multiclass", {"alpha": 0.7, "beta": 0.3, "gamma": 1.5}, None),
    ("TverskyLoss", "multilabel", {"gamma": 2.0}, None),
    ("FocalLoss", "binary", {}, None),
    ("FocalLoss", "multiclass", {"alpha": 0.25}, None),
    ("FocalLoss", "multilabel", {"gamma": 3.0}, None),
    ("FocalLoss", "binary", {"reduced_threshold": 0.5}, None),
    ("FocalLoss", "binary", {"normalized": True, "alpha": 0.25}, None),
    ("FocalLoss", "binary", {"ignore_index": -1, "reduction": "sum"}, "ignore"),
    ("FocalLoss", "multiclass", {"ignore_index": -1}, "ignore"),
    ("LovaszLoss", "binary", {}, None),
    ("LovaszLoss", "multilabel", {}, None),
    ("LovaszLoss", "multiclass", {}, None),
    ("LovaszLoss", "multiclass", {}, "absent"),
    ("LovaszLoss", "multiclass", {"from_logits": False}, "probs"),
]


def _case_inputs(mode, edit):
    logits, target = DATA[mode]
    if edit == "ignore":
        target = _with_ignored(mode, target)
    elif edit == "absent":  # class 1 appears nowhere
        target = np.where(target == 1, 2, target)
    elif edit == "probs":
        e = np.exp(logits - logits.max(1, keepdims=True))
        logits = (e / e.sum(1, keepdims=True)).astype(np.float32)
    return logits, target


def _value_and_grad(jloss, tloss, mode, logits, target):
    jl, jt = _to_jax(mode, logits, target)
    want, want_grad = jax.value_and_grad(lambda x: jloss(x, jt))(jl)
    x = torch.from_numpy(logits.copy()).requires_grad_()
    got = tloss(x, torch.from_numpy(target))
    got.backward()
    return got, x.grad, want, np.moveaxis(np.asarray(want_grad), -1, 1)


def _hold(got, grad, want, want_grad):
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(grad.numpy(), want_grad, atol=GRAD_ATOL, rtol=1e-4)


@pytest.mark.parametrize("name,mode,kwargs,edit", LOSS_CASES,
                         ids=[f"{n}-{m}-{i}" for i, (n, m, _, _) in enumerate(LOSS_CASES)])
def test_loss_value_and_gradient_match_jax(name, mode, kwargs, edit):
    logits, target = _case_inputs(mode, edit)
    jloss = getattr(jsmp, name)(mode=mode, **kwargs)
    tloss = getattr(tsmp, name)(mode=mode, **kwargs)
    _hold(*_value_and_grad(jloss, tloss, mode, logits, target))


@pytest.mark.parametrize("kwargs,edit", [
    ({}, None), ({"smooth_factor": 0.1}, None), ({"pos_weight": 2.0}, None),
    ({"ignore_index": -1}, "ignore"), ({"reduction": "sum", "weight": 0.5}, None)])
def test_soft_bce_matches_jax(kwargs, edit):
    logits, target = _case_inputs("multilabel", edit)
    _hold(*_value_and_grad(jsmp.SoftBCEWithLogitsLoss(**kwargs),
                           tsmp.SoftBCEWithLogitsLoss(**kwargs), "multilabel", logits, target))


@pytest.mark.parametrize("kwargs,edit", [
    ({}, None), ({"smooth_factor": 0.1}, None), ({"ignore_index": -1}, "ignore"),
    ({"ignore_index": -1, "smooth_factor": 0.2, "reduction": "sum"}, "ignore")])
def test_soft_ce_matches_jax(kwargs, edit):
    logits, target = _case_inputs("multiclass", edit)
    _hold(*_value_and_grad(jsmp.SoftCrossEntropyLoss(**kwargs),
                           tsmp.SoftCrossEntropyLoss(**kwargs), "multiclass", logits, target))


def test_mcc_loss_matches_jax():
    logits, target = DATA["binary"]
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    _hold(*_value_and_grad(jsmp.MCCLoss(), tsmp.MCCLoss(), "binary", probs, target))


def test_elementwise_reductions_match_jax_in_layout():
    """reduction='none' returns the elements: SoftBCE in the input's layout,
    binary focal flat in (N, H, W) order on both sides."""
    logits, target = DATA["multilabel"]
    jl, jt = _to_jax("multilabel", logits, target)
    got = tsmp.SoftBCEWithLogitsLoss(reduction="none")(torch.from_numpy(logits),
                                                        torch.from_numpy(target))
    want = jsmp.SoftBCEWithLogitsLoss(reduction="none")(jl, jt)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=1e-6)
    logits, target = DATA["binary"]
    jl, jt = _to_jax("binary", logits, target)
    got = tsmp.FocalLoss("binary", reduction="none")(torch.from_numpy(logits),
                                                     torch.from_numpy(target[:, 0]))
    want = jsmp.FocalLoss("binary", reduction="none")(jl, jt[..., 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_binary_target_without_channel_and_mode_constants():
    logits, target = DATA["binary"]
    x = torch.from_numpy(logits)
    for name in ("DiceLoss", "JaccardLoss", "TverskyLoss", "FocalLoss"):
        loss = getattr(tsmp, name)(mode=tsmp.BINARY_MODE)
        assert torch.allclose(loss(x, torch.from_numpy(target[:, 0])),
                              loss(x, torch.from_numpy(target)))
    assert (tsmp.BINARY_MODE, tsmp.MULTICLASS_MODE, tsmp.MULTILABEL_MODE) == (
        jsmp.BINARY_MODE, jsmp.MULTICLASS_MODE, jsmp.MULTILABEL_MODE)
    with pytest.raises(ValueError):
        tsmp.DiceLoss(mode="other")(x, torch.from_numpy(target))


def test_focal_loss_with_logits_matches_jax():
    logits, target = DATA["binary"]
    for kw in ({}, {"alpha": None, "gamma": 0.0}, {"reduced_threshold": 0.3, "normalized": True},
               {"reduction": "sum"}):
        want = jsmp.focal_loss_with_logits(jnp.asarray(logits.reshape(-1)),
                                           jnp.asarray(target.reshape(-1)), **kw)
        got = tsmp.focal_loss_with_logits(torch.from_numpy(logits.reshape(-1)),
                                          torch.from_numpy(target.reshape(-1)), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


# -- get_stats and the metrics ------------------------------------------------------------


def _stats_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "binary": (rng.random((3, 1, 6, 5)).astype(np.float32),
                   rng.integers(0, 2, (3, 1, 6, 5))),
        "multilabel": (rng.random((3, 4, 6, 5)).astype(np.float32),
                       rng.integers(0, 2, (3, 4, 6, 5))),
        "multiclass": (rng.integers(0, 4, (3, 6, 5)), rng.integers(0, 4, (3, 6, 5))),
    }


STATS = _stats_inputs()


@pytest.mark.parametrize("mode,kw", [
    ("binary", {"threshold": 0.5}), ("multilabel", {"threshold": 0.3}),
    ("multiclass", {"num_classes": 4}), ("multiclass", {"num_classes": 4, "ignore_index": -1}),
    ("multiclass", {"num_classes": 3, "ignore_index": 3}),
    ("binary", {}),
])
def test_get_stats_counts_equal_jax(mode, kw):
    output, target = STATS[mode]
    if "ignore_index" in kw:
        target = _with_ignored(mode, target, kw["ignore_index"])
    if mode == "binary" and "threshold" not in kw:
        output = (output > 0.5).astype(np.int64)
    if mode == "multiclass":
        jo, jt = jnp.asarray(output), jnp.asarray(target)
    else:
        jo, jt = jnp.asarray(_nhwc(output)), jnp.asarray(_nhwc(target))
    want = jmf.get_stats(jo, jt, mode, **kw)
    got = tmf.get_stats(torch.from_numpy(output), torch.from_numpy(target), mode, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.long
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(int(x.min()) >= 0 for x in got)


def test_get_stats_thresholds_the_target_too_and_validates_as_jax():
    out = torch.tensor([[[[0.2, 0.8]]]])
    got = tmf.get_stats(out, torch.tensor([[[[0, 255]]]]), "binary", threshold=0.5)
    assert [int(x) for x in got] == [1, 0, 0, 1]
    bad = [
        (out, torch.tensor([[[[0.0, 1.0]]]]), "binary", {"threshold": 0.5}),  # float target
        (out, torch.tensor([[[[0, 1]]]]), "binary", {}),  # float output without threshold
        (out, torch.tensor([[[[0, 1]]]]), "multiclass", {"num_classes": 2}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), "other", {}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), "multiclass",
         {"num_classes": 2, "threshold": 0.5}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1, 1]]), "binary", {}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), "binary", {"ignore_index": 3}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), "multiclass", {}),
        (torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), "multiclass",
         {"num_classes": 2, "ignore_index": 1}),
    ]
    for output, target, mode, kw in bad:
        with pytest.raises(ValueError) as got:
            tmf.get_stats(output, target, mode, **kw)
        jo, jt = jnp.asarray(output.numpy()), jnp.asarray(target.numpy())
        with pytest.raises(ValueError) as want:
            jmf.get_stats(jo, jt, mode, **kw)
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]


METRICS = ("fbeta_score", "f1_score", "iou_score", "accuracy", "sensitivity", "recall",
           "specificity", "balanced_accuracy", "positive_predictive_value", "precision",
           "negative_predictive_value", "false_negative_rate", "false_positive_rate",
           "false_discovery_rate", "false_omission_rate", "positive_likelihood_ratio",
           "negative_likelihood_ratio")
REDUCTIONS = ("micro", "macro", "weighted", "micro-imagewise", "macro-imagewise",
              "weighted-imagewise", "none")
WEIGHTS = [0.2, 0.3, 0.1, 0.4]


def _stats_pair(seed=2, zero_class=False):
    rng = np.random.default_rng(seed)
    stats = [rng.integers(0, 20, (3, 4)) for _ in range(4)]
    if zero_class:  # class 2 has no positives and no predictions: 0/0 in several metrics
        for s in stats[:3]:
            s[:, 2] = 0
    return ([jnp.asarray(s, jnp.int32) for s in stats], [torch.from_numpy(s) for s in stats])


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_every_metric_and_reduction_matches_jax(reduction):
    jstats, tstats = _stats_pair()
    kw = {"class_weights": WEIGHTS} if "weighted" in reduction else {}
    for name in METRICS:
        want = getattr(jmf, name)(*jstats, reduction=reduction, **kw)
        got = getattr(tmf, name)(*tstats, reduction=reduction, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    got = tmf.fbeta_score(*tstats, beta=2.0, reduction=reduction, **kw)
    want = jmf.fbeta_score(*jstats, beta=2.0, reduction=reduction, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("zero_division", ["warn", 0, 1.0])
@pytest.mark.parametrize("reduction", ["macro", "macro-imagewise", "none", "micro-imagewise"])
def test_zero_division_matches_jax(zero_division, reduction):
    jstats, tstats = _stats_pair(zero_class=True)
    for name in ("iou_score", "precision", "recall", "f1_score"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = getattr(tmf, name)(*tstats, reduction=reduction, zero_division=zero_division)
        want = getattr(jmf, name)(*jstats, reduction=reduction, zero_division=zero_division)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, err_msg=name)
        assert np.isfinite(got.numpy()).all()
        if zero_division == "warn" and reduction != "micro-imagewise":
            assert any("Zero division" in str(w.message) for w in caught), name


def test_micro_propagates_nan_class_weights_scale_macro_and_weighted_needs_weights():
    zero = [torch.zeros(2, 3, dtype=torch.long) for _ in range(4)]
    assert torch.isnan(tmf.iou_score(*zero, reduction="micro"))
    assert bool(jnp.isnan(jmf.iou_score(*(jnp.zeros((2, 3), jnp.int32),) * 4,
                                        reduction="micro")))
    jstats, tstats = _stats_pair()
    got = tmf.iou_score(*tstats, reduction="macro", class_weights=WEIGHTS)
    want = jmf.iou_score(*jstats, reduction="macro", class_weights=WEIGHTS)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert not np.isclose(got.item(), tmf.iou_score(*tstats, reduction="macro").item())
    for reduction in ("weighted", "weighted-imagewise"):
        with pytest.raises(ValueError, match="Class weights"):
            tmf.iou_score(*tstats, reduction=reduction)
    with pytest.raises(ValueError, match="unknown reduction"):
        tmf.iou_score(*tstats, reduction="mean")
