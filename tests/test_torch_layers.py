"""stcd_tpu_torch layers and eval preprocessing against the JAX package:
BatchNorm (eval, and train-mode outputs plus running stats),
resize_bilinear (upsampling, both align_corners) and eval_preprocess."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stcd_tpu.data.augment import eval_preprocess as jax_eval_preprocess
from stcd_tpu.layers.modules import resize_bilinear as jax_resize
from stcd_tpu.layers.norm import BatchNorm as JaxBatchNorm
from stcd_tpu_torch.data.augment import eval_preprocess
from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.layers.norm import BatchNorm


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _bn_case(seed=0, c=6):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 4, c)) * 2 + 0.7).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    variables = {"params": {k: jnp.asarray(v) for k, v in p.items()},
                 "batch_stats": {k: jnp.asarray(v) for k, v in s.items()}}
    return x, bn, variables


def test_batchnorm_eval_matches_jax():
    x, bn, variables = _bn_case(0)
    want = np.asarray(JaxBatchNorm(use_running_average=True).apply(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = bn.eval()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_batchnorm_train_matches_jax_outputs_and_running_stats():
    x, bn, variables = _bn_case(1)
    want, upd = JaxBatchNorm(use_running_average=False, momentum=0.9).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    with torch.no_grad():
        got = bn.train()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    # the biased variance, as JAX (torch's BatchNorm2d would use n/(n-1))
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((5, 7), (13, 9)),
                                     ((2, 2), (8, 8))])
def test_resize_bilinear_upsampling_matches_jax(src, dst, align_corners):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, align_corners))
    got = resize_bilinear(_nchw(x), dst, align_corners).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_eval_preprocess_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 6, 5, 3))
    x = x.astype(np.uint8) if dtype == np.uint8 else (x / 255.0).astype(np.float32)
    want = np.asarray(jax_eval_preprocess(jnp.asarray(x)))
    got = eval_preprocess(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_batchnorm_train_gradients_match_jax(seed):
    """Autograd through the port's BatchNorm (var = E[x^2] - E[x]^2 clamped,
    x * w + b) gives JAX's gradients for the input, the scale and the bias;
    the in-place running update sits under no_grad and does not disturb it."""
    import jax

    x, bn, variables = _bn_case(seed)
    g = np.random.default_rng(seed + 10).standard_normal(x.shape).astype(np.float32)

    def loss(params, xj):
        y, _ = JaxBatchNorm(use_running_average=False, momentum=0.9).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xj,
            mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g)) + jnp.sum(y ** 2)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    y = bn.train()(xt)
    ((y * _nchw(g)).sum() + (y ** 2).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want_x),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(want_p["scale"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(want_p["bias"]),
                               atol=1e-4, rtol=1e-5)
    assert not bn.running_mean.requires_grad and int(bn.num_batches_tracked) == 1
