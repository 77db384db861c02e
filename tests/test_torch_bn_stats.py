"""stcd_tpu_torch/ops/bn_stats.py against stcd_tpu/ops/bn_stats.py.

The plain PyTorch bn_stats (what a CPU tensor takes) is held against the
Pallas kernel in interpret mode and against the jnp sums, forward and VJP, at
the shapes of tests/test_bn_stats.py, plus shapes the TPU tiling rules refuse
(a C that does not divide 128, an odd number of rows), which are held against
the jnp sums alone. The CUDA kernel is held against the plain version on the
card by chip_smoke.py.

Tolerances: float32 accumulation in another order, so rtol 1e-5 with atol
1e-4 * sqrt(rows), as the JAX test; the VJP in float32 to 1e-6. In bfloat16
the VJP is held to rtol 1e-2 with atol 2e-2, wider than the 1e-2 of the JAX
test: on the CPU XLA's bf16 VJP is itself up to 1.3e-2 off the float64 value
where g1 and 2 x g2 cancel (both JAX paths alike). The port's VJP is also
held against float64 directly, to one bf16 rounding of the result."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.ops.bn_stats import bn_stats_pallas, supports_pallas
from stcd_tpu_torch.ops.bn_stats import bn_stats, bn_stats_kernel, bn_stats_plain

TPU_SHAPES = [(8, 16, 16, 256), (8, 16, 16, 64), (4, 32, 32, 16), (2, 8, 8, 128)]
OTHER_SHAPES = [(3, 7, 5, 80), (7, 13, 24), (1001, 3)]


def _jnp_stats(x):
    xf = x.astype(jnp.float32)
    axes = tuple(range(x.ndim - 1))
    return jnp.sum(xf, axes), jnp.sum(jnp.square(xf), axes)


def _input(shape, dtype, seed=0):
    """The same values for both sides: numpy float32, rounded to bf16 if asked."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), jnp.asarray(x)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", TPU_SHAPES + OTHER_SHAPES)
def test_forward_matches_jax(shape, dtype):
    tx, jx = _input(shape, dtype)
    with torch.no_grad():
        s1, s2 = bn_stats(tx)
    assert s1.dtype == s2.dtype == torch.float32
    assert s1.shape == s2.shape == (shape[-1],)
    rows = tx.numel() // shape[-1]
    wants = [_jnp_stats(jx)]
    if shape in TPU_SHAPES:
        assert supports_pallas(shape)
        wants.append(bn_stats_pallas(jx, interpret=True))
    for r1, r2 in wants:
        np.testing.assert_allclose(s1.numpy(), np.asarray(r1), rtol=1e-5,
                                   atol=1e-4 * rows ** 0.5)
        np.testing.assert_allclose(s2.numpy(), np.asarray(r2), rtol=1e-5,
                                   atol=1e-4 * rows ** 0.5)


@pytest.mark.parametrize("dtype,rtol,atol", [("bfloat16", 1e-2, 2e-2),
                                             ("float32", 1e-6, 1e-6)])
@pytest.mark.parametrize("shape", [(4, 8, 8, 64), (3, 5, 80)])
def test_vjp_matches_jax(shape, dtype, rtol, atol):
    tx, jx = _input(shape, dtype, seed=1)
    rng = np.random.default_rng(2)
    g1, g2 = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))

    def scalar(stats):
        return lambda x: jnp.sum(stats(x)[0] * g1) + jnp.sum(stats(x)[1] * g2)

    wants = [jax.grad(scalar(_jnp_stats))(jx)]
    if supports_pallas(shape):
        wants.append(jax.grad(scalar(lambda x: bn_stats_pallas(x, interpret=True)))(jx))
    tx.requires_grad_()
    s1, s2 = bn_stats(tx)
    ((s1 * torch.from_numpy(g1)).sum() + (s2 * torch.from_numpy(g2)).sum()).backward()
    assert tx.grad.dtype == tx.dtype
    for want in wants:
        np.testing.assert_allclose(tx.grad.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), rtol=rtol,
                                   atol=atol)
    # float64: one rounding to x's dtype, after float32 arithmetic on the two terms
    term = 2.0 * tx.detach().double().numpy() * g2
    exact = g1.astype(np.float64) + term
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23
    allowed = ulp * np.abs(exact) + 2.0 ** -22 * (np.abs(g1) + np.abs(term))
    assert np.all(np.abs(tx.grad.double().numpy() - exact) <= allowed)


def test_cpu_tensor_dispatches_to_plain_and_kernel_raises():
    x = torch.randn(4, 6, 10)
    before = bn_stats_kernel.kernel_launches
    got, want = bn_stats(x), bn_stats_plain(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bn_stats_kernel.kernel_launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        bn_stats(x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        bn_stats(x, impl="pallas")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn_stats(x.double())
    with pytest.raises(ValueError, match="channels-last"):
        bn_stats(torch.randn(5))
