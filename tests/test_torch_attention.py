"""stcd_tpu_torch/ops/attention.py against stcd_tpu/ops/attention.py.

The plain PyTorch cross_attention is held against the JAX einsum path and
against the Pallas kernel in interpret mode, with and without dropout, at
atol 2e-5 (the tolerance of tests/test_ops.py); the dropout hash is held
bit for bit. Autograd through the plain version is held against jax.grad
through the Pallas backward kernel (interpret mode) and the einsum path at
atol 1e-5. The CUDA kernels themselves are held against the plain version on
the card by chip_smoke.py (this suite imports JAX, which the card's machine
does not have)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.ops.attention import (_einsum_attention, cross_attention_interpret,
                                    dropout_keep_mask as jax_keep_mask)
from stcd_tpu_torch.ops.attention import (cross_attention, cross_attention_kernel,
                                          dropout_keep_mask)

SEED = 0xC0FFEE42


def _qkv(n, m, d, seed=0, b=2, h=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, n, d), (b, h, m, d), (b, h, m, d)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,m,d", [(128, 16, 32), (100, 37, 80), (64, 64, 64),
                                   (33, 5, 16)])
def test_plain_matches_jax(n, m, d, rate):
    q, k, v = _qkv(n, m, d, seed=n + m + d)
    scale = d ** -0.5
    seed = SEED if rate else None
    with torch.no_grad():
        got = cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale, dropout_rate=rate,
                              dropout_seed=seed).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_einsum = np.asarray(_einsum_attention(jq, jk, jv, scale, rate, seed))
    want_kernel = np.asarray(cross_attention_interpret(
        jq, jk, jv, scale, dropout_rate=rate, dropout_seed=seed))
    np.testing.assert_allclose(got, want_einsum, atol=2e-5)
    np.testing.assert_allclose(got, want_kernel, atol=2e-5)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_dropout_keep_mask_bit_identical(seed, rate):
    bh = np.arange(6, dtype=np.int32).reshape(6, 1, 1)
    rows = np.arange(0, 4100, 41, dtype=np.int32).reshape(1, -1, 1)
    cols = np.arange(70, dtype=np.int32).reshape(1, 1, 70)
    want = np.asarray(jax_keep_mask(jnp.uint32(seed), jnp.asarray(bh),
                                    jnp.asarray(rows), jnp.asarray(cols), rate))
    got = dropout_keep_mask(seed, torch.from_numpy(bh), torch.from_numpy(rows),
                            torch.from_numpy(cols), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_cpu_tensor_dispatches_to_plain_and_kernel_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 8))
    before = cross_attention_kernel.kernel_launches
    with torch.no_grad():
        out = cross_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert cross_attention_kernel.kernel_launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        cross_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="dropout_seed"):
        cross_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="impl"):
        cross_attention(q, k, v, impl="einsum")


GRAD_CASES = [  # (n, m, d, rate, scale): the shapes the train steps bring
    (128, 16, 32, 0.0, None),
    (128, 16, 32, 0.1, None),
    (100, 37, 80, 0.1, None),     # ragged N and M, D = 80
    (96, 4, 64, 0.0, 32 ** -0.5),  # BIT: M = 4, scaled by the model dim
    (64, 256, 64, 0.0, None),     # V6 training: M = 256
    (64, 256, 80, 0.1, None),
    (33, 5, 16, 0.1, None),
]


@pytest.mark.parametrize("n,m,d,rate,scale", GRAD_CASES)
def test_plain_gradients_match_jax(n, m, d, rate, scale):
    """Autograd through the plain version against jax.grad through the
    Pallas backward kernel in interpret mode (block_n 32, so that several Q
    tiles accumulate dk and dv) and through the einsum path; atol 1e-5 on dq,
    dk, dv (float32 summation order) for a seeded cotangent ~ N(0, 1 / n),
    which keeps the sums over the n rows of order one."""
    q, k, v = _qkv(n, m, d, seed=n + m + d, b=1)
    cot = (np.random.default_rng(7).standard_normal(q.shape) * n ** -0.5).astype(np.float32)
    scale = d ** -0.5 if scale is None else scale
    seed = SEED if rate else None
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = cross_attention(tq, tk, tv, scale=scale, dropout_rate=rate, dropout_seed=seed)
    (out * torch.from_numpy(cot)).sum().backward()
    got = [t.grad.numpy() for t in (tq, tk, tv)]
    jseed = None if seed is None else jnp.uint32(seed)

    def loss_kernel(q, k, v):
        return jnp.sum(cross_attention_interpret(q, k, v, scale, block_n=32,
                                                 dropout_rate=rate,
                                                 dropout_seed=jseed) * cot)

    def loss_einsum(q, k, v):
        return jnp.sum(_einsum_attention(q, k, v, scale, rate, jseed) * cot)

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for loss in (loss_kernel, loss_einsum):
        wants = jax.grad(loss, argnums=(0, 1, 2))(*args)
        for name, g, w in zip("qkv", got, wants):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                       err_msg=f"d{name} via {loss.__name__}")


def test_tensor_seed_is_the_int_seed():
    """A seed drawn as a tensor (never read on the host) gives the mask of
    the same seed as an int; only its low 32 bits count."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(40, 9, 24, seed=5))
    with torch.no_grad():
        want = cross_attention(q, k, v, dropout_rate=0.3, dropout_seed=SEED)
        got = cross_attention(q, k, v, dropout_rate=0.3,
                              dropout_seed=torch.tensor([SEED + 5 * 2 ** 32]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grad_arg", [0, 1, 2])
def test_kernel_checks_the_device_with_and_without_grad(grad_arg):
    """On a CPU tensor impl="kernel" raises, whether autograd would record
    the call or not."""
    qkv = [torch.from_numpy(a) for a in _qkv(16, 4, 8)]
    qkv[grad_arg].requires_grad_()
    with pytest.raises(RuntimeError, match="CUDA"):
        cross_attention_kernel(*qkv, scale=8 ** -0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        with torch.no_grad():
            cross_attention_kernel(*qkv, scale=8 ** -0.5)
    assert cross_attention_kernel.backward_launches == 0


def test_bf16_plain_upcasts_and_returns_q_dtype():
    q, k, v = _qkv(40, 9, 24, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    with torch.no_grad():
        got = cross_attention(tq, tk, tv)
        want = cross_attention(tq.float(), tk.float(), tv.float())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (8 mantissa bits)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1e-2)
