"""stcd_tpu_torch/ops/attention.py against stcd_tpu/ops/attention.py.

The plain PyTorch cross_attention is held against the JAX einsum path and
against the Pallas kernel in interpret mode, with and without dropout, at
atol 2e-5 (the tolerance of tests/test_ops.py); the dropout hash is held
bit for bit. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py (this suite imports JAX, which the card's machine
does not have)."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("grad_arg", [0, 1, 2])
def test_kernel_refuses_tensors_that_need_grad(grad_arg):
    """The kernel has no backward: where autograd would record the call it
    raises, before it looks at the device, instead of detaching q, k or v."""
    qkv = [torch.from_numpy(a) for a in _qkv(16, 4, 8)]
    qkv[grad_arg].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        cross_attention_kernel(*qkv, scale=8 ** -0.5)
    with pytest.raises(RuntimeError, match="CUDA"):  # no grad: the device check
        with torch.no_grad():
            cross_attention_kernel(*qkv, scale=8 ** -0.5)


def test_bf16_plain_upcasts_and_returns_q_dtype():
    q, k, v = _qkv(40, 9, 24, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    with torch.no_grad():
        got = cross_attention(tq, tk, tv)
        want = cross_attention(tq.float(), tk.float(), tv.float())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (8 mantissa bits)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1e-2)
