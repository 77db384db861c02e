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


# --- bn_stats_plan: the launch of the one-launch kernel (the kernel runs only on a card) ---

from stcd_tpu_torch.ops import bn_stats as bn_ops  # noqa: E402

BN_SHAPES = [(128, 64, 64, 256), (128, 128, 128, 64), (128, 32, 32, 512), (128, 16, 16, 1024),
             (128, 256, 256, 16), (128, 128, 128, 32)]  # chip_smoke.BN_SHAPES


def _rows_c(shape):
    return int(np.prod(shape[:-1])), shape[-1]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", BN_SHAPES + OTHER_SHAPES)
def test_plan_covers_every_row_once_with_resident_blocks(shape, itemsize):
    """Persistent blocks, all resident at once (at most BLOCKS_PER_SM x SMS),
    each owning whole passes of contiguous rows; together they cover every row
    once; the finishing groups fit the ticket slot; the 16-byte loads wherever
    C allows them (the pointer aligned)."""
    rows, c = _rows_c(shape)
    plan = bn_ops.bn_stats_plan(rows, c, itemsize, aligned=True)
    full = 16 // itemsize
    assert plan["vec"] == (full if c % full == 0 else 1)
    assert plan["width"] == min(c // plan["vec"], bn_ops.THREADS)
    assert plan["row_slots"] == bn_ops.THREADS // plan["width"]
    assert plan["col_tiles"] == -(-(c // plan["vec"]) // bn_ops.THREADS)
    assert plan["blocks"] * plan["col_tiles"] <= bn_ops.SMS * bn_ops.BLOCKS_PER_SM
    rpb = plan["rows_per_block"]
    assert rpb % plan["row_slots"] == 0
    assert (plan["blocks"] - 1) * rpb < rows <= plan["blocks"] * rpb
    assert plan["group_blocks"] ** 2 >= plan["blocks"] > (plan["group_blocks"] - 1) ** 2
    assert plan["groups"] == -(-plan["blocks"] // plan["group_blocks"])
    assert plan["groups"] + 1 <= bn_ops.TICKETS_PER_SLOT  # a group ticket each and the top one
    assert plan["part_rows"] == plan["blocks"] + (plan["groups"] if plan["groups"] > 1 else 0)
    assert plan["scheme"] == "ldg" and plan["launches"] == 1


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_plan_at_the_segcd_shapes(shape, itemsize):
    """The six SegCD-r50 shapes fill the card (264 blocks, one column tile) and
    keep a thread's own sum short: at most 512 values (about 250 at
    (128, 256, 256, 16) in bf16, where 2 channel groups leave 128 row slots;
    about 500 in f32 at C = 64 and 256), whose float32 rounding stays well
    inside the 1e-5 gate that chip_smoke.py holds the sums to."""
    rows, c = _rows_c(shape)
    plan = bn_ops.bn_stats_plan(rows, c, itemsize, aligned=True)
    assert plan["vec"] == 16 // itemsize and plan["col_tiles"] == 1
    assert bn_ops.SMS * bn_ops.BLOCKS_PER_SM - 3 <= plan["blocks"] <= 264
    assert plan["rows_per_block"] // plan["row_slots"] <= 512
    if shape == (128, 256, 256, 16) and itemsize == 2:
        assert (plan["width"], plan["row_slots"], plan["blocks"]) == (2, 128, 264)
        assert plan["rows_per_block"] // plan["row_slots"] == 249
    # eight 16-byte loads in flight for each of the 512 threads of an SM's two blocks
    assert plan["bytes_in_flight"] == 2 * 256 * 8 * 16


@pytest.mark.parametrize("shape,itemsize,aligned,vec", [
    ((1001, 3), 4, True, 1), ((1001, 3), 2, True, 1),      # C no multiple of 16 bytes
    ((7, 13, 24), 2, False, 1), ((7, 13, 24), 4, False, 1),  # a pointer off a 16-byte boundary
    ((7, 13, 24), 2, True, 8), ((3, 7, 5, 80), 4, True, 4)])
def test_plan_takes_one_channel_loads_where_16_bytes_are_not_allowed(shape, itemsize, aligned,
                                                                     vec):
    rows, c = _rows_c(shape)
    plan = bn_ops.bn_stats_plan(rows, c, itemsize, aligned)
    assert plan["vec"] == vec
    assert plan["width"] == min(c // vec, bn_ops.THREADS)


def test_plan_takes_column_tiles_for_wide_c():
    plan = bn_ops.bn_stats_plan(13200, 4096, 2, aligned=True)  # 512 groups of 8 channels
    assert (plan["col_tiles"], plan["width"], plan["row_slots"]) == (2, 256, 1)
    assert plan["blocks"] == bn_ops.SMS * bn_ops.BLOCKS_PER_SM // 2


@pytest.mark.parametrize("args,match", [((0, 16, 2, True), "rows, c >= 1"),
                                        ((16, 0, 2, True), "rows, c >= 1"),
                                        ((16, 16, 8, True), "2- or 4-byte"),
                                        ((16, 2 ** 24 + 1, 4, True), "beyond the kernel's grid")])
def test_plan_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        bn_ops.bn_stats_plan(*args)


def test_ticket_slots_are_one_for_each_device_and_stream(monkeypatch):
    monkeypatch.setattr(bn_ops, "_SLOTS", {})
    monkeypatch.setattr(bn_ops, "_CAPTURED_SLOTS", [])
    a, b, a_again = (bn_ops._ticket_slot(0, 11), bn_ops._ticket_slot(0, 22),
                     bn_ops._ticket_slot(0, 11))
    assert a == a_again != b and bn_ops._ticket_slot(1, 11) not in (a, b)
    monkeypatch.setattr(bn_ops, "_SLOTS", {(0, s): s for s in range(bn_ops.TICKET_SLOTS)})
    assert bn_ops._ticket_slot(0, 5) == 5
    with pytest.raises(RuntimeError, match="at most"):
        bn_ops._ticket_slot(0, bn_ops.TICKET_SLOTS)


def test_each_captured_call_takes_a_ticket_slot_of_its_own(monkeypatch):
    """Graphs are captured on one shared stream and may replay at once on two
    streams, so a captured call shares its slot with no other call: not with
    its stream's eager calls, not with another captured call. Captured calls
    count against the process's TICKET_SLOTS."""
    monkeypatch.setattr(bn_ops, "_SLOTS", {})
    monkeypatch.setattr(bn_ops, "_CAPTURED_SLOTS", [])
    eager = bn_ops._ticket_slot(0, 11)
    captured = [bn_ops._ticket_slot(0, 11, capturing=True) for _ in range(3)]
    assert len({eager, *captured}) == 4
    assert bn_ops._ticket_slot(0, 11) == eager
    assert bn_ops._ticket_slot(0, 22) not in {eager, *captured}
    monkeypatch.setattr(bn_ops, "_CAPTURED_SLOTS", list(range(bn_ops.TICKET_SLOTS)))
    with pytest.raises(RuntimeError, match="captured calls"):
        bn_ops._ticket_slot(0, 11, capturing=True)


def test_ticket_slots_from_many_threads_are_distinct(monkeypatch):
    """Streams first seen by several threads at once (the serving engine's)
    each get a slot of their own: a shared slot would let two streams share a
    ticket."""
    import sys
    import threading
    monkeypatch.setattr(bn_ops, "_SLOTS", {})
    monkeypatch.setattr(bn_ops, "_CAPTURED_SLOTS", [])
    got, switch = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda s=s: got.__setitem__(
            s, bn_ops._ticket_slot(0, s))) for s in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert sorted(got.values()) == list(range(64))
