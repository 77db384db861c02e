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


# --- the kernel variants: what can be held on a host without a card -----------

import importlib.util
import os

from stcd_tpu_torch.ops import attention as port_attention
from stcd_tpu_torch.ops.attention import (MAX_SMEM_BYTES, MIN_BLOCKS, backward_plan,
                                          forward_plan, select_variant)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
V6_SHAPES = SMOKE.sra_shapes() + SMOKE.sra_shapes(SMOKE.V6_TRAIN["batch"],
                                                  SMOKE.V6_TRAIN["size"])
MAIN_PATH = ([(s, torch.float32) for s in SMOKE.sra_shapes()]
             + [(s, torch.bfloat16) for s in V6_SHAPES]
             + [(SMOKE.BIT_SHAPE, torch.float32), (SMOKE.BIT_SHAPE, torch.bfloat16)])


@pytest.mark.parametrize("shape", V6_SHAPES)
def test_select_variant_bf16_v6_shapes_take_the_tensor_cores(shape):
    assert select_variant(torch.bfloat16, shape[3]) == "mma_bf16"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, SMOKE.BIT_SHAPE[3], 8])
def test_select_variant_small_m_in_both_dtypes(m, dtype):
    assert select_variant(dtype, m) == "small_m"


@pytest.mark.parametrize("m", [9, 37, 64, 256, 257])
def test_select_variant_f32_above_eight_keys_keeps_the_f32_kernel(m):
    assert select_variant(torch.float32, m) == "f32_cuda"
    assert select_variant(torch.bfloat16, m) == "mma_bf16"


@pytest.mark.parametrize("shape,dtype", MAIN_PATH)
def test_plans_fit_the_card_at_every_main_path_shape(shape, dtype):
    """Shared memory within a block's limit; at least MIN_BLOCKS blocks, or one
    tile a block (the tensor-core and the f32 backward, whose blocks fill an
    SM, and the f32 forward, whose blocks each stage all of K and V: at least
    128 blocks, one wave over 97 % of the SMs); the blocks' rows cover N
    exactly; the scratch holds one partial for every part."""
    b, h, n, m, d = shape
    variant = select_variant(dtype, m)
    fwd = forward_plan(variant, b * h, n, m, d)
    bwd = backward_plan(variant, b * h, n, m, d)
    granule = {"f32_cuda": (64, 64), "mma_bf16": (128 * fwd["row_tiles"], 128),
               "small_m": (32, 32)}[variant]
    bwd_min = 128 if variant in ("mma_bf16", "f32_cuda") else MIN_BLOCKS
    fwd_min = 128 if variant == "f32_cuda" else MIN_BLOCKS
    for plan, rows, tile, least in ((fwd, fwd["rows_per_block"], granule[0], fwd_min),
                                    (bwd, bwd["rows_per_split"], granule[1], bwd_min)):
        assert 0 <= plan["smem_bytes"] <= MAX_SMEM_BYTES == 232448
        assert rows % tile == 0 and rows >= tile
        assert MIN_BLOCKS == 264 and port_attention.SMS == 132
        assert plan["blocks"] >= least or rows == tile
        assert plan["blocks"] == b * h * -(-n // rows)
    assert (bwd["splits"] - 1) * bwd["rows_per_split"] < n <= bwd["splits"] * bwd["rows_per_split"]
    assert bwd["scratch_shape"] == (b * h, bwd["parts"], m, d)
    assert bwd["parts"] % bwd["splits"] == 0 and 1 <= bwd["parts"] // bwd["splits"] <= 8
    if variant == "mma_bf16" and m == 256:  # every warp owns keys: one partial a block
        assert bwd["parts"] == bwd["splits"]
        if n == 16384:  # V6 training shape 1: not one partial for each tile of 64 rows
            assert bwd["splits"] == 8


@pytest.mark.parametrize("n", [1, 31, 127, 129, 1000, 4097, 16385])
@pytest.mark.parametrize("variant,m,d", [("f32_cuda", 37, 80), ("mma_bf16", 255, 40),
                                         ("mma_bf16", 300, 128), ("small_m", 4, 64)])
def test_backward_splits_cover_ragged_n_exactly(variant, m, d, n):
    for bh in (1, 7, 256):
        plan = backward_plan(variant, bh, n, m, d)
        rows, splits = plan["rows_per_split"], plan["splits"]
        assert (splits - 1) * rows < n <= splits * rows
        assert plan["smem_bytes"] <= MAX_SMEM_BYTES
        fwd = forward_plan(variant, bh, n, m, d)
        assert fwd["smem_bytes"] <= MAX_SMEM_BYTES and fwd["blocks"] * fwd["rows_per_block"] >= bh * n


def test_forward_plan_keeps_k_and_v_resident_at_the_main_path_shapes():
    """2 * M rows of K and V plus the warps' Q tiles, in padded bf16 rows."""
    for b, h, n, m, d in V6_SHAPES:
        plan = forward_plan("mma_bf16", b * h, n, m, d)
        row_bytes = ({64: 64, 80: 80}[d] + 8) * 2
        assert plan["smem_bytes"] == (2 * m + 8 * 2 * 16 * plan["row_tiles"]) * row_bytes
    with pytest.raises(ValueError, match="variant"):
        forward_plan("wgmma", 1, 1, 1, 1)
    with pytest.raises(ValueError, match="variant"):
        backward_plan("wgmma", 1, 1, 1, 1)


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _emulate_mma_bf16(q, k, v, g, scale, rate, seed, round_p=True):
    """The arithmetic of the bf16 tensor-core variant in plain torch: bf16
    operands, f32 sums, and (``round_p``) p md and ds rounded to bf16 before
    their second products. Returns o, dq, dk, dv as the kernels store them."""
    rnd = _bf16_round if round_p else (lambda x: x)
    q, k, v, g = (_bf16_round(t) for t in (q, k, v, g))
    b, h, n, _ = q.shape
    m = k.shape[2]
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    mx = s.max(-1, keepdim=True).values
    e = torch.exp(s - mx)
    l = e.sum(-1, keepdim=True)
    md = torch.ones_like(s)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, torch.arange(b * h).reshape(b, h, 1, 1),
                                 torch.arange(n).reshape(1, 1, n, 1),
                                 torch.arange(m).reshape(1, 1, 1, m), rate)
        md = keep.float() / (1.0 - rate)
    o = _bf16_round(torch.einsum("bhnm,bhmd->bhnd", rnd(e * md), v) / l)
    lse = mx + torch.log(l)
    p = torch.exp(s - lse)
    delta = (g * o).sum(-1, keepdim=True)
    dp = torch.einsum("bhnd,bhmd->bhnm", g, v)
    ds = rnd(p * (dp * md - delta))
    dv = torch.einsum("bhnm,bhnd->bhmd", rnd(p * md), g)
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q) * scale
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k) * scale
    return o, _bf16_round(dq), _bf16_round(dk), _bf16_round(dv)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,m,d", [(96, 64, 64), (64, 256, 64), (64, 256, 80), (100, 37, 80),
                                   (48, 64, 80), (40, 37, 64)])
def test_bf16_rounding_of_the_tensor_core_variant_stays_in_tolerance(n, m, d, rate):
    """p md and ds rounded to bf16 before the second products (what the
    mma_bf16 kernels do) against the JAX einsum path in f32 on the same
    bf16-valued inputs: the output within BF16_ATOL and dq, dk, dv within
    BWD_BF16_ATOL, times max(1, max |reference|), the gates of the card run."""
    q, k, v = (_bf16_round(torch.from_numpy(a)).numpy() for a in _qkv(n, m, d, seed=n + m + d))
    g = _bf16_round(torch.from_numpy(
        np.random.default_rng(11).standard_normal(q.shape).astype(np.float32))).numpy()
    scale = d ** -0.5
    seed = SEED if rate else None
    jseed = None if seed is None else jnp.uint32(seed)
    got = _emulate_mma_bf16(*(torch.from_numpy(a) for a in (q, k, v, g)), scale, rate, seed)

    def loss(q, k, v):
        return jnp.sum(_einsum_attention(q, k, v, scale, rate, jseed) * g)

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (_einsum_attention(*args, scale, rate, jseed),
            *jax.grad(loss, argnums=(0, 1, 2))(*args))
    for name, a, w, atol in zip(("o", "dq", "dk", "dv"), got, want,
                                (SMOKE.BF16_ATOL,) + (SMOKE.BWD_BF16_ATOL,) * 3):
        w = np.asarray(w)
        err = np.abs(a.numpy() - w).max()
        assert err <= atol * max(1.0, np.abs(w).max()), (name, err)
    # the emulation without the extra rounding is the plain version's arithmetic
    exact = _emulate_mma_bf16(*(torch.from_numpy(a) for a in (q, k, v, g)), scale, rate, seed,
                              round_p=False)
    np.testing.assert_allclose(exact[0].numpy(), _bf16_round(torch.from_numpy(
        np.array(want[0]))).numpy(), atol=SMOKE.BF16_ATOL)


def test_variant_counters_and_scale_check_without_a_card():
    """The wrapper's counters exist and stay at zero on a CPU-only host."""
    kernel = port_attention.cross_attention_kernel
    assert dict(kernel.forward_variants) == {} and dict(kernel.backward_variants) == {}
    assert port_attention.VARIANTS == ("f32_cuda", "mma_bf16", "small_m")
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 8))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="gradient"):  # refused before any launch
        port_attention.launch_backward(q, k, v, q, lse, q[:, :, :8], 1.0, 0.0, None)
    with pytest.raises(ValueError, match="gradient"):
        port_attention.launch_backward(q, k, v, q, lse, q.double(), 1.0, 0.0, None)
    assert kernel.backward_launches == 0


# --- the f32 forward (f32_cuda): K and V resident, 64-row tiles, register micro-tiles ---

F32_PLAN_SHAPES = SMOKE.sra_shapes() + SMOKE.sra_shapes(SMOKE.V6_TRAIN["batch"],
                                                        SMOKE.V6_TRAIN["size"])


@pytest.mark.parametrize("shape", F32_PLAN_SHAPES)
def test_f32_forward_plan_keeps_k_and_v_resident(shape):
    """At the four serving shapes and the four V6 train shapes in f32: all M
    keys of K and V in shared memory as f32 rows of D padded to 64 or 80 plus
    4, beside two 64-row Q tiles and the 64 x 68 p tile; two blocks an SM
    where shared memory allows; whole 64-row tiles a block, one wave of at least
    128 blocks."""
    b, h, n, m, d = shape
    plan = forward_plan("f32_cuda", b * h, n, m, d)
    ld = {64: 68, 80: 84}[d]
    assert plan["kv_resident"] and plan["kv_rows"] == -(-m // 64) * 64
    assert plan["smem_bytes"] == (2 * plan["kv_rows"] * ld + 2 * 64 * ld + 64 * 68) * 4
    assert plan["smem_bytes"] <= MAX_SMEM_BYTES
    assert plan["rows_per_block"] % 64 == 0 and plan["row_tiles"] == 1
    assert plan["blocks"] >= 128 or plan["rows_per_block"] == 64  # one wave over 97 % of the SMs


@pytest.mark.parametrize("n", [1, 63, 64, 65, 77, 300, 1000, 4097])
@pytest.mark.parametrize("m,d", [(9, 36), (37, 80), (255, 40), (257, 72), (300, 128), (64, 64)])
def test_f32_forward_plan_covers_every_row_once(m, d, n):
    """Any N, M > 8, D <= 128: the blocks' row ranges tile [0, N) of each head
    exactly once, the last block ragged; K and V go through in blocks of
    kv_rows keys (a whole number of 64-key steps) where M does not fit."""
    for bh in (1, 7, 64):
        plan = forward_plan("f32_cuda", bh, n, m, d)
        rows = plan["rows_per_block"]
        per_head = plan["blocks"] // bh
        assert plan["blocks"] == bh * per_head
        assert (per_head - 1) * rows < n <= per_head * rows
        assert plan["smem_bytes"] <= MAX_SMEM_BYTES and plan["kv_rows"] % 64 == 0
        assert plan["kv_resident"] == (plan["kv_rows"] >= m)
        assert plan["kv_resident"] or d > 64  # only M = 257 at D = 72 and M = 300 at 128 stream


# --- the f32 backward (f32_cuda): a block owns a range of rows, one partial a block and pass ---

V6_TRAIN_SHAPES = SMOKE.sra_shapes(SMOKE.V6_TRAIN["batch"], SMOKE.V6_TRAIN["size"])


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 1000, 4097, 16385])
@pytest.mark.parametrize("m,d", [(9, 36), (37, 80), (128, 64), (129, 64), (255, 40),
                                 (257, 72), (300, 128)])
def test_f32_backward_plan_covers_every_row_and_key_once(m, d, n):
    """Any N, M > 8, D <= 128: the blocks' ranges of whole 64-row tiles cover
    [0, N) of each head once, the last ragged; the passes of 128 keys (D <=
    80) or 64 (D > 80) cover [0, M) once; the scratch holds one partial a
    block, (bh, splits, M, D); shared memory as the kernel sizes it (K and V
    of a pass, two Q and g tiles each where they fit, else one, the ds and
    p md tiles, the log-sum-exp and delta of up to 2048 rows a block owns),
    within a block's limit."""
    dpad = next(p for p in (32, 48, 64, 80, 128) if d <= p)
    kp = 128 if dpad <= 80 else 64

    def smem(buffers):
        return (2 * kp * (dpad + 4) + buffers * 2 * 64 * (dpad + 4) + 2 * 64 * (kp + 4)
                + 2 * 2048) * 4

    buffers = 2 if smem(2) <= MAX_SMEM_BYTES else 1
    assert buffers == (1 if dpad >= 80 else 2)
    for bh in (1, 7, 64):
        plan = backward_plan("f32_cuda", bh, n, m, d)
        rows, splits = plan["rows_per_split"], plan["splits"]
        assert rows % 64 == 0 and (splits - 1) * rows < n <= splits * rows
        assert rows <= 2048 and plan["keys_per_pass"] == kp
        assert (plan["passes"] - 1) * kp < m <= plan["passes"] * kp
        assert plan["parts"] == splits and plan["blocks"] == bh * splits
        assert plan["scratch_shape"] == (bh, splits, m, d)
        assert plan["smem_bytes"] == smem(buffers) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", V6_TRAIN_SHAPES)
def test_f32_backward_plan_at_the_v6_train_shapes_is_one_wave(shape):
    """At the four ChangeFormerV6 train shapes: 128 blocks, one wave over 97 %
    of the 132 SMs, or a block for the whole of N where the heads alone reach
    128; one partial a block and pass, so the scratch at N = 16384 is 16.8 MB
    where the earlier kernel's partial for every 64 rows took 537 MB."""
    b, h, n, m, d = shape
    plan = backward_plan("f32_cuda", b * h, n, m, d)
    assert 128 <= plan["blocks"] <= port_attention.SMS or plan["rows_per_split"] >= n
    assert plan["passes"] == 2
    scratch = 2 * 4 * int(np.prod(plan["scratch_shape"]))
    assert scratch <= 21e6
    if n == 16384:
        assert plan["splits"] == 8 and scratch == 2 * 4 * 16 * 8 * 256 * 64 <= 20e6


def _f32_backward_by_partition(q, k, v, g, scale, rate, seed):
    """The f32_cuda backward's partition in plain torch: for each block (a
    range of rows) and pass of keys its partial of dk and dv, summed over the
    blocks in index order as the second launch does; dq of a row summed over
    the passes in order. p is rebuilt from the rows' log-sum-exp and delta
    from the saved output, as the kernel does."""
    b, h, n, d = q.shape
    m = k.shape[2]
    plan = backward_plan("f32_cuda", b * h, n, m, d)
    rows, kp = plan["rows_per_split"], plan["keys_per_pass"]
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    lse = torch.logsumexp(s, -1, keepdim=True)
    o = cross_attention(q, k, v, scale=scale, dropout_rate=rate, dropout_seed=seed)
    delta = (g * o).sum(-1, keepdim=True)
    md = torch.ones_like(s)
    if rate > 0.0:
        md = dropout_keep_mask(seed, torch.arange(b * h).reshape(b, h, 1, 1),
                               torch.arange(n).reshape(1, 1, n, 1),
                               torch.arange(m).reshape(1, 1, 1, m), rate).float() / (1 - rate)
    p = torch.exp(s - lse)
    dp = torch.einsum("bhnd,bhmd->bhnm", g, v)
    ds = p * (dp * md - delta)
    dq = torch.zeros_like(q)
    parts_k = torch.zeros((b, h, plan["splits"], m, d))
    parts_v = torch.zeros_like(parts_k)
    for split in range(plan["splits"]):
        r = slice(split * rows, min(n, (split + 1) * rows))
        for key0 in range(0, m, kp):
            c = slice(key0, min(m, key0 + kp))
            parts_k[:, :, split, c] = torch.einsum("bhnm,bhnd->bhmd", ds[:, :, r, c],
                                                   q[:, :, r]) * scale
            parts_v[:, :, split, c] = torch.einsum("bhnm,bhnd->bhmd", (p * md)[:, :, r, c],
                                                   g[:, :, r])
            dq[:, :, r] += torch.einsum("bhnm,bhmd->bhnd", ds[:, :, r, c], k[:, :, c]) * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for split in range(plan["splits"]):
        dk += parts_k[:, :, split]
        dv += parts_v[:, :, split]
    return dq, dk, dv, plan


@pytest.mark.parametrize("n,m,d,rate", [(130, 37, 80, 0.1), (64, 256, 64, 0.0),
                                        (200, 255, 40, 0.1), (77, 9, 36, 0.0)])
def test_f32_backward_partition_matches_the_pallas_backward(n, m, d, rate):
    """The sums of the f32_cuda backward's partials (blocks of rows, passes of
    keys, dq over the passes) equal the plain version's gradients and JAX's
    _bwd through the Pallas backward kernel in interpret mode, at the
    tolerance of test_plain_gradients_match_jax (atol 1e-5 for a cotangent ~
    N(0, 1 / n))."""
    q, k, v = _qkv(n, m, d, seed=n + m + d, b=1)
    cot = (np.random.default_rng(7).standard_normal(q.shape) * n ** -0.5).astype(np.float32)
    scale = d ** -0.5
    seed = SEED if rate else None
    with torch.no_grad():
        *got, plan = _f32_backward_by_partition(*(torch.from_numpy(a) for a in (q, k, v, cot)),
                                                scale, rate, seed)
    assert plan["splits"] * plan["passes"] > 1  # partials are summed
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = cross_attention(tq, tk, tv, scale=scale, dropout_rate=rate, dropout_seed=seed)
    plain = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    jseed = None if seed is None else jnp.uint32(seed)

    def loss(q, k, v):
        return jnp.sum(cross_attention_interpret(q, k, v, scale, block_n=32, dropout_rate=rate,
                                                 dropout_seed=jseed) * cot)

    wants = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, ref, w in zip("qkv", got, plain, wants):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=1e-5, err_msg=f"d{name} plain")
