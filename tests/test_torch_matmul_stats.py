"""stcd_tpu_torch/ops/matmul_stats.py and its two tools against the JAX
repo's four Pallas functions (benchmarks/bench_conv_bn_epilogue.py and
benchmarks/bench_bnstats_diag.py, loaded by path and run in TPU interpret
mode on the CPU with small tiles) and against float64, on the same
numpy-seeded bf16 operands.

Tolerances: y bit-equal (both round one f32 accumulator of exact bf16
products once; K <= 128 here, so the accumulators differ by summation order
only, and an output within an f32 ulp of a bf16 rounding boundary is allowed:
at most one bf16 ulp at a handful of elements); the sums rtol 1e-5 of the
largest sum, against JAX and against float64."""

import collections
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from stcd_tpu_torch.ops import matmul_stats as ops
from stcd_tpu_torch.tools import bench_bnstats_diag, bench_conv_bn_epilogue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(512, 64, 128), (1024, 128, 64)]
RAGGED = (333, 37, 91)  # for the port only: the JAX functions need m % bm == 0
SUM_RTOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_benches():
    return _load("bench_conv_bn_epilogue"), _load("bench_bnstats_diag")


def _operands(shape, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    return x, w


def _torch_bf16(x, w):
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()


def _float64_reference(xt, wt):
    acc = xt.double().numpy() @ wt.double().numpy()
    return acc, acc.sum(0), (acc * acc).sum(0)


def _hold_y(got: torch.Tensor, want: np.ndarray):
    got = got.float().numpy()
    diff = np.abs(got - want)
    ulp = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7  # one bf16 ulp is at most this
    assert (diff <= ulp).all()
    assert (diff > 0).sum() <= max(3, diff.size // 10000), "y differs at more than a few elements"


def _hold_sums(got, want, what):
    for g, w, name in zip(got, want, ("sum", "sumsq")):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=SUM_RTOL * np.abs(w).max(), err_msg=f"{name} {what}")


PORT_FNS = {"matmul_stats": ops.matmul_stats, "matmul_stats_rows": ops.matmul_stats_rows,
            "matmul_stats_mma": ops.matmul_stats_mma}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["matmul_stats", "matmul_stats_rows", "matmul_stats_mma"])
def test_stats_functions_match_the_pallas_kernels(jax_benches, name, shape):
    fused, diag = jax_benches
    jax_fn = {"matmul_stats": lambda x, w: fused.pallas_fused(x, w, bm=128, bn=64),
              "matmul_stats_rows": lambda x, w: diag.pallas_1d(x, w, bm=128),
              "matmul_stats_mma": lambda x, w: diag.pallas_mxu_stats(x, w, bm=128)}[name]
    x, w = _operands(shape)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    xt, wt = _torch_bf16(x, w)
    y, s1, s2 = PORT_FNS[name](xt, wt)
    assert y.dtype == torch.bfloat16 and y.shape == (shape[0], shape[2])
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == s2.shape == (shape[2],)
    _hold_y(y, np.asarray(want[0], np.float32))
    _hold_sums((s1.numpy(), s2.numpy()), (want[1], want[2]), "against the Pallas kernel")
    _hold_sums((s1.numpy(), s2.numpy()), _float64_reference(xt, wt)[1:], "against float64")


@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_bf16_matches_the_pallas_kernel(jax_benches, shape):
    _, diag = jax_benches
    x, w = _operands(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = diag.pallas_mm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), bm=128)
    y = ops.matmul_bf16(*_torch_bf16(x, w))
    assert y.dtype == torch.bfloat16
    _hold_y(y, np.asarray(want, np.float32))


def test_sums_are_of_the_accumulator_not_of_the_rounded_output():
    """The property that sets these functions apart from a product followed
    by a statistics pass: sum(y^2) of the rounded y is off by bf16's rounding,
    about 1e-3 relative per element, which the 1e-5 gate would catch."""
    xt, wt = _torch_bf16(*_operands((512, 64, 128), seed=2))
    y, s1, s2 = ops.matmul_stats(xt, wt)
    _, want1, want2 = _float64_reference(xt, wt)
    _hold_sums((s1.numpy(), s2.numpy()), (want1, want2), "against float64")
    rounded = (y.double().numpy() ** 2).sum(0)
    assert np.abs(rounded - want2).max() > 10 * SUM_RTOL * np.abs(want2).max()


@pytest.mark.parametrize("name", ["matmul_bf16", *PORT_FNS])
def test_ragged_shape_on_the_port_alone(name):
    xt, wt = _torch_bf16(*_operands(RAGGED, seed=3))
    acc, want1, want2 = _float64_reference(xt, wt)
    out = getattr(ops, name)(xt, wt)
    y = out if name == "matmul_bf16" else out[0]
    _hold_y(y, torch.from_numpy(acc).float().bfloat16().float().numpy())
    if name != "matmul_bf16":
        _hold_sums((out[1].numpy(), out[2].numpy()), (want1, want2), "ragged, against float64")


@pytest.mark.parametrize("name", ["matmul_bf16", *PORT_FNS])
def test_wrappers_refuse_what_the_kernels_do_not_take(name):
    fn, kernel = getattr(ops, name), getattr(ops, f"{name}_kernel")
    xt, wt = _torch_bf16(*_operands((64, 16, 8)))
    before = kernel.kernel_launches
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        kernel(xt, wt)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fn(xt, wt, impl="kernel")
    with pytest.raises(RuntimeError, match="no gradient"):
        fn(xt.clone().requires_grad_(), wt)
    with torch.no_grad():  # under no_grad a leaf that requires grad is taken
        fn(xt.clone().requires_grad_(), wt)
    with pytest.raises(TypeError, match="bfloat16"):
        fn(xt.float(), wt)
    with pytest.raises(ValueError, match=r"x \(M, K\) and w \(K, N\)"):
        fn(xt, wt.t())
    with pytest.raises(ValueError, match="impl must be"):
        fn(xt, wt, impl="triton")
    assert kernel.kernel_launches == before == 0  # a refused call is not a launch


@pytest.mark.parametrize("tool,n_shapes,keys", [
    (bench_conv_bn_epilogue, 5, {"dot_ms", "dot_stats_ms", "conv4d_stats_ms", "dot_bn_stats_ms",
                                 "matmul_stats_ms", "relerr", "bound_ms"}),
    (bench_bnstats_diag, 3, {"dot_ms", "matmul_bf16_ms", "matmul_stats_rows_ms",
                             "matmul_stats_mma_ms", "cross_variant_err", "bound_ms"}),
])
def test_tools_return_well_formed_rows_on_the_cpu(tool, n_shapes, keys, capsys):
    rows = tool.main(["--device", "cpu", "--rows", "256"])
    assert len(rows) == n_shapes
    assert [(r["k"], r["n"]) for r in rows] == [(k, n) for _, k, n in tool.SHAPES]
    for row in rows:
        assert keys <= set(row) and row["m"] == 256 and row["impl"] == "plain"
        # a CPU run times no device: every time is None, never a host-clock number
        assert all(row[k] is None for k in keys if k.endswith("_ms") and k != "bound_ms")
        assert row["bound_ms"] > 0
    if tool is bench_conv_bn_epilogue:
        # against the product with separate passes over the rounded y: bf16's rounding
        assert all(0 <= r["relerr"] < 5e-2 and r["conv4d_y_err"] <= 1.0 for r in rows)
        assert tool.SHAPES[0] == (128 * 64 * 64, 64, 256) and tool.SHAPES[-1][1] == 1024
    else:
        assert all(r["y_equal"] and r["cross_variant_err"] == 0.0 for r in rows)
    out = capsys.readouterr().out
    assert out.count("M=256") >= n_shapes and "not measured" in out
    assert "torch.Generator(cpu) seeds 0 (x) and 1 (w)" in out


@pytest.mark.parametrize("tool", [bench_conv_bn_epilogue, bench_bnstats_diag])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_bounds_are_bytes_at_every_shape():
    for m, k, n in bench_conv_bn_epilogue.SHAPES:
        by_bytes = 2 * (m * k + k * n + m * n) / 3.35e12 * 1e3
        assert bench_conv_bn_epilogue.bound_ms(m, k, n) == pytest.approx(by_bytes)
        assert 2 * m * k * n / 989e12 * 1e3 < by_bytes


# --- matmul_plan: the route and geometry of matmul_bf16 (the kernels run only on a card) ---

MM_RAGGED = (1000, 72, 200)  # chip_smoke.MM_RAGGED: no dimension a multiple of its tile
TMA_SHAPES = bench_bnstats_diag.SHAPES + bench_conv_bn_epilogue.SHAPES + [MM_RAGGED]


def _tile_bytes(plan, k):
    """w (K padded to 64) of the block's passes, the ring of 128 x 64 chunks and
    the two warpgroups' one or two 64 x 64 y boxes, besides 1 KB of alignment
    and the barriers."""
    chunks = -(-k // 64)
    return (plan["passes_per_group"] * plan["pass_cols"] * chunks * 64 * 2
            + plan["stages"] * 128 * 64 * 2 + 2 * min(plan["pass_cols"] // 64, 2) * 64 * 64 * 2)


@pytest.mark.parametrize("shape", TMA_SHAPES)
def test_matmul_plan_takes_wgmma_with_tma_where_tma_can_describe_the_operands(shape):
    """The tools' shapes and the ragged one: wgmma_tma; shared memory within a
    block's limit; at most 132 persistent blocks; every pass of N in one
    group; w resident exactly when all of it fits beside a ring of two
    stages (or of a tile's chunks, where several passes share them); x read
    once for each group; the ring deep enough for the passes."""
    m, k, n = shape
    plan = ops.matmul_plan(m, k, n, aligned=True)
    assert plan["route"] == "wgmma_tma" and ops.ROUTES.index("wgmma_tma") == 0
    assert plan["pass_cols"] in (64, 128, 256)
    assert plan["pass_cols"] == (64 if n <= 64 else 128 if n <= 128 else 256) or not \
        plan["w_resident"]
    assert 0 < plan["smem_bytes"] <= ops.MAX_SMEM_BYTES == 232448
    assert plan["smem_bytes"] == 1024 + 2 * 8 * 8 + _tile_bytes(plan, k)
    assert plan["blocks_x"] * plan["groups"] <= ops.SMS == 132
    assert plan["blocks_x"] == min(-(-m // 128), 132 // plan["groups"])
    passes = -(-n // plan["pass_cols"])
    assert (plan["groups"] - 1) * plan["passes_per_group"] < passes <= (
        plan["groups"] * plan["passes_per_group"])
    chunks = -(-k // 64)
    assert 2 <= plan["stages"] <= 8
    if plan["passes_per_group"] > 1:
        assert plan["stages"] >= chunks
    w_all = -(-n // plan["pass_cols"]) * plan["pass_cols"] * chunks * 64 * 2
    fits = 1024 + 2 * 8 * 8 + 2 * min(plan["pass_cols"] // 64, 2) * 8192 + w_all + max(
        2, chunks if passes > 1 else 2) * 128 * 64 * 2 <= ops.MAX_SMEM_BYTES
    assert plan["w_resident"] == (plan["groups"] == 1) == fits


def test_matmul_plan_at_the_tool_shapes():
    """bench_bnstats_diag's three shapes keep all of w in shared memory; the
    (32768, 1024, 256) shape of bench_conv_bn_epilogue (512 KB of w) splits N
    into four groups of 64 columns, 33 blocks each."""
    plans = [ops.matmul_plan(*s, aligned=True) for s in bench_bnstats_diag.SHAPES]
    assert [(p["pass_cols"], p["passes_per_group"], p["groups"]) for p in plans] == [
        (256, 1, 1), (128, 1, 1), (256, 2, 1)]
    big = ops.matmul_plan(32768, 1024, 256, aligned=True)
    assert (big["pass_cols"], big["groups"], big["blocks_x"], big["w_resident"]) == (
        64, 4, 33, False)


@pytest.mark.parametrize("shape,aligned", [(RAGGED, True), ((1000, 72, 200), False),
                                           ((1000, 36, 200), True), ((1000, 72, 100), True),
                                           ((100, 72, 200), True), ((1000, 32, 200), True),
                                           ((1000, 72, 56), True)])
def test_matmul_plan_takes_the_wmma_tile_where_tma_cannot(shape, aligned):
    """Nothing a multiple of 8 (chip_smoke.MM_RAGGED_ODD), an unaligned
    pointer, K or N not a multiple of 8, or a box that would not fit inside
    the tensor (M < 128, K < 64, N < 64): the wmma tile of matmul_stats.cu,
    one block for each 128 rows, no shared memory asked for."""
    m, k, n = shape
    plan = ops.matmul_plan(m, k, n, aligned)
    assert plan == {"route": "wmma", "pass_cols": 0, "passes_per_group": 0, "groups": 1,
                    "stages": 0, "blocks_x": -(-m // 128), "smem_bytes": 0,
                    "w_resident": False}


@pytest.mark.parametrize("shape", [(0, 64, 64), (128, 0, 64), (128, 64, 0), (-1, 64, 64)])
def test_matmul_plan_refuses_empty_shapes(shape):
    with pytest.raises(ValueError, match="m, k, n >= 1"):
        ops.matmul_plan(*shape, aligned=True)


def test_matmul_bf16_route_counter_exists_and_stays_at_zero_on_the_cpu():
    x, w = _torch_bf16(*_operands((256, 64, 64)))
    assert torch.equal(ops.matmul_bf16(x, w), ops.matmul_bf16_plain(x, w))
    assert ops.matmul_bf16_kernel.kernel_launches == 0
    assert dict(ops.matmul_bf16_kernel.routes) == {}
    assert ops.ROUTES == ("wgmma_tma", "wmma")


# --- matmul_stats_mma: matmul_bf16's kernel with the sums in its epilogue ---

@pytest.mark.parametrize("shape", TMA_SHAPES)
def test_stats_plan_is_the_product_plan_where_tma_can_describe_the_operands(shape):
    """At the tools' shapes and the ragged one the sums take the wgmma_tma
    route with matmul_bf16's geometry (one kernel: y bit-equal there), at most
    two passes a group (their sums are registers); a partial for each of the
    blocks_x persistent blocks, at most 132 x N."""
    m, k, n = shape
    plan = ops.matmul_plan(m, k, n, aligned=True, epilogue="tensor_cores")
    assert plan["route"] == "wgmma_tma" and plan["passes_per_group"] <= ops.STATS_PASSES == 2
    assert plan["blocks_x"] * plan["groups"] <= ops.SMS
    product = ops.matmul_plan(m, k, n, aligned=True)
    assert plan == product or product["passes_per_group"] > ops.STATS_PASSES
    assert plan == product or shape not in bench_bnstats_diag.SHAPES
    # the block's sums go through the ring at the end: 2 x 8 warps x its columns in f32
    assert 2 * 8 * plan["passes_per_group"] * plan["pass_cols"] * 4 <= plan["stages"] * 128 * 64 * 2


@pytest.mark.parametrize("shape,aligned", [(RAGGED, True), ((1000, 72, 200), False),
                                           ((1000, 36, 200), True), ((100, 72, 200), True)])
def test_stats_plan_takes_the_wmma_tile_where_tma_cannot(shape, aligned):
    assert ops.matmul_plan(*shape, aligned, epilogue="tensor_cores")["route"] == "wmma"


def test_stats_mma_route_counter_exists_and_stays_at_zero_on_the_cpu():
    x, w = _torch_bf16(*_operands((256, 64, 64)))
    y, s1, s2 = ops.matmul_stats_mma(x, w)
    assert torch.equal(y, ops.matmul_bf16_plain(x, w))
    assert ops.matmul_stats_mma_kernel.kernel_launches == 0
    assert dict(ops.matmul_stats_mma_kernel.routes) == {}


# --- matmul_stats: the same kernel with the sums on the CUDA cores ---

CUDA_SUM_CASES = (
    [(s, "wgmma_tma") for s in bench_conv_bn_epilogue.SHAPES + bench_bnstats_diag.SHAPES]
    + [(MM_RAGGED, "wgmma_tma"), (RAGGED, "wmma"), ((1000, 72, 56), "wmma")])


@pytest.mark.parametrize("shape,route", CUDA_SUM_CASES)
def test_cuda_sums_plan_at_the_tool_and_ragged_shapes(shape, route):
    """bench_conv_bn_epilogue's five shapes, bench_bnstats_diag's three and
    the ragged ones: wgmma_tma wherever TMA can describe x and y (at most 132
    persistent blocks, one partial each; shared memory within a block's limit;
    at most SUM_PASSES["cuda_cores"] passes a group, and the block's sums of all its
    columns, two warpgroups x (sum, square), fit in the ring at the end), the
    2-D wmma tile where it cannot (nothing a multiple of 8; N < 64)."""
    m, k, n = shape
    plan = ops.matmul_plan(m, k, n, aligned=True, epilogue="cuda_cores")
    assert plan["route"] == route
    if route == "wmma":
        assert plan == ops.matmul_plan(m, k, n, aligned=True) and plan["blocks_x"] == -(-m // 128)
        return
    assert plan["blocks_x"] == min(-(-m // 128), ops.SMS // plan["groups"])
    assert plan["blocks_x"] * plan["groups"] <= ops.SMS
    assert 0 < plan["smem_bytes"] <= ops.MAX_SMEM_BYTES == 232448
    assert plan["smem_bytes"] == 1024 + 2 * 8 * 8 + _tile_bytes(plan, k)
    assert 1 <= plan["passes_per_group"] <= ops.SUM_PASSES["cuda_cores"] == 4
    assert 2 * 2 * plan["passes_per_group"] * plan["pass_cols"] * 4 <= plan["stages"] * 128 * 64 * 2
    # the sums do not change the product's geometry where the cap does not bind: y is
    # matmul_bf16's, bit for bit, from the same kernel
    product = ops.matmul_plan(m, k, n, aligned=True)
    assert plan == product or product["passes_per_group"] > ops.SUM_PASSES["cuda_cores"]


def test_cuda_sums_plan_at_the_tool_shapes():
    """The geometry bench_conv_bn_epilogue's shapes take: one pass of 256 columns,
    one of 64, one of 128, two of 256 sharing a tile's chunks, and the
    (32768, 1024, 256) shape in four groups of 33 blocks (512 KB of w), which reads
    x once for each group."""
    plans = [ops.matmul_plan(*s, aligned=True, epilogue="cuda_cores")
             for s in bench_conv_bn_epilogue.SHAPES]
    assert [(p["pass_cols"], p["passes_per_group"], p["groups"], p["blocks_x"])
            for p in plans] == [(256, 1, 1, 132), (64, 1, 1, 132), (128, 1, 1, 132),
                                (256, 2, 1, 132), (64, 1, 4, 33)]


def test_cuda_sums_hold_more_passes_a_group_than_the_tensor_core_sums():
    """Where w of four 256-column passes fits beside the ring, the CUDA-core sums
    keep them in one group (x read once); the tensor-core sums stop at two passes
    and read x twice."""
    shape = (4096, 64, 1024)
    cuda = ops.matmul_plan(*shape, aligned=True, epilogue="cuda_cores")
    mma = ops.matmul_plan(*shape, aligned=True, epilogue="tensor_cores")
    assert (cuda["passes_per_group"], cuda["groups"]) == (4, 1)
    assert (mma["passes_per_group"], mma["groups"]) == (2, 2)
    assert cuda == ops.matmul_plan(*shape, aligned=True)


def test_matmul_plan_refuses_an_unknown_epilogue():
    assert ops.EPILOGUES == ("none", "cuda_cores", "tensor_cores")
    with pytest.raises(ValueError, match="epilogue"):
        ops.matmul_plan(1024, 64, 64, aligned=True, epilogue="stats")


def test_stats_route_counter_exists_and_stays_at_zero_on_the_cpu():
    x, w = _torch_bf16(*_operands((256, 64, 64)))
    y, s1, s2 = ops.matmul_stats(x, w)
    assert torch.equal(y, ops.matmul_bf16_plain(x, w))
    assert ops.matmul_stats_kernel.kernel_launches == 0
    assert dict(ops.matmul_stats_kernel.routes) == {}


# --- matmul_stats_rows: matmul_stats' kernel and plan at every shape ---

ROWS_CASES = ([(s, "wgmma_tma") for s in bench_bnstats_diag.SHAPES]
              + [((4096, 64, 1024), "wgmma_tma"), (MM_RAGGED, "wgmma_tma"),
                 ((32768, 1024, 256), "wgmma_tma"), (RAGGED, "wmma"), ((1000, 72, 56), "wmma")])


@pytest.mark.parametrize("shape,route", ROWS_CASES)
def test_rows_plan_at_the_tool_and_ragged_shapes(shape, route):
    """matmul_stats_rows runs on matmul_stats' plan: at bench_bnstats_diag's
    three shapes all of w stays resident (one group), so every persistent
    block streams its rows once against the whole of w, and the scratch has
    one partial for each block; (32768, 1024, 256), whose w does not fit,
    takes four groups on the same route; the shapes that TMA cannot describe
    take the 2-D wmma tile."""
    m, k, n = shape
    plan = ops.matmul_plan(m, k, n, aligned=True, epilogue="cuda_cores")
    assert plan["route"] == route
    if shape in bench_bnstats_diag.SHAPES:
        assert plan["w_resident"] and plan["groups"] == 1
        assert plan["blocks_x"] == min(-(-m // 128), ops.SMS) <= ops.SMS
    if shape == (32768, 1024, 256):
        assert plan["groups"] == 4 and not plan["w_resident"]
    if route == "wmma":
        assert plan["blocks_x"] == -(-m // 128)


def test_rows_launch_matmul_stats_entry_and_plan(monkeypatch):
    """The rows wrapper launches matmul_stats' C entry with its epilogue and
    its 2-D block count check, and counts the launch under its own counters."""
    calls = []

    def launch(entry, x, w, epilogue, grid_2d):
        calls.append((entry, epilogue, grid_2d))
        return (x, w, w), "wgmma_tma"

    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops.matmul_stats_rows_kernel, "kernel_launches", 0)
    monkeypatch.setattr(ops.matmul_stats_rows_kernel, "routes", collections.Counter())
    ops.matmul_stats_rows_kernel(torch.zeros(2, 2), torch.zeros(2, 2))
    assert calls == [("stcd_matmul_stats", "cuda_cores", True)]
    assert ops.matmul_stats_rows_kernel.kernel_launches == 1
    assert dict(ops.matmul_stats_rows_kernel.routes) == {"wgmma_tma": 1}


def test_rows_route_counter_exists_and_stays_at_zero_on_the_cpu():
    x, w = _torch_bf16(*_operands((256, 64, 64)))
    y, s1, s2 = ops.matmul_stats_rows(x, w)
    assert torch.equal(y, ops.matmul_bf16_plain(x, w))
    assert ops.matmul_stats_rows_kernel.kernel_launches == 0
    assert dict(ops.matmul_stats_rows_kernel.routes) == {}
