"""A bf16 matrix product, alone or with the BatchNorm sums of its f32 result
(counterpart of the four Pallas functions of the JAX repo's feasibility
benchmarks, benchmarks/bench_conv_bn_epilogue.py and
benchmarks/bench_bnstats_diag.py).

A ResNet bottleneck's 1x1 convolution is a matrix product ``x (M, K) . w (K,
N)``; the functions ask whether it can emit ``sum(y)`` and ``sum(y^2)`` over
its rows while the output tile is still on chip:

- ``matmul_bf16(x, w) -> y``                          (``pallas_mm``)
- ``matmul_stats(x, w) -> (y, sum, sumsq)``            (``pallas_fused``):
  the two sums formed on the CUDA cores;
- ``matmul_stats_rows(x, w) -> (y, sum, sumsq)``       (``pallas_1d``): a
  block owns its rows across all N there; here the function, kernel and
  plan of ``matmul_stats``, whose persistent blocks own their rows across
  all N wherever w stays resident in shared memory;
- ``matmul_stats_mma(x, w) -> (y, sum, sumsq)``        (``pallas_mxu_stats``):
  as ``_rows``, the two sums formed on the tensor cores.

x and w are bfloat16, the accumulation is float32, y is the accumulator
rounded to bfloat16 once, and the sums, float32[N], are those of the float32
accumulator before it is rounded. Each dispatches on the tensors' device:

- CUDA tensors go to the hand-written kernels (``*_kernel``), or the call
  raises: there is no fallback. Each takes one of two routes, chosen from
  the shapes and pointers by ``matmul_plan``: ``wgmma_tma`` (``csrc/matmul_hopper.cu``:
  persistent blocks, w resident in shared memory, x streamed once by TMA into
  a ring, ``wgmma`` products; the epilogue stores y and, for the three with
  sums, forms the column sums on the CUDA cores or on the tensor cores)
  wherever TMA can describe x and y, else ``wmma`` (the tiles of
  ``csrc/matmul_stats.cu``);
- CPU tensors go to the plain PyTorch versions (``*_plain``).

The JAX functions' ``bm``, ``bn`` and ``pipeline`` are TPU tile arguments and
their ``m % bm == 0`` rule is the TPU grid's; here any M, K, N >= 1 is taken
and the tile geometry is fixed (``GEOMETRY``). Like the JAX functions these
have no gradient: they raise on inputs that require grad.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from stcd_tpu_torch.ops import _build

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# BM, BN, BK of matmul_stats.cu: it only sizes the scratch here, and the C entry
# refuses a scratch whose tile count is not its own.
TILE_ROWS, TILE_COLS, TILE_DEPTH = 128, 64, 64
GEOMETRY = (f"{TILE_ROWS} x {TILE_COLS} output tiles, K in chunks of {TILE_DEPTH}, 8 warps of "
            f"32 x 32 (wmma m16n16k16 bf16), partial sums per {TILE_ROWS}-row tile; "
            f"all four by wgmma with TMA where matmul_plan allows")
_MAX_BLOCKS = 2 ** 31 - 1

# The wgmma route of matmul_hopper.cu, mirrored by its plan_for: the C entry
# refuses a plan that is not its own.
ROUTES = ("wgmma_tma", "wmma")  # their codes in the C entry are their indices
SMS = 132                       # streaming multiprocessors of an H100
MAX_SMEM_BYTES = 232448         # dynamic shared memory a block may ask for on sm_90
_X_ROWS, _X_DEPTH = 128, 64     # an x chunk: 128 rows of 64 bf16 (128 bytes, the swizzle)
_STAGE_BYTES = _X_ROWS * _X_DEPTH * 2
_MAX_STAGES = 8
_INT_MAX = 2 ** 31 - 1
# The epilogues of the wgmma route (codes in the C entries are their indices):
# y alone, the sums on the CUDA cores (matmul_stats), on the tensor cores
# (matmul_stats_mma).
EPILOGUES = ("none", "cuda_cores", "tensor_cores")
STATS_PASSES = 2                # kStatsPasses: passes a group holds with tensor-core sums
# passes a group holds with each epilogue's sums (kCudaSumPasses, kStatsPasses); no cap without
SUM_PASSES = {"none": None, "cuda_cores": 4, "tensor_cores": STATS_PASSES}


def _overhead_bytes(bn: int) -> int:
    """Shared memory besides w and the ring: alignment slack, the ring's
    mbarriers, and for each of the two consumer warpgroups one or two y
    boxes of 64 x 64 (one filled while the TMA stores the other)."""
    return 1024 + 2 * _MAX_STAGES * 8 + 2 * min(bn // 64, 2) * 64 * 64 * 2


def matmul_plan(m: int, k: int, n: int, aligned: bool, epilogue: str = "none") -> dict:
    """The route and launch geometry for x (m, k) . w (k, n) with the
    ``epilogue`` of ``EPILOGUES``: ``"none"`` for ``matmul_bf16``,
    ``"cuda_cores"`` for ``matmul_stats``, ``"tensor_cores"`` for
    ``matmul_stats_mma``; ``aligned``: x, w and y start on 16-byte
    boundaries. The three share the kernel and its rules; with the sums a
    group holds at most ``SUM_PASSES[epilogue]`` passes (their sums are
    registers), and the block's sums go through the ring's shared memory at
    the end, so they ask for no more.

    ``wgmma_tma`` wherever TMA can describe x and y: aligned, rows of whole 16
    bytes (K and N multiples of 8), and the boxes inside the tensors (M >= 128,
    K >= 64, N >= 64). Its ``pass_cols`` (64, 128 or 256) are the output
    columns of one ``wgmma`` pass; the ``passes_per_group`` passes of a group
    keep their w (K padded to 64) in shared memory beside a ring of
    ``stages`` x chunks of 16 KB; ``groups`` > 1 only where all of w does not
    fit, and then x is read once for each group. ``blocks_x`` persistent
    blocks a group, at most 132 blocks in all; with the sums each block
    leaves one partial, row ``blockIdx.x`` of a (blocks_x, n) scratch. Else
    ``wmma``: one block for each 128-row tile (and one partial each)."""
    if min(m, k, n) < 1:
        raise ValueError(f"matmul_plan takes m, k, n >= 1, got {(m, k, n)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"matmul_plan's epilogue is one of {EPILOGUES}, got {epilogue!r}")
    max_npg = SUM_PASSES[epilogue]
    m_tiles = -(-m // _X_ROWS)
    wmma = {"route": "wmma", "pass_cols": 0, "passes_per_group": 0, "groups": 1, "stages": 0,
            "blocks_x": min(m_tiles, _INT_MAX), "smem_bytes": 0, "w_resident": False}
    if (not aligned or k % 8 or n % 8 or k < _X_DEPTH or n < 64 or m < _X_ROWS
            or m > _INT_MAX):
        return wmma
    chunks = -(-k // _X_DEPTH)
    bn = 64 if n <= 64 else 128 if n <= 128 else 256
    while bn >= 64:
        passes = -(-n // bn)
        pass_bytes = bn * chunks * _X_DEPTH * 2
        for npg in range(passes if max_npg is None else min(passes, max_npg), 0, -1):
            # several passes share a tile's chunks, so the ring must hold all of them
            min_stages = max(2, chunks) if npg > 1 else 2
            room = MAX_SMEM_BYTES - _overhead_bytes(bn) - npg * pass_bytes
            if room < min_stages * _STAGE_BYTES:
                continue
            groups = -(-passes // npg)
            if groups > SMS:
                return wmma
            stages = min(_MAX_STAGES, room // _STAGE_BYTES)
            smem = _overhead_bytes(bn) + npg * pass_bytes + stages * _STAGE_BYTES
            return {"route": "wgmma_tma", "pass_cols": bn, "passes_per_group": npg,
                    "groups": groups, "stages": stages,
                    "blocks_x": min(m_tiles, SMS // groups), "smem_bytes": smem,
                    "w_resident": groups == 1}
        bn //= 2
    return wmma


def _check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"the product takes x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the product takes bfloat16 operands, got {x.dtype} and {w.dtype}")
    if min(*x.shape, *w.shape) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)} . {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device} and w on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the product has no gradient (the JAX functions have none): "
                           "detach the operands or call it under torch.no_grad()")


def _accumulator(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_args(x, w)
    return x.float() @ w.float()


def matmul_bf16_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: the float32 product of the upcast operands, rounded
    to bfloat16."""
    return _accumulator(x, w).bfloat16()


def matmul_stats_plain(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """The plain version of the three functions with sums: they compute one
    function. The sums are of the float32 accumulator, not of the rounded y."""
    acc = _accumulator(x, w)
    return acc.bfloat16(), acc.sum(0), (acc * acc).sum(0)


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, epilogue: str, grid_2d: bool):
    """Launch a C entry with ``epilogue`` (one of ``EPILOGUES``) on the route
    that ``matmul_plan`` picks for it."""
    _check_args(x, w)
    if not x.is_cuda:
        raise RuntimeError(f"{entry} needs CUDA tensors, got {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{entry} needs contiguous row-major operands")
    m, k = x.shape
    n = w.shape[1]
    m_tiles = -(-m // TILE_ROWS)
    blocks = m_tiles * (-(-n // TILE_COLS) if grid_2d else 1)
    if blocks > _MAX_BLOCKS or max(k, n) > 2 ** 31 - 1:
        raise ValueError(f"{entry}: ceil(M / {TILE_ROWS}) tiles"
                         f"{' times ceil(N / %d)' % TILE_COLS if grid_2d else ''} must not "
                         f"exceed {_MAX_BLOCKS} blocks, got {blocks} for M={m}, N={n}")
    lib = _build.load_library()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    tail = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    plan = matmul_plan(m, k, n, all(t.data_ptr() % 16 == 0 for t in (x, w, y)), epilogue)
    geometry = (ROUTES.index(plan["route"]), plan["pass_cols"], plan["passes_per_group"],
                plan["stages"], plan["blocks_x"], plan["smem_bytes"])
    if epilogue == "none":
        err = getattr(lib, entry)(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, *geometry,
                                  *tail)
        _build.check(lib, err, f"{entry} ({plan['route']})")
        return y, plan["route"]
    out = torch.empty((2, n), dtype=torch.float32, device=x.device)
    # one partial for each persistent block on wgmma_tma, for each M tile on wmma
    part_rows = plan["blocks_x"] if plan["route"] == "wgmma_tma" else m_tiles
    part = torch.empty((2, part_rows, n), dtype=torch.float32, device=x.device)
    err = getattr(lib, entry)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), m, k, n, *geometry, part_rows, *tail)
    _build.check(lib, err, f"{entry} ({plan['route']})")
    return (y, out[0], out[1]), plan["route"]


def matmul_bf16_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the product alone on x's device and current stream, on the
    route ``matmul_plan`` picks. Takes contiguous bfloat16 CUDA tensors;
    raises on anything else. ``kernel_launches`` counts the calls and
    ``routes`` counts them by route."""
    y, route = _launch("stcd_matmul_bf16", x, w, "none", grid_2d=False)
    matmul_bf16_kernel.kernel_launches += 1
    matmul_bf16_kernel.routes[route] += 1
    return y


def matmul_stats_kernel(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """Launch the product with the sums formed on the CUDA cores, on the route
    ``matmul_plan(..., epilogue="cuda_cores")`` picks: ``wgmma_tma`` runs
    ``matmul_bf16``'s kernel with the sums in its epilogue (y bit-equal to
    ``matmul_bf16``'s there), ``wmma`` the 2-D tile of ``matmul_stats.cu``, one
    block for each (M tile, N tile). ``kernel_launches`` counts the calls and
    ``routes`` counts them by route."""
    out, route = _launch("stcd_matmul_stats", x, w, "cuda_cores", grid_2d=True)
    matmul_stats_kernel.kernel_launches += 1
    matmul_stats_kernel.routes[route] += 1
    return out


def matmul_stats_rows_kernel(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """``matmul_stats_kernel`` under its own counters: the same entry and
    route (``matmul_plan(..., epilogue="cuda_cores")``). On ``wgmma_tma`` each
    persistent block owns its rows across all N wherever w stays resident
    (one group); ``wmma`` is the 2-D tile. ``kernel_launches`` counts the
    calls and ``routes`` counts them by route."""
    out, route = _launch("stcd_matmul_stats", x, w, "cuda_cores", grid_2d=True)
    matmul_stats_rows_kernel.kernel_launches += 1
    matmul_stats_rows_kernel.routes[route] += 1
    return out


def matmul_stats_mma_kernel(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """Launch the product with the sums formed on the tensor cores, on the
    route ``matmul_plan(..., epilogue="tensor_cores")`` picks: ``wgmma_tma`` runs
    ``matmul_bf16``'s kernel with the sums in its epilogue (y bit-equal to
    ``matmul_bf16``'s there), ``wmma`` the tile of ``matmul_stats.cu``.
    ``kernel_launches`` counts the calls and ``routes`` counts them by route."""
    out, route = _launch("stcd_matmul_stats_mma", x, w, "tensor_cores", grid_2d=False)
    matmul_stats_mma_kernel.kernel_launches += 1
    matmul_stats_mma_kernel.routes[route] += 1
    return out


for _kernel in (matmul_bf16_kernel, matmul_stats_kernel, matmul_stats_rows_kernel,
                matmul_stats_mma_kernel):
    _kernel.kernel_launches = 0
    _kernel.routes = collections.Counter()


def _dispatch(kernel, plain, x, w, impl):
    if impl is None:
        impl = "kernel" if x.is_cuda else "plain"
    if impl == "kernel":
        return kernel(x, w)
    if impl == "plain":
        return plain(x, w)
    raise ValueError(f"impl must be None, 'kernel' or 'plain', got {impl!r}")


def matmul_bf16(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None
                ) -> torch.Tensor:
    """y = x . w in bfloat16 with float32 accumulation.

    ``impl=None`` picks by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``impl="plain"`` or ``"kernel"`` forces one; it
    exists so that a run on the card can hold the two against each other."""
    return _dispatch(matmul_bf16_kernel, matmul_bf16_plain, x, w, impl)


def matmul_stats(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None) -> Stats:
    """(y, sum, sumsq): the product and the column sums of its float32
    accumulator and of its square, formed on the CUDA cores. ``impl`` as
    above."""
    return _dispatch(matmul_stats_kernel, matmul_stats_plain, x, w, impl)


def matmul_stats_rows(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None
                      ) -> Stats:
    """The function of ``matmul_stats`` with a block owning its rows across
    all N, so that x is read from device memory once. ``impl`` as above."""
    return _dispatch(matmul_stats_rows_kernel, matmul_stats_plain, x, w, impl)


def matmul_stats_mma(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None
                     ) -> Stats:
    """The function of ``matmul_stats_rows`` with the two sums formed on the
    tensor cores (ones . acc and ones . acc^2, each as three exact TF32 parts,
    so the sums keep float32 accuracy). ``impl`` as above."""
    return _dispatch(matmul_stats_mma_kernel, matmul_stats_plain, x, w, impl)
