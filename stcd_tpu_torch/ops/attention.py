"""Cross-attention for the SRA blocks of ChangeFormer (counterpart of
stcd_tpu/ops/attention.py).

``cross_attention`` computes softmax(q k^T * scale) v over (B, H, N, D)
queries and a small (B, H, M, D) key/value set, with optional dropout of
the attention matrix after normalisation (inverted scaling). It dispatches
on the tensor's device:

- a CUDA tensor goes to the hand-written kernel ``csrc/cross_attention.cu``
  (``cross_attention_kernel``), or the call raises: there is no fallback.
  Under autograd its gradient is the kernel ``csrc/cross_attention_bwd.cu``.
  Both launches are ``torch.library`` custom ops (``stcd::cross_attention_fwd``,
  ``stcd::cross_attention_bwd``), which ``torch.export`` records as calls;
  Both sources hold three variants and ``select_variant`` picks one from
  (dtype, M) alone: ``small_m`` for M <= 8 (a lane group per query row, f32
  math), ``mma_bf16`` for bfloat16 at M > 8 (both products on the tensor
  cores) and ``f32_cuda`` for float32 at M > 8 (CUDA cores);
- a CPU tensor goes to the plain PyTorch version ``attention_plain``, the
  counterpart of the JAX ``_einsum_attention``; its gradient is autograd's.

The dropout decision is the stateless uint32 hash of ``dropout_keep_mask``
on (seed, flattened b*H+h, global row, col). The JAX package, the plain
version here and the CUDA kernel compute it bit for bit alike.

The TPU's auto rule (Pallas only for N >= 1024 and M >= 64) and its padding
of M and D to 128 are not carried over: on a CUDA tensor every call goes to
the kernel, which masks ragged tiles itself.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from stcd_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow:
    the product is split at bit 16 so each part stays below 2^48."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _threshold(rate: float) -> int:
    return min(int(round(rate * 2 ** 32)), 2 ** 32 - 1)


def _seed_u32(seed):
    """The dropout seed as uint32 held in int64: a Python int, or a
    one-element integer tensor (drawn on the device, never read on the host)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _M32
    return int(seed) & _M32


def dropout_keep_mask(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """Keep iff hash(seed, bh, row, col) >= rate * 2^32 (stcd_tpu/ops/
    attention.py:48-63). ``seed`` is an int or a one-element integer tensor;
    ``bh``, ``rows`` and ``cols`` are broadcastable integer tensors. uint32
    arithmetic is done in int64 and masked to 32 bits after every multiply
    and add."""
    bh = bh.to(torch.int64) & _M32
    h = (_seed_u32(seed) + _mul32(bh, 0x9E3779B9)) & _M32
    h = (h + _mul32(rows.to(torch.int64) & _M32, 0x85EBCA6B)) & _M32
    h = (h + _mul32(cols.to(torch.int64) & _M32, 0xC2B2AE35)) & _M32
    h = _fmix32(_fmix32(h) ^ bh)
    return h >= _threshold(rate)


def _check_args(q, k, v, dropout_rate, dropout_seed):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("cross_attention takes (B, H, N, D) q and (B, H, M, D) k, v")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")


def attention_plain(q, k, v, scale: float, dropout_rate: float = 0.0,
                    dropout_seed=None) -> torch.Tensor:
    """The plain version: f32 scores, softmax, the hash mask, f32 product;
    the output takes q's dtype. Materialises the (B, H, N, M) matrix."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    b, h, n, _ = q.shape
    m = k.shape[2]
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        dev = q.device
        bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
        rows = torch.arange(n, device=dev).reshape(1, 1, n, 1)
        cols = torch.arange(m, device=dev).reshape(1, 1, 1, m)
        keep = dropout_keep_mask(dropout_seed, bh, rows, cols, dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The variants of the two kernels, by their code in attention_common.cuh. The
# sizing below mirrors the geometry of the CUDA sources; the C entries get the
# numbers and refuse a launch whose numbers are not their own.
VARIANTS = ("f32_cuda", "mma_bf16", "small_m")
SMALL_M = 8                # kSmallM: keys the small_m variant holds
MAX_SMEM_BYTES = 232448    # dynamic shared memory a block may ask for on sm_90
_SM_SMEM_BYTES = 233472    # shared memory of an SM; each resident block also takes 1 KB
SMS = 132                  # streaming multiprocessors of an H100
MIN_BLOCKS = 2 * SMS       # a grid covers the card at least twice where N allows
_F32_ROWS, _F32_KEYS = 64, 64       # kF32Rows, kF32Keys: the f32 forward's tile and step
_F32_BLOCKS_PER_SM = 2              # its __launch_bounds__ (256 threads, 2 blocks)
_F32_MIN_BLOCKS = 128               # of the f32 forward: see forward_plan
_F32_BWD_ROWS = 64                  # kBwdF32Rows: the f32 backward's tile
_F32_BWD_MAX_RANGE = 2048           # kBwdF32MaxRange: the most rows one of its blocks owns
_MMA_WARPS, _MMA_ROWS, _MMA_PAD, _MMA_KEY_CHUNK = 8, 16, 8, 64
_MMA_BWD_ROWS = 128        # kBwdRows
_MMA_BWD_MIN_BLOCKS = 128  # of the tensor-core backward: see backward_plan
_SMALL_ROWS = 32           # rows a small_m block covers in one pass at 8 lanes a row


def select_variant(dtype: torch.dtype, m: int) -> str:
    """The kernel variant for q's dtype and the number of keys."""
    if m <= SMALL_M:
        return "small_m"
    return "mma_bf16" if dtype == torch.bfloat16 else "f32_cuda"


def _ceil_to(x: int, step: int) -> int:
    return -(-x // step) * step


def _rows_per_block(bh: int, n: int, granule: int, slots: int, overhead: float,
                    max_tiles: Optional[int] = None, min_blocks: int = MIN_BLOCKS) -> int:
    """Query rows a block walks, in whole tiles of ``granule`` rows. Of the
    tile counts that leave at least ``min_blocks`` blocks over all heads (or
    one tile a block, if none does), take the one with the least time, counted
    as waves of ``slots`` concurrent blocks times the tiles a block walks plus
    ``overhead`` (a block's fixed work: staging K and V, writing its partial,
    in tile times); of equals the largest, which leaves the fewest partials."""
    tiles = -(-n // granule)
    best_cost, best = None, 1
    for per_block in range(1, min(tiles, max_tiles or tiles) + 1):
        blocks = bh * -(-tiles // per_block)
        if blocks < min_blocks and per_block > 1:
            break
        cost = -(-blocks // slots) * (per_block + overhead)
        if best_cost is None or cost <= best_cost:
            best_cost, best = cost, per_block
    return best * granule


def _mma_dpad(d: int) -> int:
    """D as the tensor-core kernels pad it in shared memory (their template
    instances: 2, 4, 5 or 8 k-steps of 16)."""
    return next(p for p in (32, 64, 80, 128) if d <= p)


def _f32_dpad(d: int) -> int:
    """D as the f32 forward pads it in shared memory (its template instances)."""
    return next(p for p in (32, 48, 64, 80, 128) if d <= p)


def _f32_bwd_keys(dpad: int) -> int:
    """f32_bwd_keys: keys of a pass of the f32 backward, whose dk and dv sums
    are registers (2 KP C / 16 a thread, C = the thread's 4 to 8 columns)."""
    return 128 if dpad <= 80 else 64


def _f32_bwd_bytes(dpad: int, buffers: int) -> int:
    """f32_bwd_bytes: K and V of a pass, ``buffers`` Q and g tiles each, and
    the tile's ds and p md, as f32 rows padded by 4; the log-sum-exp and
    delta of each row a block may own."""
    kp = _f32_bwd_keys(dpad)
    return (2 * kp * (dpad + 4) + buffers * 2 * _F32_BWD_ROWS * (dpad + 4)
            + 2 * _F32_BWD_ROWS * (kp + 4) + 2 * _F32_BWD_MAX_RANGE) * 4


def _f32_bwd_buffers(dpad: int) -> int:
    """f32_bwd_buffers: two Q and g tiles each (the next one's copy in flight)
    where they fit, else one."""
    return 2 if _f32_bwd_bytes(dpad, 2) <= MAX_SMEM_BYTES else 1


def forward_plan(variant: str, bh: int, n: int, m: int, d: int) -> dict:
    """Launch geometry of the forward kernel: ``rows_per_block`` query rows
    for each of ``blocks`` blocks, and its dynamic shared memory.
    ``kv_rows`` keys of K and V are in shared memory at a time: all of them
    (``kv_resident``) where M fits."""
    row_tiles = 1
    if variant == "f32_cuda":
        ld = _f32_dpad(d) + 4  # f32 row stride: an odd number of 16-byte pieces
        # two Q tiles (the next one's copy in flight) and the p tile
        tiles_bytes = (2 * _F32_ROWS * ld + _F32_ROWS * (_F32_KEYS + 4)) * 4
        cap = (MAX_SMEM_BYTES - tiles_bytes) // (2 * ld * 4) // _F32_KEYS * _F32_KEYS
        kv_rows = min(_ceil_to(m, _F32_KEYS), cap)
        smem = tiles_bytes + 2 * kv_rows * ld * 4
        per_sm = max(1, min(_F32_BLOCKS_PER_SM, _SM_SMEM_BYTES // (smem + 1024)))
        # Each block stages all of K and V, so blocks that walk more tiles pay for it
        # less often: one wave of at least 128 blocks (97 % of the SMs) instead of two
        # measured as fast or faster on an H100 at the four serving and the four V6
        # training shapes (2 to 13 % faster where the choice changed).
        rows = _rows_per_block(bh, n, _F32_ROWS, SMS * per_sm, 0.5, max_tiles=16,
                               min_blocks=_F32_MIN_BLOCKS)
    elif variant == "mma_bf16":
        dpad = _mma_dpad(d)
        row_bytes = (dpad + _MMA_PAD) * 2
        # D <= 64: one 16-row tile a warp and two blocks an SM (more warps to hide
        # latency). 64 < D <= 80: K and V leave room for one block an SM, so a warp
        # takes two tiles (a K or V fragment then feeds two products) where blocks of
        # 256 rows still fill the card. D > 80: one tile (registers).
        row_tiles = 2 if dpad == 80 and bh * (n // (2 * _MMA_WARPS * _MMA_ROWS)) >= SMS else 1
        q_rows = _MMA_WARPS * 2 * row_tiles * _MMA_ROWS  # two Q tiles a warp
        cap = ((MAX_SMEM_BYTES - q_rows * row_bytes) // (2 * row_bytes)
               // _MMA_KEY_CHUNK * _MMA_KEY_CHUNK)
        kv_rows = min(_ceil_to(m, _MMA_KEY_CHUNK), cap)  # K and V stay resident if m fits
        smem = (2 * kv_rows + q_rows) * row_bytes
        rows = _rows_per_block(bh, n, _MMA_WARPS * row_tiles * _MMA_ROWS,
                               SMS * max(1, min(2, MAX_SMEM_BYTES // smem)), 0.5,
                               max_tiles=16)
    elif variant == "small_m":
        rows = _rows_per_block(bh, n, _SMALL_ROWS, 8 * SMS, 0.5, max_tiles=8)
        smem = 0  # K and V as f32 in static shared memory
        kv_rows = m
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return {"rows_per_block": rows, "row_tiles": row_tiles, "blocks": bh * -(-n // rows),
            "smem_bytes": smem, "kv_rows": kv_rows, "kv_resident": kv_rows >= m}


def backward_plan(variant: str, bh: int, n: int, m: int, d: int) -> dict:
    """Launch geometry of the backward kernel: each of ``splits`` blocks a head
    owns ``rows_per_split`` query rows and leaves its dk and dv sums as
    partials in the scratch ``(bh, parts, m, d)``; a second launch sums the
    partials in index order. ``f32_cuda`` walks the range once for each of
    ``passes`` passes of ``keys_per_pass`` keys and leaves one partial a
    block and pass (the pass's rows of its partial)."""
    keys_per_pass = m
    if variant == "f32_cuda":
        dpad = _f32_dpad(d)
        keys_per_pass = _f32_bwd_keys(dpad)
        # Its blocks hold an SM each (shared memory, registers): one wave of at least
        # 128 blocks, as the f32 forward; each block leaves one partial a pass.
        rows = _rows_per_block(bh, n, _F32_BWD_ROWS, SMS, 0.5,
                               max_tiles=_F32_BWD_MAX_RANGE // _F32_BWD_ROWS,
                               min_blocks=_F32_MIN_BLOCKS)
        splits = parts = -(-n // rows)
        smem = _f32_bwd_bytes(dpad, _f32_bwd_buffers(dpad))
    elif variant == "mma_bf16":
        dpad = _mma_dpad(d)
        keys_per_warp = 32 if dpad <= 80 else 16  # the dk, dv accumulators are registers
        kvr = _ceil_to(min(m, _MMA_WARPS * keys_per_warp), keys_per_warp)  # keys of a pass
        key_groups = 1
        while key_groups * keys_per_warp < kvr:
            key_groups *= 2
        # A block fills an SM (its shared memory), so the grid has to cover the card
        # once, not twice, and head counts are powers of two: 128 blocks hold 97 % of
        # the SMs. With MIN_BLOCKS the partials were four times as many and the call
        # measured 18 to 45 % slower at the ChangeFormerV6 training shapes.
        rows = _rows_per_block(bh, n, _MMA_BWD_ROWS, SMS, 0.5,
                               min_blocks=_MMA_BWD_MIN_BLOCKS)
        splits = -(-n // rows)
        parts = splits * (_MMA_WARPS // key_groups)  # spare warps split a tile's rows
        keys_per_pass = _MMA_WARPS * keys_per_warp
        smem = ((2 * kvr + 2 * _MMA_BWD_ROWS) * (dpad + _MMA_PAD)
                + kvr * (_MMA_BWD_ROWS + _MMA_PAD)) * 2 + 2 * _MMA_BWD_ROWS * 4
    elif variant == "small_m":
        rows = _rows_per_block(bh, n, _SMALL_ROWS, 2 * SMS, 4.0)  # the block's reduction
        splits = parts = -(-n // rows)
        smem = 0
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return {"rows_per_split": rows, "splits": splits, "parts": parts,
            "blocks": bh * splits, "scratch_shape": (bh, parts, m, d), "smem_bytes": smem,
            "keys_per_pass": keys_per_pass, "passes": -(-m // keys_per_pass)}


def _check_kernel_args(q, k, v, dropout_rate, dropout_seed):
    _check_args(q, k, v, dropout_rate, dropout_seed)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise RuntimeError("cross_attention_kernel needs CUDA tensors, got "
                           f"{q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise RuntimeError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError("q, k and v must share one dtype of float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cross_attention_kernel needs contiguous q, k and v")
    b, h, n, d = q.shape
    m = k.shape[2]
    if d > 128:
        raise ValueError(f"cross_attention_kernel supports D <= 128, got {d}")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if isinstance(dropout_seed, torch.Tensor) and dropout_rate > 0.0 and not (
            dropout_seed.device == q.device and dropout_seed.dtype == torch.int64
            and dropout_seed.numel() == 1):
        raise ValueError("a tensor dropout_seed must be one int64 on q's device, got "
                         f"{dropout_seed.dtype} {tuple(dropout_seed.shape)} on "
                         f"{dropout_seed.device}")


def _dropout_args(dropout_rate, dropout_seed):
    """(use_dropout, seed value, seed pointer, threshold, keep_scale) as the
    C entries take them. A tensor seed is passed by pointer and read on the
    device; an int seed by value."""
    if dropout_rate <= 0.0:
        return 0, 0, None, 0, 1.0
    if isinstance(dropout_seed, torch.Tensor):
        value, ptr = 0, dropout_seed.data_ptr()
    else:
        value, ptr = int(dropout_seed) & _M32, None
    return 1, value, ptr, _threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)


def launch_forward(q, k, v, scale, dropout_rate, dropout_seed, want_lse: bool):
    """One launch of the forward kernel on checked arguments: ``(out, lse)``,
    where ``lse`` is the float32 (B, H, N) log-sum-exp of each row's scaled
    scores, which the backward kernel reads, or None when not asked for."""
    b, h, n, d = q.shape
    m = k.shape[2]
    variant = select_variant(q.dtype, m)
    if variant == "mma_bf16" and not scale > 0.0:
        raise ValueError(f"the bfloat16 kernel takes the row max before scaling and needs "
                         f"scale > 0, got {scale}")
    plan = forward_plan(variant, b * h, n, m, d)
    lib = _build.load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if want_lse else None
    use_dropout, seed, seed_ptr, threshold, keep_scale = _dropout_args(dropout_rate,
                                                                       dropout_seed)
    err = lib.stcd_cross_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if want_lse else None, b * h, n, m, d, _DTYPE_CODE[q.dtype],
        VARIANTS.index(variant), plan["rows_per_block"], plan["row_tiles"],
        plan["smem_bytes"],
        float(scale), use_dropout, seed, seed_ptr, threshold, keep_scale, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"stcd_cross_attention_fwd ({variant})")
    cross_attention_kernel.kernel_launches += 1
    cross_attention_kernel.forward_variants[variant] += 1
    return out, lse


def launch_backward(q, k, v, out, lse, g, scale, dropout_rate, dropout_seed):
    """One launch of the backward kernel (and of the sum over its partials) on
    the forward's inputs, its output ``out`` and log-sum-exp ``lse``, and the
    contiguous incoming gradient ``g`` in q's dtype: ``(dq, dk, dv)``."""
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"the gradient must be contiguous, of q's shape and dtype, got "
                         f"{g.dtype} {tuple(g.shape)} for q {q.dtype} {tuple(q.shape)}")
    b, h, n, d = q.shape
    m = k.shape[2]
    variant = select_variant(q.dtype, m)
    plan = backward_plan(variant, b * h, n, m, d)
    lib = _build.load_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each block's share of dk and dv, summed in index order by a second launch
    dk_part = torch.empty(plan["scratch_shape"], dtype=torch.float32, device=q.device)
    dv_part = torch.empty_like(dk_part)
    use_dropout, value, seed_ptr, threshold, keep_scale = _dropout_args(dropout_rate,
                                                                        dropout_seed)
    err = lib.stcd_cross_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), plan["parts"], b * h, n, m, d,
        _DTYPE_CODE[q.dtype], VARIANTS.index(variant), plan["rows_per_split"],
        plan["smem_bytes"], float(scale), use_dropout, value, seed_ptr, threshold,
        keep_scale, q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"stcd_cross_attention_bwd ({variant})")
    cross_attention_kernel.backward_launches += 1
    cross_attention_kernel.backward_variants[variant] += 1
    return dq, dk, dv


def _seed_arg(dropout_seed):
    """(tensor seed or None, int seed) as the custom ops take them: a tensor
    seed travels as a tensor input, an int seed as an int."""
    if isinstance(dropout_seed, torch.Tensor):
        return dropout_seed, 0
    return None, 0 if dropout_seed is None else int(dropout_seed) & _M32


# The two launches as torch.library custom ops, so that torch.export records
# them as calls (a ctypes launch on data_ptr() cannot be traced) and a loaded
# program launches the kernels, and so that autograd reaches the backward
# kernel. Each has a fake (shape) version for tracing; the real one runs only
# on CUDA tensors.
@torch.library.custom_op("stcd::cross_attention_fwd", mutates_args=(), device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            seed_tensor: Optional[torch.Tensor], scale: float, dropout_rate: float,
            int_seed: int, want_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    seed = seed_tensor if seed_tensor is not None else int_seed
    out, lse = launch_forward(q, k, v, scale, dropout_rate, seed, want_lse)
    return out, lse if lse is not None else q.new_empty((0,), dtype=torch.float32)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, seed_tensor, scale, dropout_rate, int_seed, want_lse):
    lse_shape = q.shape[:3] if want_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


@torch.library.custom_op("stcd::cross_attention_bwd", mutates_args=(), device_types="cuda")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            lse: torch.Tensor, g: torch.Tensor, seed_tensor: Optional[torch.Tensor],
            scale: float, dropout_rate: float,
            int_seed: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    seed = seed_tensor if seed_tensor is not None else int_seed
    return launch_backward(q, k, v, out, lse, g, scale, dropout_rate, seed)


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, lse, g, seed_tensor, scale, dropout_rate, int_seed):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _fwd_setup(ctx, inputs, output):
    """The backward kernel's inputs: q, k, v, the output and the rows'
    log-sum-exp (the JAX side saves q, k, v and the seed and rebuilds the
    rest), so that it needs one pass over the keys."""
    q, k, v, seed_tensor, scale, dropout_rate, int_seed, _ = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], seed_tensor)
    ctx.scale, ctx.dropout_rate, ctx.int_seed = scale, dropout_rate, int_seed


def _fwd_backward(ctx, g, _g_lse):
    """Under autocast q, k, v arrive in bfloat16 and the incoming gradient may
    have another dtype: it is cast to q's and made contiguous."""
    q, k, v, out, lse, seed_tensor = ctx.saved_tensors
    dq, dk, dv = _bwd_op(q, k, v, out, lse, g.to(q.dtype).contiguous(), seed_tensor,
                         ctx.scale, ctx.dropout_rate, ctx.int_seed)
    return dq, dk, dv, None, None, None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def cross_attention_kernel(q, k, v, scale: float, dropout_rate: float = 0.0,
                           dropout_seed=None) -> torch.Tensor:
    """Launch ``csrc/cross_attention.cu`` on q's device and current stream,
    through the custom op ``torch.ops.stcd.cross_attention_fwd``.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device, D <= 128; raises on anything else. ``dropout_seed`` is an int, or
    one int64 on q's device, which the kernel reads there. Where autograd
    records the call, the gradient is ``csrc/cross_attention_bwd.cu``
    (``torch.ops.stcd.cross_attention_bwd``). ``kernel_launches`` counts the
    forward launches and ``backward_launches`` the backward ones, those of a
    program exported with ``torch.export`` and run included;
    ``forward_variants`` and ``backward_variants`` count them by the variant
    that ``select_variant`` picked."""
    _check_kernel_args(q, k, v, dropout_rate, dropout_seed)
    want_lse = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
    seed_tensor, int_seed = _seed_arg(dropout_seed if dropout_rate > 0.0 else None)
    return _fwd_op(q, k, v, seed_tensor, float(scale), float(dropout_rate), int_seed,
                   want_lse)[0]


cross_attention_kernel.kernel_launches = 0
cross_attention_kernel.backward_launches = 0
cross_attention_kernel.forward_variants = collections.Counter()
cross_attention_kernel.backward_variants = collections.Counter()


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed=None, impl: Optional[str] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, N, D) q and (B, H, M, D) k, v.

    ``impl=None`` picks by device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``impl="plain"`` or ``"kernel"`` forces
    one; it exists so that a run on the card can hold the two against each
    other."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl is None:
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "kernel":
        return cross_attention_kernel(q, k, v, scale, dropout_rate, dropout_seed)
    if impl == "plain":
        return attention_plain(q, k, v, scale, dropout_rate, dropout_seed)
    raise ValueError(f"impl must be None, 'kernel' or 'plain', got {impl!r}")
