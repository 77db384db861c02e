// Cross-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = (softmax(q k^T * scale) . md) v, md the inverted-dropout multiplier.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/attention.py::_attention_bwd_kernel
// (launched by _bwd). The TPU kernel walks the Q tiles of one head in order and
// keeps dk and dv resident in VMEM between them. Blocks on the GPU run in no
// order and share nothing, so the accumulation over Q tiles is laid out anew:
//
// Three variants, picked by the wrapper from (dtype, M) alone, as in the forward:
//
// mma_bf16 (bf16, M > 8). What bounds it: 10 N M D operations a head at the
//   tensor-core rate; the bytes (q, k, v, g, o read, dq, dk, dv written once)
//   are a fraction of that at M = 256, so the products must run on the tensor
//   cores and nothing else may be written to device memory. The design:
//   - A block owns a head's range of query rows (one of `splits` ranges) and
//     walks it in tiles of 128 rows. K and V of the head (up to 256 keys a
//     pass) are staged once as bf16, rows padded by 16 bytes for ldmatrix.
//   - Phase 1, warps split the KEYS (32 a warp; with fewer than 8 key groups
//     the spare warps split the tile's rows): a warp forms the TRANSPOSED
//     scores s^T = k q^T and dp^T = v g^T for its keys, 16 rows at a time, as
//     mma.sync.m16n8k16 accumulators, rebuilds p = exp(s scale - lse) and
//     ds = p (dp md - delta) in registers, and uses those C fragments, rounded
//     to bf16, as the A fragments of dv += (p md)^T g and dk += ds^T q. So its
//     dk and dv sums stay in ITS REGISTERS across every tile of the range: no
//     shared-memory accumulator (which would not fit at D = 80) and one partial
//     per warp row group and block in the scratch (bh, parts, M, D).
//   - Phase 2, warps split the ROWS: ds^T of the tile, written to shared memory
//     as bf16 by phase 1, is read back transposed by ldmatrix.trans and
//     dq = scale ds k is formed for 16 rows a warp, staged through the Q buffer
//     and stored 16 bytes a lane.
//   - delta = sum_d g_d o_d and the saved log-sum-exp of the tile's rows are
//     put in shared memory while the cp.async copies of Q and g are in flight.
//   - M > 256 (128 at D > 80): further passes over the range, one per key
//     block; dq is then summed in its own dtype across passes by the thread
//     that owns the element. D > 80 holds 16 keys a warp (registers).
//   - mma.sync, not wgmma: the accumulators that must persist (dk, dv) have the
//     keys as their rows, 32 a warp, and wgmma's 64-row tile would need them in
//     one warpgroup's registers together with both score fragments.
//
// small_m (M <= 8, f32 or bf16). Bound by bytes (q, g read, dq written once).
//   A group of 8 or 16 lanes owns a query row, 8 columns a lane in 16-byte
//   pieces; K and V sit in shared memory as f32; s and dp are reduced over the
//   group by shuffles; delta = sum_j p_j md_j dp_j is formed from them (all M
//   keys are at hand), so the saved output is not read at all; dk and dv are M x D sums over the block's rows
//   held in registers (8 columns x M keys a lane), reduced over the warp by
//   shuffles and over the warps through shared memory in warp order: one
//   partial per block.
//
// f32_cuda (f32, M > 8; the trainer's default precision, TF32 off). What bounds
//   it: the f32 rate of the CUDA cores, 67 TFLOP/s, against 10 N M D + 8 N M
//   operations a head; q, g, o read and dq written once take a fifth to a third
//   of that time at the ChangeFormerV6 training shapes. The earlier kernel took a
//   block and one partial for every 64 rows (537 MB of scratch at N = 16384),
//   staged K and V again for each of them by scalar loads and read shared memory
//   once per multiply-add. The design, after the f32 forward's:
//   - A block owns a range of query rows of one head (rows_per_split, whole tiles
//     of 64; the wrapper sizes the grid as one wave of at least 128 blocks) and
//     walks it once for each pass of KP keys (128 at D <= 80, 64 at D = 128: the
//     dk and dv sums of a pass are 2 KP C / 16 registers a thread). K and V of the
//     pass are staged once by cp.async as f32 rows of D padded to an odd number of
//     float4s; the Q and g tiles of 64 rows come by cp.async, the next one's copy
//     in flight during the current one's math where shared memory holds two.
//   - s = q k^T and dp = g v^T are 4 rows x KP / 16 keys a thread, read by float4
//     along D; p = 2^(s scale log2 e - lse log2 e) and ds = p (dp md - delta) go
//     through shared memory once a tile; dq = scale ds k, dk += ds^T q and dv +=
//     (p md)^T g are register micro-tiles of 4 rows or 4-8 keys x the thread's 4-8
//     columns, read by float4 (one shared-memory read per eight to eleven
//     multiply-adds).
//   - dk and dv of a pass persist over the whole range: one partial per block and
//     pass, a scratch of (bh, splits, M, D) (17 MB at N = 16384, splits = 8). dq of
//     a tile is stored by the first pass and added to by the later ones, by the
//     thread that owns the element, in pass order.
//   - delta = sum_d g_d o_d from the saved o, and the saved log-sum-exp, of every
//     row of the range go to shared memory once, while the first copies are in
//     flight, for all the passes.
//
// All variants:
// - The softmax is rebuilt in one pass from the forward's per-row log-sum-exp:
//   p = exp(s * scale - lse). The row term sum_j p_j md_j dp_j of the softmax
//   transpose equals sum_d g_d o_d with o the forward output (dropout
//   included), so it is taken from the saved o and needs no second pass over
//   the keys. The keep mask is the same keep_element hash on (seed, bh, global
//   row, col) as the forward.
// - Deterministic accumulation: the partials go to an f32 scratch buffer
//   (bh, parts, M, D); a second launch sums them in index order and casts to
//   k's and v's dtype. No float atomics: two runs agree bit for bit.
// - f32 accumulation, dq in q's dtype. Any N and M; D <= 128.

#include "attention_common.cuh"

namespace {

using namespace stcd;

// dk[b][e] = sum over tiles t, in index order, of part[b][t][e]; e runs over M * D.
template <typename T>
__global__ void __launch_bounds__(256)
reduce_tiles_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                    T* __restrict__ dk, T* __restrict__ dv, int tiles, size_t md,
                    size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t b = idx / md;
  const size_t e = idx - b * md;
  const size_t base = b * tiles * md + e;
  float sk = 0.f, sv = 0.f;
#pragma unroll 8
  for (int t = 0; t < tiles; ++t) {
    sk += dk_part[base + (size_t)t * md];
    sv += dv_part[base + (size_t)t * md];
  }
  store_as(dk + idx, sk);
  store_as(dv + idx, sv);
}

cudaError_t reduce_parts(int dtype, const float* dk_part, const float* dv_part, void* dk,
                         void* dv, int parts, int bh, int m, int d, cudaStream_t stream) {
  const size_t md = (size_t)m * d;
  const size_t total = (size_t)bh * md;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (dtype == 0) {
    reduce_tiles_kernel<float><<<blocks, 256, 0, stream>>>(
        dk_part, dv_part, static_cast<float*>(dk), static_cast<float*>(dv), parts, md, total);
  } else {
    reduce_tiles_kernel<bf16><<<blocks, 256, 0, stream>>>(
        dk_part, dv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), parts, md, total);
  }
  return cudaGetLastError();
}

// ---- f32_cuda -----------------------------------------------------------------

constexpr int kBwdF32Rows = 64;         // query rows of a tile
constexpr int kBwdF32MaxRange = 2048;   // query rows a block may own

// Keys of a pass: their dk and dv sums are registers, 2 C KP / 16 a thread.
__host__ __device__ constexpr int f32_bwd_keys(int dp) { return dp <= 80 ? 128 : 64; }

// K and V of a pass, `qbuf` Q and g tiles each, the tile's ds and p md, and the
// log-sum-exp and delta of each row of the block's range.
__host__ __device__ constexpr int f32_bwd_bytes(int dp, int qbuf) {
  return (2 * f32_bwd_keys(dp) * (dp + 4) + qbuf * 2 * kBwdF32Rows * (dp + 4) +
          2 * kBwdF32Rows * (f32_bwd_keys(dp) + 4) + 2 * kBwdF32MaxRange) * 4;
}

// Two Q and g tiles each (the next tile's copy in flight) where they fit, else one.
__host__ __device__ constexpr int f32_bwd_buffers(int dp) {
  return f32_bwd_bytes(dp, 2) <= kMaxSmem ? 2 : 1;
}

inline int f32_bwd_smem(int dp) { return f32_bwd_bytes(dp, f32_bwd_buffers(dp)); }

// row[cols] = x * mult (+ row[cols] where `add`), columns past d left alone.
template <int DP>
__device__ __forceinline__ void store_cols(float* row,
                                           const float (&x)[4 * (DP / 64) + (DP % 64) / 16],
                                           float mult, int tx, int d, bool vec, bool add) {
  constexpr int G4 = DP / 64, G1 = (DP % 64) / 16;
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const int col = 4 * tx + 64 * g;
    if (vec && col < d) {  // d % 4 == 0: the piece is whole
      float4 t = make_float4(x[4 * g] * mult, x[4 * g + 1] * mult, x[4 * g + 2] * mult,
                             x[4 * g + 3] * mult);
      if (add) {
        const float4 old = *reinterpret_cast<const float4*>(row + col);
        t.x += old.x;
        t.y += old.y;
        t.z += old.z;
        t.w += old.w;
      }
      *reinterpret_cast<float4*>(row + col) = t;
    } else if (!vec) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < d) row[col + e] = x[4 * g + e] * mult + (add ? row[col + e] : 0.f);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < G1; ++u) {
    const int col = 64 * G4 + tx + 16 * u;
    if (col < d) row[col] = x[4 * G4 + u] * mult + (add ? row[col] : 0.f);
  }
}

// DP: D padded (32, 48, 64, 80 or 128); KP = f32_bwd_keys(DP) keys a pass. A
// block of 256 threads owns rows [split * rows_per_split, ...) of one head and
// walks them once for each pass of KP keys, in tiles of 64 rows. Thread (ty, tx)
// = (tid / 16, tid % 16):
// - s = q k^T and dp = g v^T: rows ty + 16 r (r < 4) x keys tx + 16 i (i < KP / 16),
//   register micro-tiles from float4 reads along D; p = 2^(s c2 - lse2) and
//   ds = p (dp md - delta) go to shared memory once;
// - dq = scale ds k: rows ty + 16 r x the thread's C columns, over the pass's keys,
//   stored by the first pass and added to by the later ones (the same thread owns
//   the same elements in every pass);
// - dk += ds^T q and dv += (p md)^T g: keys 4 ty + 64 h + e (h < KP / 64, e < 4) x
//   the thread's C columns, registers that persist over the block's whole range
//   and leave as the block's one partial of the pass's keys.
template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attention_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ g_out, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int n, int m, int d, int rows_per_split,
                         float scale, int use_dropout, uint32_t seed_value,
                         const long long* __restrict__ seed_ptr, uint32_t threshold,
                         float keep_scale, int vec_flag) {
  constexpr int KP = f32_bwd_keys(DP);
  constexpr int QB = f32_bwd_buffers(DP);
  constexpr int R = kBwdF32Rows;
  constexpr int LD = DP + 4;  // an odd number of float4s: neighbouring rows, distinct banks
  constexpr int PLD = KP + 4;
  constexpr int KT = KP / 16;  // keys a thread owns in s and dp
  constexpr int KG = KP / 64;  // groups of four keys a thread owns in dk and dv
  constexpr int G4 = DP / 64, G1 = (DP % 64) / 16, C = 4 * G4 + G1;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                   // [KP][LD]: K of the pass
  float* vs = ks + KP * LD;          // [KP][LD]: V of the pass
  float* qbuf = vs + KP * LD;        // [QB][R][LD]
  float* gbuf = qbuf + QB * R * LD;  // [QB][R][LD]
  float* dss = gbuf + QB * R * LD;   // [R][PLD]: ds of the tile
  float* pms = dss + R * PLD;        // [R][PLD]: p md of the tile
  float* rowl = pms + R * PLD;       // [kBwdF32MaxRange]: lse of the range's rows, log 2 units
  float* rowd = rowl + kBwdF32MaxRange;  // [kBwdF32MaxRange]: their delta
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int range0 = blockIdx.y * rows_per_split;
  const int range1 = min(n, range0 + rows_per_split);
  const int tiles = (range1 - range0 + R - 1) / R;
  const int total = (m + KP - 1) / KP * tiles;
  const bool vec = vec_flag != 0;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const float c2 = scale * kLog2e;  // scores in units of log 2
  const float* qb = q + (size_t)bh * n * d;
  const float* gb = g_out + (size_t)bh * n * d;
  const float* ob = o + (size_t)bh * n * d;
  const float* kb = k + (size_t)bh * m * d;
  const float* vb = v + (size_t)bh * m * d;
  const float* lb = lse + (size_t)bh * n;
  float* dqb = dq + (size_t)bh * n * d;
  const size_t part_base = ((size_t)bh * gridDim.y + blockIdx.y) * m * d;

  float ak[4 * KG][C], av[4 * KG][C];  // the pass's dk and dv sums over the range
  stage_f32<DP>(ks, kb, 0, KP, m, d, vec, tid);  // the first pass's keys; zero past m
  stage_f32<DP>(vs, vb, 0, KP, m, d, vec, tid);
  stage_f32<DP>(qbuf, qb, range0, R, n, d, vec, tid);  // rows past n: zero
  stage_f32<DP>(gbuf, gb, range0, R, n, d, vec, tid);
  cp_async_commit();
  // Meanwhile each row of the range: its log-sum-exp in units of log 2, and delta =
  // sum_d g_d o_d from the saved output, a half warp a row, once for every pass.
#pragma unroll 4
  for (int base = 0; base < range1 - range0; base += kF32Threads / 16) {
    const int lr = base + ty;  // whole warps go round together: the sum shuffles
    const float* grow = gb + (size_t)(range0 + lr) * d;
    const float* orow = ob + (size_t)(range0 + lr) * d;
    const bool in = lr < range1 - range0;
    float part = 0.f;
    if (in && vec) {
      for (int c = 4 * tx; c < d; c += 64) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(grow + c));
        const float4 ov = __ldg(reinterpret_cast<const float4*>(orow + c));
        part = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, fmaf(gv.z, ov.z, fmaf(gv.w, ov.w, part))));
      }
    } else if (in) {
      for (int c = tx; c < d; c += 16) part = fmaf(__ldg(grow + c), __ldg(orow + c), part);
    }
    part = half_warp_sum(part);
    if (tx == 0 && in) {
      rowd[lr] = part;
      rowl[lr] = lb[range0 + lr] * kLog2e;
    }
  }
  for (int it = 0; it < total; ++it) {
    const int pass = it / tiles;
    const int tile = it - pass * tiles;
    const int kp = pass * KP;
    const int row0 = range0 + tile * R;
    const float* qs = qbuf + (QB == 2 ? (it & 1) : 0) * R * LD;
    const float* gs = gbuf + (QB == 2 ? (it & 1) : 0) * R * LD;
    cp_async_wait<0>();
    __syncthreads();  // this tile's Q and g have landed; every thread is done with the last
    if (tile == 0) {  // a new pass: fresh dk, dv sums, and after the first its K and V
      if (pass > 0) {
        stage_f32<DP>(ks, kb, kp, KP, m, d, vec, tid);
        stage_f32<DP>(vs, vb, kp, KP, m, d, vec, tid);
      }
#pragma unroll
      for (int i = 0; i < 4 * KG; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          ak[i][c] = 0.f;
          av[i][c] = 0.f;
        }
      }
    }
    cp_async_commit();
    if (QB == 2 && it + 1 < total) {  // the next tile's copy, in flight during this one
      const int nt = (it + 1) % tiles;
      stage_f32<DP>(qbuf + ((it + 1) & 1) * R * LD, qb, range0 + nt * R, R, n, d, vec, tid);
      stage_f32<DP>(gbuf + ((it + 1) & 1) * R * LD, gb, range0 + nt * R, R, n, d, vec, tid);
    }
    cp_async_commit();
    if (tile == 0 && pass > 0) {
      cp_async_wait<1>();  // K and V have landed (the next tile's copy may not have)
      __syncthreads();
    }

    // s = q k^T and dp = g v^T for the thread's 4 rows x KT keys
    {
      float s[4][KT], dp[4][KT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          s[r][i] = 0.f;
          dp[r][i] = 0.f;
        }
      }
#pragma unroll 2
      for (int c = 0; c < DP; c += 4) {
        float4 qv[4], gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * LD + c);
          gv[r] = *reinterpret_cast<const float4*>(gs + (ty + 16 * r) * LD + c);
        }
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * LD + c);
          const float4 vv = *reinterpret_cast<const float4*>(vs + (tx + 16 * i) * LD + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[r][i] = fmaf(qv[r].x, kv.x, fmaf(qv[r].y, kv.y,
                      fmaf(qv[r].z, kv.z, fmaf(qv[r].w, kv.w, s[r][i]))));
            dp[r][i] = fmaf(gv[r].x, vv.x, fmaf(gv[r].y, vv.y,
                       fmaf(gv[r].z, vv.z, fmaf(gv[r].w, vv.w, dp[r][i]))));
          }
        }
      }
      // p from the forward's log-sum-exp; keys past m and rows past n take p = 0
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lrow = ty + 16 * r;
        const int row = row0 + lrow;
        const float lse2 = row < n ? rowl[row - range0] : 0.f;
        const float delta = row < n ? rowd[row - range0] : 0.f;
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int key_l = tx + 16 * i;
          const int key = kp + key_l;
          const bool valid = row < n && key < m;
          const float p = valid ? fast_exp2(fmaf(s[r][i], c2, -lse2)) : 0.f;
          float md = 1.f;
          if (use_dropout) {
            md = keep_element(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)key, threshold)
                     ? keep_scale
                     : 0.f;
          }
          dss[lrow * PLD + key_l] = p * (dp[r][i] * md - delta);
          pms[lrow * PLD + key_l] = p * md;
        }
      }
    }
    __syncthreads();  // the tile's ds and p md are in shared memory

    // dq = scale ds k over the pass's keys (ds = 0 and k = 0 past m)
    {
      float acc[4][C];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
      }
      const int keys = min(KP, (m - kp + 3) / 4 * 4);
      for (int j = 0; j < keys; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = *reinterpret_cast<const float4*>(dss + (ty + 16 * r) * PLD + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float kx[C];
          load_cols<DP>(kx, ks + (j + jj) * LD, tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = lane_of(pv[r], jj);
#pragma unroll
            for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, kx[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + ty + 16 * r;
        if (row < n) store_cols<DP>(dqb + (size_t)row * d, acc[r], scale, tx, d, vec, pass > 0);
      }
    }

    // dk += ds^T q and dv += (p md)^T g over the tile's rows
    const int rows = min(R, n - row0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float qx[C], gx[C];
      load_cols<DP>(qx, qs + r * LD, tx);
      load_cols<DP>(gx, gs + r * LD, tx);
#pragma unroll
      for (int h = 0; h < KG; ++h) {
        const float4 dsv = *reinterpret_cast<const float4*>(dss + r * PLD + 4 * ty + 64 * h);
        const float4 pmv = *reinterpret_cast<const float4*>(pms + r * PLD + 4 * ty + 64 * h);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = lane_of(dsv, e), b = lane_of(pmv, e);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            ak[4 * h + e][c] = fmaf(a, qx[c], ak[4 * h + e][c]);
            av[4 * h + e][c] = fmaf(b, gx[c], av[4 * h + e][c]);
          }
        }
      }
    }

    if (tile == tiles - 1) {  // the range is done: the block's partial of the pass's keys
#pragma unroll
      for (int h = 0; h < KG; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kp + 4 * ty + 64 * h + e;
          if (key < m) {
            store_cols<DP>(dk_part + part_base + (size_t)key * d, ak[4 * h + e], scale, tx, d,
                           vec, false);
            store_cols<DP>(dv_part + part_base + (size_t)key * d, av[4 * h + e], 1.f, tx, d,
                           vec, false);
          }
        }
      }
    }
    if (QB == 1 && it + 1 < total) {  // one buffer: the next tile's copy waits for this one
      const int nt = (it + 1) % tiles;
      __syncthreads();
      stage_f32<DP>(qbuf, qb, range0 + nt * R, R, n, d, vec, tid);
      stage_f32<DP>(gbuf, gb, range0 + nt * R, R, n, d, vec, tid);
      cp_async_commit();
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, void* dq, void* dk, void* dv,
                       float* dk_part, float* dv_part, int parts, int bh, int n, int m, int d,
                       int rows_per_split, int smem_bytes, float scale, int use_dropout,
                       uint32_t seed, const long long* seed_ptr, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  if (rows_per_split < 1 || rows_per_split % kBwdF32Rows != 0 ||
      rows_per_split > kBwdF32MaxRange) {
    return cudaErrorInvalidValue;
  }
  const int splits = (n + rows_per_split - 1) / rows_per_split;
  const int smem = f32_bwd_smem(DP);
  if (smem != smem_bytes || parts != splits || splits > 65535) return cudaErrorInvalidValue;
  auto kernel = attention_bwd_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                  aligned16(g) && aligned16(dq) && aligned16(dk_part) && aligned16(dv_part);
  kernel<<<dim3(bh, splits), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(g), lse, static_cast<float*>(dq),
      dk_part, dv_part, n, m, d, rows_per_split, scale, use_dropout, seed, seed_ptr, threshold,
      keep_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(0, dk_part, dv_part, dk, dv, parts, bh, m, d, stream);
}

// ---- mma_bf16 ---------------------------------------------------------------

constexpr int kBwdRows = 128;  // query rows per tile: 16 a warp in phase 2

// Key groups of a pass: the least power of two that covers kvr keys at kw a warp.
inline int key_groups(int kvr, int kw) {
  int kg = 1;
  while (kg * kw < kvr) kg <<= 1;
  return kg;
}

// KSTEPS = ceil(D / 16). KM: 16-key tiles a warp owns in phase 1.
template <int KSTEPS, int KM>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ g_out, const float* __restrict__ lse,
                         bf16* __restrict__ dq, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int n, int m, int d, int rows_per_split,
                         int kvr_alloc, int kg_count, float scale, int use_dropout,
                         uint32_t seed_value, const long long* __restrict__ seed_ptr,
                         uint32_t threshold, float keep_scale, int vec_flag) {
  constexpr int DPAD = KSTEPS * 16;
  constexpr int LD = DPAD + kMmaPad;
  constexpr int NT = DPAD / 8;
  constexpr int R = kBwdRows;
  constexpr int LDS = R + kMmaPad;  // row stride of ds^T
  constexpr int KW = 16 * KM;       // keys a warp owns
  constexpr int PASS = kMmaWarps * KW;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int NB2 = KSTEPS <= 4 ? KSTEPS : (KSTEPS == 5 ? 3 : 4);  // 16-column pairs at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kvr_alloc][LD]
  bf16* vs = ks + (size_t)kvr_alloc * LD;        // [kvr_alloc][LD]
  bf16* qs = vs + (size_t)kvr_alloc * LD;        // [R][LD]; phase 2 stages dq here
  bf16* gs = qs + R * LD;                        // [R][LD]
  bf16* dst = gs + R * LD;                       // [kvr_alloc][LDS]: ds^T of the tile
  float* lse_s = reinterpret_cast<float*>(dst + (size_t)kvr_alloc * LDS);  // [R]
  float* delta_s = lse_s + R;                                              // [R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int range0 = split * rows_per_split;
  const int range1 = min(n, range0 + rows_per_split);
  const int rg_count = kMmaWarps / kg_count;
  const int kg = warp % kg_count;  // the warp's key group
  const int rg = warp / kg_count;  // and its share of a tile's 16-row chunks
  const size_t parts = (size_t)gridDim.y * rg_count;
  const size_t part = (size_t)split * rg_count + rg;
  const bool vec = vec_flag != 0;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const float c2 = scale * kLog2e;
  const bf16* qb = q + (size_t)bh * n * d;
  const bf16* gb = g_out + (size_t)bh * n * d;
  const bf16* ob = o + (size_t)bh * n * d;
  const bf16* kb = k + (size_t)bh * m * d;
  const bf16* vb = v + (size_t)bh * m * d;
  bf16* dqb = dq + (size_t)bh * n * d;

  for (int kp = 0; kp < m; kp += PASS) {
    const int kv_n = min(PASS, m - kp);
    const int kvr = (kv_n + KW - 1) / KW * KW;  // staged keys; zero past m
    __syncthreads();                            // the previous pass is done with K and V
    stage_rows<DPAD>(ks, kb, kp, kvr, m, d, vec, tid, blockDim.x);
    stage_rows<DPAD>(vs, vb, kp, kvr, m, d, vec, tid, blockDim.x);
    const bool has_keys = kg * KW < kv_n;
    // the hash's terms in seed, bh and the first of this lane's keys
    const uint32_t key_hash =
        seed + (uint32_t)bh * kHashBh + (uint32_t)(kp + kg * KW + gq) * kHashCol;

    float dk_acc[KM][NT][4], dv_acc[KM][NT][4];
#pragma unroll
    for (int mt = 0; mt < KM; ++mt) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[mt][i][e] = 0.f;
          dv_acc[mt][i][e] = 0.f;
        }
      }
    }

    for (int row0 = range0; row0 < range1; row0 += R) {
      __syncthreads();  // the previous tile's phase 2 is done with qs and dst
      stage_rows<DPAD>(qs, qb, row0, R, n, d, vec, tid, blockDim.x);
      stage_rows<DPAD>(gs, gb, row0, R, n, d, vec, tid, blockDim.x);
      cp_async_commit();
      {  // delta = sum_d g_d o_d and the log-sum-exp of the tile's rows: two threads a row
        const int r = tid >> 1;
        const int sub = tid & 1;
        const int gr = row0 + r;
        float part_sum = 0.f;
        if (gr < n) {
          const bf16* grow = gb + (size_t)gr * d;
          const bf16* orow = ob + (size_t)gr * d;
          if (vec) {
            for (int c = sub * 8; c < d; c += 16) {
              const uint4 a = *reinterpret_cast<const uint4*>(grow + c);
              const uint4 b = *reinterpret_cast<const uint4*>(orow + c);
              const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
              const __nv_bfloat162* bhh = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 x = __bfloat1622float2(ah[e]);
                const float2 y = __bfloat1622float2(bhh[e]);
                part_sum = fmaf(x.x, y.x, part_sum);
                part_sum = fmaf(x.y, y.y, part_sum);
              }
            }
          } else {
            for (int c = sub; c < d; c += 2) {
              part_sum = fmaf(__bfloat162float(grow[c]), __bfloat162float(orow[c]), part_sum);
            }
          }
        }
        part_sum += __shfl_xor_sync(kFull, part_sum, 1);
        if (sub == 0) {
          delta_s[r] = part_sum;
          lse_s[r] = gr < n ? lse[(size_t)bh * n + gr] * kLog2e : 0.f;  // in units of log 2
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      // phase 1: the warp's keys against 16 rows at a time, everything transposed
      if (has_keys) {
        for (int rc = rg; rc < R / 16; rc += rg_count) {
          float st[KM][2][4], dpt[KM][2][4];
#pragma unroll
          for (int mt = 0; mt < KM; ++mt) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                st[mt][nt][e] = 0.f;
                dpt[mt][nt][e] = 0.f;
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t bq[4], bg[4];
            const int boff = (rc * 16 + (lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                             8 * ((lane >> 3) & 1);
            ldmatrix_x4(bq, qs + boff);
            ldmatrix_x4(bg, gs + boff);
#pragma unroll
            for (int mt = 0; mt < KM; ++mt) {
              uint32_t a[4];
              const int aoff = (kg * KW + mt * 16 + (lane & 15)) * LD + kk * 16 + 8 * (lane >> 4);
              ldmatrix_x4(a, ks + aoff);
              mma_bf16(st[mt][0], a, bq[0], bq[1]);
              mma_bf16(st[mt][1], a, bq[2], bq[3]);
              ldmatrix_x4(a, vs + aoff);
              mma_bf16(dpt[mt][0], a, bg[0], bg[1]);
              mma_bf16(dpt[mt][1], a, bg[2], bg[3]);
            }
          }
          uint32_t pa[KM][4], da[KM][4];  // (p md)^T and ds^T as A fragments
          const uint32_t row_hash = (uint32_t)(row0 + rc * 16 + 2 * t) * kHashRow;
#pragma unroll
          for (int mt = 0; mt < KM; ++mt) {
            float pm[2][4], ds[2][4], mdv[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) mdv[nt][e] = 1.f;
            }
            if (use_dropout) {
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const uint32_t h = key_hash + (uint32_t)(mt * 16 + 8 * (e >> 1)) * kHashCol +
                                     row_hash + (uint32_t)(nt * 8 + (e & 1)) * kHashRow;
                  mdv[nt][e] = keep_from_sum(h, (uint32_t)bh, threshold) ? keep_scale : 0.f;
                }
              }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key_l = kg * KW + mt * 16 + gq + 8 * (e >> 1);
                const int rl = rc * 16 + nt * 8 + 2 * t + (e & 1);
                // keys past m hold zeros and score 0: their p must not count
                const float p = key_l < kv_n ? fast_exp2(fmaf(st[mt][nt][e], c2, -lse_s[rl]))
                                             : 0.f;
                const float md = mdv[nt][e];
                pm[nt][e] = p * md;
                ds[nt][e] = p * (dpt[mt][nt][e] * md - delta_s[rl]);
              }
            }
            pa[mt][0] = pack_bf16(pm[0][0], pm[0][1]);
            pa[mt][1] = pack_bf16(pm[0][2], pm[0][3]);
            pa[mt][2] = pack_bf16(pm[1][0], pm[1][1]);
            pa[mt][3] = pack_bf16(pm[1][2], pm[1][3]);
            da[mt][0] = pack_bf16(ds[0][0], ds[0][1]);
            da[mt][1] = pack_bf16(ds[0][2], ds[0][3]);
            da[mt][2] = pack_bf16(ds[1][0], ds[1][1]);
            da[mt][3] = pack_bf16(ds[1][2], ds[1][3]);
            bf16* drow = dst + (size_t)(kg * KW + mt * 16 + gq) * LDS + rc * 16 + 2 * t;
            *reinterpret_cast<uint32_t*>(drow) = da[mt][0];
            *reinterpret_cast<uint32_t*>(drow + 8 * LDS) = da[mt][1];
            *reinterpret_cast<uint32_t*>(drow + 8) = da[mt][2];
            *reinterpret_cast<uint32_t*>(drow + 8 * LDS + 8) = da[mt][3];
          }
#pragma unroll
          for (int dp = 0; dp < NT / 2; ++dp) {
            uint32_t b[4];
            const int boff = (rc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + dp * 16 +
                             8 * (lane >> 4);
            ldmatrix_x4_trans(b, gs + boff);
#pragma unroll
            for (int mt = 0; mt < KM; ++mt) {
              mma_bf16(dv_acc[mt][2 * dp], pa[mt], b[0], b[1]);
              mma_bf16(dv_acc[mt][2 * dp + 1], pa[mt], b[2], b[3]);
            }
            ldmatrix_x4_trans(b, qs + boff);
#pragma unroll
            for (int mt = 0; mt < KM; ++mt) {
              mma_bf16(dk_acc[mt][2 * dp], da[mt], b[0], b[1]);
              mma_bf16(dk_acc[mt][2 * dp + 1], da[mt], b[2], b[3]);
            }
          }
        }
      }
      __syncthreads();  // ds^T of the tile is complete; Q is no longer needed

      // phase 2: dq = scale ds k for the warp's 16 rows, NB2 column pairs at a time
      bf16* qw = qs + warp * 16 * LD;
#pragma unroll
      for (int p0 = 0; p0 < NT / 2; p0 += NB2) {
        float acc[2 * NB2][4];
#pragma unroll
        for (int i = 0; i < 2 * NB2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        }
        for (int kk = 0; kk < kvr / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, dst + (size_t)(kk * 16 + (lane & 7) + 8 * (lane >> 4)) * LDS +
                                   warp * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int pp = 0; pp < NB2; ++pp) {
            if (p0 + pp < NT / 2) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, ks + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                       (p0 + pp) * 16 + 8 * (lane >> 4));
              mma_bf16(acc[2 * pp], a, b[0], b[1]);
              mma_bf16(acc[2 * pp + 1], a, b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2 * NB2; ++i) {
          if (2 * p0 + i < NT) {
            const int col = (2 * p0 + i) * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(qw + gq * LD + col) =
                pack_bf16(acc[i][0] * scale, acc[i][1] * scale);
            *reinterpret_cast<uint32_t*>(qw + (gq + 8) * LD + col) =
                pack_bf16(acc[i][2] * scale, acc[i][3] * scale);
          }
        }
      }
      __syncwarp();  // rows warp * 16 .. + 15 of qs are this warp's alone
      {
        const int wrow0 = row0 + warp * 16;
        const bool add = kp > 0;  // a later key pass adds to what the earlier wrote
        if (vec && !add) {
          const int cpr = d / 8;
          for (int i = lane; i < 16 * cpr; i += 32) {
            const int r = i / cpr;
            const int c = (i - r * cpr) * 8;
            if (wrow0 + r < n) {
              *reinterpret_cast<uint4*>(dqb + (size_t)(wrow0 + r) * d + c) =
                  *reinterpret_cast<const uint4*>(qw + r * LD + c);
            }
          }
        } else {
          for (int i = lane; i < 16 * d; i += 32) {
            const int r = i / d;
            const int c = i - r * d;
            if (wrow0 + r < n) {
              bf16* dst_e = dqb + (size_t)(wrow0 + r) * d + c;
              const float x = __bfloat162float(qw[r * LD + c]);
              *dst_e = __float2bfloat16(add ? x + __bfloat162float(*dst_e) : x);
            }
          }
        }
      }
    }

    // this block's share of dk and dv for the pass's keys: one partial per row group
    if (has_keys) {
#pragma unroll
      for (int mt = 0; mt < KM; ++mt) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kp + kg * KW + mt * 16 + gq + 8 * (e >> 1);
            const int col = i * 8 + 2 * t + (e & 1);
            if (key < m && col < d) {
              const size_t at = (((size_t)bh * parts + part) * m + key) * d + col;
              dk_part[at] = dk_acc[mt][i][e] * scale;
              dv_part[at] = dv_acc[mt][i][e];
            }
          }
        }
      }
    }
  }
}

template <int KSTEPS, int KM>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, void* dq, void* dk, void* dv,
                       float* dk_part, float* dv_part, int parts, int bh, int n, int m, int d,
                       int rows_per_split, int smem_bytes, float scale, int use_dropout,
                       uint32_t seed, const long long* seed_ptr, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  constexpr int DPAD = KSTEPS * 16;
  constexpr int KW = 16 * KM;
  constexpr int PASS = kMmaWarps * KW;
  if (rows_per_split < 1 || rows_per_split % kBwdRows != 0) return cudaErrorInvalidValue;
  const int kvr_alloc = ((m < PASS ? m : PASS) + KW - 1) / KW * KW;
  const int kg_count = key_groups(kvr_alloc, KW);
  const int splits = (n + rows_per_split - 1) / rows_per_split;
  const int smem = (2 * kvr_alloc * (DPAD + kMmaPad) + 2 * kBwdRows * (DPAD + kMmaPad) +
                    kvr_alloc * (kBwdRows + kMmaPad)) * 2 + 2 * kBwdRows * 4;
  if (smem != smem_bytes || parts != splits * (kMmaWarps / kg_count) || splits > 65535) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attention_bwd_mma_kernel<KSTEPS, KM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                  aligned16(g) && aligned16(dq);
  kernel<<<dim3(bh, splits), kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), lse, static_cast<bf16*>(dq),
      dk_part, dv_part, n, m, d, rows_per_split, kvr_alloc, kg_count, scale, use_dropout, seed,
      seed_ptr, threshold, keep_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(1, dk_part, dv_part, dk, dv, parts, bh, m, d, stream);
}

// ---- small_m ------------------------------------------------------------------

// MM: keys the register accumulators hold (4 or 8, m <= MM).
template <typename T, int G, int MM>
__global__ void __launch_bounds__(kSmallThreads)
attention_bwd_small_m_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g_out,
                             const float* __restrict__ lse,
                             T* __restrict__ dq, float* __restrict__ dk_part,
                             float* __restrict__ dv_part, int n, int m, int d,
                             int rows_per_split, float scale, int use_dropout,
                             uint32_t seed_value, const long long* __restrict__ seed_ptr,
                             uint32_t threshold, float keep_scale, int vec_flag) {
  constexpr int DS = 8 * G;
  constexpr int RPP = kSmallThreads / G;
  constexpr int WARPS = kSmallThreads / 32;
  __shared__ __align__(16) float ks[MM * DS];
  __shared__ __align__(16) float vs[MM * DS];
  __shared__ __align__(16) float red[WARPS * MM * DS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = tid % G;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int range0 = split * rows_per_split;
  const int range1 = min(n, range0 + rows_per_split);
  const bool vec = vec_flag != 0;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  stage_small_kv<T, DS>(ks, vs, k + (size_t)bh * m * d, v + (size_t)bh * m * d, m, d, tid);
  __syncthreads();

  float ak[MM][8], av[MM][8];
#pragma unroll
  for (int jk = 0; jk < MM; ++jk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ak[jk][i] = 0.f;
      av[jk][i] = 0.f;
    }
  }

  for (int base = range0; base < range1; base += RPP) {
    const int row = base + tid / G;
    const bool valid = row < range1;
    const size_t off = ((size_t)bh * n + row) * d;
    float qx[8], gx[8];
    load_row8<G>(qx, q + off, j, d, valid, vec);
    load_row8<G>(gx, g_out + off, j, d, valid, vec);
    const float lse_r = valid ? lse[(size_t)bh * n + row] : 0.f;
    float ds[MM], pm[MM], pr[MM];
    // delta = sum_j p_j md_j dp_j: with every key at hand the row term of the softmax
    // transpose is formed exactly, and the saved output is not read
    float delta = 0.f;
#pragma unroll
    for (int jk = 0; jk < MM; ++jk) {
      ds[jk] = 0.f;  // holds dp md until delta is known
      pm[jk] = 0.f;
      pr[jk] = 0.f;
      if (jk < m) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = jk * DS + small_col<T, G>(j, i);
          sp = fmaf(qx[i], ks[c], sp);
          dpp = fmaf(gx[i], vs[c], dpp);
        }
        const float s = group_sum<G>(sp);
        const float dp = group_sum<G>(dpp);
        pr[jk] = valid ? expf(s * scale - lse_r) : 0.f;
        float md = 1.f;
        if (use_dropout) {
          md = keep_element(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)jk, threshold)
                   ? keep_scale
                   : 0.f;
        }
        pm[jk] = pr[jk] * md;
        ds[jk] = dp * md;
        delta = fmaf(pm[jk], dp, delta);
      }
    }
#pragma unroll
    for (int jk = 0; jk < MM; ++jk) ds[jk] = pr[jk] * (ds[jk] - delta);
    float dqx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) dqx[i] = 0.f;
#pragma unroll
    for (int jk = 0; jk < MM; ++jk) {
      if (jk < m) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dqx[i] = fmaf(ds[jk], ks[jk * DS + small_col<T, G>(j, i)], dqx[i]);
          ak[jk][i] = fmaf(ds[jk], qx[i], ak[jk][i]);
          av[jk][i] = fmaf(pm[jk], gx[i], av[jk][i]);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dqx[i] *= scale;
      store_row8<G>(dq + off, dqx, j, d, vec);
    }
  }

  // the block's share of dk, then of dv: over the warp's row groups by shuffles,
  // over the warps through shared memory in warp order
  const size_t part_base = ((size_t)bh * gridDim.y + split) * m * d;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int jk = 0; jk < MM; ++jk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = which == 0 ? ak[jk][i] : av[jk][i];
#pragma unroll
        for (int o2 = G; o2 < 32; o2 <<= 1) x += __shfl_xor_sync(kFull, x, o2);
        if (lane < G) red[(warp * MM + jk) * DS + small_col<T, G>(j, i)] = x;
      }
    }
    __syncthreads();
    float* part = which == 0 ? dk_part : dv_part;
    const float mult = which == 0 ? scale : 1.f;
    for (int idx = tid; idx < m * DS; idx += kSmallThreads) {
      const int jk = idx / DS;
      const int c = idx - jk * DS;
      if (c < d) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red[(w * MM + jk) * DS + c];
        part[part_base + (size_t)jk * d + c] = sum * mult;
      }
    }
    __syncthreads();
  }
}

template <typename T, int G, int MM>
cudaError_t launch_small_m(int dtype, const void* q, const void* k, const void* v,
                           const void* o, const void* g, const float* lse, void* dq, void* dk,
                           void* dv, float* dk_part, float* dv_part, int parts, int bh, int n,
                           int m, int d, int rows_per_split, float scale, int use_dropout,
                           uint32_t seed, const long long* seed_ptr, uint32_t threshold,
                           float keep_scale, cudaStream_t stream) {
  if (rows_per_split < 1 || rows_per_split % (kSmallThreads / 8) != 0) {
    return cudaErrorInvalidValue;
  }
  const int splits = (n + rows_per_split - 1) / rows_per_split;
  if (parts != splits || splits > 65535) return cudaErrorInvalidValue;
  const int vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(q) && aligned16(g) &&
                  aligned16(dq);
  attention_bwd_small_m_kernel<T, G, MM><<<dim3(bh, splits), kSmallThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, static_cast<T*>(dq), dk_part, dv_part, n, m, d,
      rows_per_split, scale, use_dropout, seed, seed_ptr, threshold,
      keep_scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(dtype, dk_part, dv_part, dk, dv, parts, bh, m, d, stream);
}

template <typename T>
cudaError_t dispatch_small_m(int dtype, const void* q, const void* k, const void* v,
                             const void* o, const void* g, const float* lse, void* dq,
                             void* dk, void* dv, float* dk_part, float* dv_part, int parts,
                             int bh, int n, int m, int d, int rows_per_split, float scale,
                             int use_dropout, uint32_t seed, const long long* seed_ptr,
                             uint32_t threshold, float keep_scale, cudaStream_t stream) {
#define STCD_SMALL(G, MM)                                                                   \
  launch_small_m<T, G, MM>(dtype, q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, parts, \
                           bh, n, m, d, rows_per_split, scale, use_dropout, seed, seed_ptr, \
                           threshold, keep_scale, stream)
  if (d <= 64) return m <= 4 ? STCD_SMALL(8, 4) : STCD_SMALL(8, 8);
  return m <= 4 ? STCD_SMALL(16, 4) : STCD_SMALL(16, 8);
#undef STCD_SMALL
}

}  // namespace

// q, o, g, dq: (bh, n, d); k, v, dk, dv: (bh, m, d); lse: float32 (bh, n) as the
// forward wrote it; dk_part, dv_part: float32 scratch of (bh, parts, m, d). All
// contiguous on `device`. dtype: 0 = float32, 1 = bfloat16 (every tensor but lse
// and the scratch). variant: kVariantF32 (float32 only), kVariantMma (bfloat16 only) or
// kVariantSmallM (m <= 8). rows_per_split: the query rows a block owns; parts:
// the partials a head leaves in the scratch; smem_bytes: the block's dynamic
// shared memory; all three as the wrapper sized them, and the call is refused
// when they are not the kernel's own. seed_ptr: a device int64 whose low 32 bits
// are the dropout seed, or null to take `seed`. Returns a cudaError_t.
extern "C" int stcd_cross_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const float* lse,
                                        void* dq, void* dk, void* dv, float* dk_part,
                                        float* dv_part, int parts, int bh, int n, int m,
                                        int d, int dtype, int variant, int rows_per_split,
                                        int smem_bytes, float scale, int use_dropout,
                                        unsigned int seed, const long long* seed_ptr,
                                        unsigned int threshold, float keep_scale,
                                        int device, void* stream) {
  if (bh < 1 || n < 1 || m < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STCD_BWD_ARGS q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part
#define STCD_BWD_TAIL scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s
  if (variant == kVariantF32) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
#define STCD_F32(DP)                                                                        \
  launch_f32<DP>(STCD_BWD_ARGS, parts, bh, n, m, d, rows_per_split, smem_bytes, STCD_BWD_TAIL)
    switch (f32_dpad(d)) {
      case 32: err = STCD_F32(32); break;
      case 48: err = STCD_F32(48); break;
      case 64: err = STCD_F32(64); break;
      case 80: err = STCD_F32(80); break;
      default: err = STCD_F32(128); break;
    }
#undef STCD_F32
  } else if (variant == kVariantMma) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
#define STCD_MMA(KSTEPS, KM)                                                            \
  launch_mma<KSTEPS, KM>(STCD_BWD_ARGS, parts, bh, n, m, d, rows_per_split, smem_bytes, \
                         STCD_BWD_TAIL)
    if (d <= 32) err = STCD_MMA(2, 2);
    else if (d <= 64) err = STCD_MMA(4, 2);
    else if (d <= 80) err = STCD_MMA(5, 2);
    else err = STCD_MMA(8, 1);
#undef STCD_MMA
  } else if (variant == kVariantSmallM) {
    if (m > kSmallM || smem_bytes != 0) return (int)cudaErrorInvalidValue;
    err = dtype == 0 ? dispatch_small_m<float>(dtype, STCD_BWD_ARGS, parts, bh, n, m, d,
                                               rows_per_split, STCD_BWD_TAIL)
                     : dispatch_small_m<bf16>(dtype, STCD_BWD_ARGS, parts, bh, n, m, d,
                                              rows_per_split, STCD_BWD_TAIL);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef STCD_BWD_ARGS
#undef STCD_BWD_TAIL
  return (int)err;
}
