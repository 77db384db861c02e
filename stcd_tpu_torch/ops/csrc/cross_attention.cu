// Cross-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v,
// with optional attention-matrix dropout after normalisation.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/attention.py::_attention_kernel
// (launched by _flash_fwd). It computes the same function but is written for
// the GPU rather than carried over block by block:
//
// Three variants; the wrapper picks one from (dtype, M) alone:
//
// mma_bf16 (bf16, M > 8). What bounds it: by the count, 4 N M D operations a
//   head at the tensor-core rate against q, k, v, o once, and at the
//   ChangeFormerV6 shapes the two are within a factor of two of each other. As
//   measured, neither: the time goes to instruction issue and latency, of the
//   softmax on the accumulator fragments and, with dropout, of the hash (about
//   19 integer instructions an element, as many again as all the rest). So the
//   design keeps the products and the bytes cheap and then buys warps:
//   - Both products run on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
//     accumulators) fed by ldmatrix. mma.sync was taken over wgmma: a warp owns
//     its query rows and needs no other warp, so the kernel has no barrier after
//     K and V are staged, and the tensor pipe is not what holds it (two blocks
//     of 8 warps an SM beat one block whose warps read half as many fragments).
//   - K and V of the head are staged ONCE per block as bf16 by 16-byte cp.async
//     into rows padded by 16 bytes (conflict-free ldmatrix), and stay resident
//     while the block's 8 warps walk `rows_per_block` query rows; a warp owns a
//     tile of 16 rows (D <= 64 and D > 80) or 32 rows (64 < D <= 80, where
//     shared memory holds one block an SM anyway and a K or V fragment then
//     feeds two products) and prefetches its next tile by cp.async into the
//     second of its two buffers during the current tile's math. If M is too
//     large for shared memory, K and V go through in blocks of kv_rows keys.
//   - Softmax is online over chunks of 64 keys, in registers on the accumulator
//     fragment (row max and sum over the quad by shuffles; exp as one ex2 of a
//     fused multiply-add); the C fragment of q k^T, rounded to bf16, is the A
//     fragment of p v, so p never leaves the registers. A chunk whose 64 keys
//     all exist runs code without a branch, so that the compiler can move the
//     ldmatrix loads ahead of the products. Dropout is in the numerator only;
//     each thread derives the (global row, col) of its fragment elements, sums
//     the hash's linear part from per-row and per-chunk terms and takes the
//     keep decision of keep_element; 1 / (1 - rate) is applied once at the end.
//   - The output tile is staged through the warp's Q buffer and written with
//     16-byte stores. D is zero-filled to the next multiple of 16 in shared
//     memory; when D is not a multiple of 8 (or a pointer is not 16-byte
//     aligned) rows are staged and stored element-wise. The row max is taken
//     before scaling, so scale must be positive (the wrapper checks).
//
// small_m (M <= 8, f32 or bf16; BIT's decoder has M = 4). What bounds it:
//   bytes (q read, o written once; the products are 4 M D operations a row).
//   A group of 8 or 16 lanes owns a query row and each lane 8 of its columns,
//   read and written as 16-byte pieces on neighbouring addresses; K and V of
//   the head (at most 8 x 128 values) sit in shared memory as f32; scores are
//   reduced over the group by shuffles and the softmax over M is in registers.
//   Math is f32 on the CUDA cores.
//
// f32_cuda (f32, M > 8; served fp32, where TF32 stays off). What bounds it:
//   the f32 rate of the CUDA cores, 67 TFLOP/s, against 4 N M D + 5 N M
//   operations a head; q, k, v and o once at the memory rate take from two
//   thirds of that time (N = 4096) to as much (N = 64) at the serving shapes.
//   So the design cuts the shared-memory and shuffle traffic per multiply-add
//   and moves each byte once:
//   - K and V of the head are staged once per block by cp.async as f32 rows
//     padded to an odd number of 16-byte pieces, and stay resident while the
//     block walks `rows_per_block` query rows in tiles of 64, the next tile's
//     copy in flight during the current one's math (if M is too large for
//     shared memory, K and V go through in blocks of kv_rows keys).
//   - Both products are register micro-tiles: a thread owns 4 rows x 4 keys of
//     q k^T, read as float4 along D (one shared-memory read per eight
//     multiply-adds), and 4 rows x 4-8 output columns of p v. p goes through
//     shared memory once per step of 64 keys; there is no shuffle per (key,
//     row) pair: a row's max takes four shuffles over a half warp per step, its
//     sum four at the end.
//   - The row max is of the scaled scores, so any sign of scale is taken.
//
// All variants:
// - Softmax is online over the chunks: a running max, a denominator and an
//   f32 accumulator per row, so any M works and the (N, M) matrix never
//   leaves the SM.
// - Dropout fits the online form: o = (sum_j e_j md_j v_j) / sum_j e_j. The
//   numerator carries the keep mask (md = keep / (1 - rate)), the
//   denominator does not, and both are rescaled by the same running max. The
//   keep decision is the stateless hash of dropout_keep_mask
//   (stcd_tpu/ops/attention.py:38-63) on (seed, bh, global row, col), in
//   plain uint32 arithmetic, so the mask is bit-identical to the JAX and the
//   plain PyTorch versions.
// - f32 accumulation, output in q's dtype. Any N and M (ragged tiles and
//   chunks are masked); D <= 128.
// - When the caller will need the gradient it also writes each row's
//   log-sum-exp of the scaled scores, from which cross_attention_bwd.cu
//   rebuilds the softmax in one pass.

#include <type_traits>

#include "attention_common.cuh"
#include "device_guard.cuh"

namespace {

using namespace stcd;

// ---- f32_cuda -----------------------------------------------------------------

constexpr int kF32Rows = 64;     // query rows of a tile
constexpr int kF32Keys = 64;     // keys of an online-softmax step
constexpr int kF32PLd = kF32Keys + 4;  // padded row of the p tile

// Bytes of the two Q tiles (the current one and the next one's copy in flight)
// and the p tile.
inline int f32_tile_bytes(int dpad) { return (2 * kF32Rows * (dpad + 4) + kF32Rows * kF32PLd) * 4; }

// Keys that fit beside the Q and p tiles, in whole steps.
inline int f32_kv_rows(int m, int dpad) {
  const int ld = dpad + 4;
  const int cap = (kMaxSmem - f32_tile_bytes(dpad)) / (2 * ld * 4) / kF32Keys * kF32Keys;
  const int want = (m + kF32Keys - 1) / kF32Keys * kF32Keys;
  return want < cap ? want : cap;
}

// DP: D padded (32, 48, 64, 80 or 128). A block of 256 threads walks tiles of
// 64 query rows; thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 r
// (r < 4). In q k^T it owns keys tx + 16 i (i < 4) of each step of 64: a 4 x 4
// micro-tile from float4 reads of q and k along D, one shared-memory read per
// eight multiply-adds. In p v it owns the output columns 4 tx + 64 g (a float4
// for g < G4) and 64 G4 + tx + 16 u (one column for u < G1): a 4 x (4 G4 + G1)
// micro-tile from a float4 of p (four keys of a row) and the owned columns of
// v. p goes through shared memory once a step; the row max is reduced over
// the 16 lanes of a half warp by shuffles, the row sums at the end only.
template <int DP>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int n, int m, int d, int rows_per_block,
                         int kv_rows, float scale, int use_dropout, uint32_t seed_value,
                         const long long* __restrict__ seed_ptr, uint32_t threshold,
                         float keep_scale, HashRows hrows, int vec_flag) {
  constexpr int LD = DP + 4;
  constexpr int G4 = DP / 64, G1 = (DP % 64) / 16, C = 4 * G4 + G1;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                   // [kv_rows][LD]
  float* vs = ks + kv_rows * LD;     // [kv_rows][LD]
  float* qbuf = vs + kv_rows * LD;   // [2][64][LD]: this tile's Q and the next one's
  float* ps = qbuf + 2 * kF32Rows * LD;  // [64][kF32PLd]: this step's numerator weights
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const uint32_t hbh = hash_bh(bh, hrows);  // the head's row of the global batch
  const int block_row0 = blockIdx.y * rows_per_block;
  const int row_end = min(n, block_row0 + rows_per_block);
  const bool vec = vec_flag != 0;
  const bool resident = m <= kv_rows;  // K and V stay in shared memory for the whole block
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const float c2 = scale * kLog2e;  // scores in units of log 2: exp(scale s) = 2^(c2 s)
  const float* qb = q + (size_t)bh * n * d;
  const float* kb = k + (size_t)bh * m * d;
  const float* vb = v + (size_t)bh * m * d;
  float* ob = o + (size_t)bh * n * d;
  const int steps_rows = (m + kF32Keys - 1) / kF32Keys * kF32Keys;

  if (resident) {  // rows past m up to the step's end are zero
    stage_f32<DP>(ks, kb, 0, steps_rows, m, d, vec, tid);
    stage_f32<DP>(vs, vb, 0, steps_rows, m, d, vec, tid);
  }
  stage_f32<DP>(qbuf, qb, block_row0, kF32Rows, n, d, vec, tid);  // rows past n: zero
  cp_async_commit();
  for (int row0 = block_row0, it = 0; row0 < row_end; row0 += kF32Rows, ++it) {
    // the next tile's copy is in flight during this tile's math (the previous
    // tile's last barrier freed its buffer)
    const float* qs = qbuf + (it & 1) * kF32Rows * LD;
    if (row0 + kF32Rows < row_end) {
      stage_f32<DP>(qbuf + ((it + 1) & 1) * kF32Rows * LD, qb, row0 + kF32Rows, kF32Rows, n, d,
                    vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile (and K, V) have landed
    float m_run[4], l_run[4], acc[4][C];  // l_run: this thread's share of the row sums
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m_run[r] = -INFINITY;
      l_run[r] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    }
    for (int sc = 0; sc < m; sc += kv_rows) {
      const int kv_n = min(kv_rows, m - sc);
      if (!resident) {
        __syncthreads();  // every thread is done with the previous keys
        const int rows = (kv_n + kF32Keys - 1) / kF32Keys * kF32Keys;
        stage_f32<DP>(ks, kb, sc, rows, m, d, vec, tid);
        stage_f32<DP>(vs, vb, sc, rows, m, d, vec, tid);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();  // Q (and K, V) are staged
      for (int c0 = 0; c0 < kv_n; c0 += kF32Keys) {
        const float* kst = ks + c0 * LD;  // keys sc + c0 on: the block staged from sc
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < DP; c += 4) {
          float4 qv[4], kv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * LD + c);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = *reinterpret_cast<const float4*>(kst + (tx + 16 * i) * LD + c);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[r][i] = fmaf(qv[r].x, kv[i].x, s[r][i]);
              s[r][i] = fmaf(qv[r].y, kv[i].y, s[r][i]);
              s[r][i] = fmaf(qv[r].z, kv[i].z, s[r][i]);
              s[r][i] = fmaf(qv[r].w, kv[i].w, s[r][i]);
            }
          }
        }
        // online softmax over this step's keys; keys past m are masked
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[r][i] = c0 + tx + 16 * i < kv_n ? s[r][i] * c2 : -INFINITY;
            mx = fmaxf(mx, s[r][i]);
          }
          const float m_new = fmaxf(m_run[r], half_warp_max(mx));
          const float alpha = fast_exp2(m_run[r] - m_new);  // 0 on the first step
          m_run[r] = m_new;
          l_run[r] *= alpha;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
          const int row = ty + 16 * r;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = fast_exp2(s[r][i] - m_new);  // 0 for a masked key
            l_run[r] += e;
            float w = e;  // the numerator takes the keep mask, the denominator does not
            if (use_dropout &&
                !keep_element(seed, hbh, (uint32_t)(row0 + row),
                              (uint32_t)(sc + c0 + tx + 16 * i), threshold)) {
              w = 0.f;
            }
            ps[row * kF32PLd + tx + 16 * i] = w;
          }
        }
        __syncthreads();  // the p tile is complete
        // acc += p v over the step's keys (p = 0 and v = 0 past m)
        const float* vst = vs + c0 * LD;
        const int keys = min(kF32Keys, (kv_n - c0 + 3) / 4 * 4);
        for (int j = 0; j < keys; j += 4) {
          float4 pv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pv[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * kF32PLd + j);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float* vrow = vst + (j + jj) * LD;
            float vv[C];
            load_cols<DP>(vv, vrow, tx);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float p = lane_of(pv[r], jj);
#pragma unroll
              for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
            }
          }
        }
        __syncthreads();  // the p tile is free for the next step
      }
    }
    // normalise and store; each row's log-sum-exp of the scaled scores
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float l = half_warp_sum(l_run[r]);
      const int row = row0 + ty + 16 * r;
      if (row >= n) continue;
      const float inv = keep_scale / l;  // keep_scale is 1 without dropout
      float* orow = ob + (size_t)row * d;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const int col = 4 * tx + 64 * g;
        if (vec && col + 4 <= d) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv,
                          acc[r][4 * g + 2] * inv, acc[r][4 * g + 3] * inv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < d) orow[col + e] = acc[r][4 * g + e] * inv;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < G1; ++u) {
        const int col = 64 * G4 + tx + 16 * u;
        if (col < d) orow[col] = acc[r][4 * G4 + u] * inv;
      }
      if (lse != nullptr && tx == 0) lse[(size_t)bh * n + row] = m_run[r] * kLn2 + logf(l);
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int n, int m, int d, int rows_per_block, int smem_bytes, float scale,
                       int use_dropout, uint32_t seed, const long long* seed_ptr,
                       uint32_t threshold, float keep_scale, HashRows hrows, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  const int kv_rows = f32_kv_rows(m, DP);
  const int smem = 2 * kv_rows * LD * 4 + f32_tile_bytes(DP);
  if (smem != smem_bytes || rows_per_block < 1 || rows_per_block % kF32Rows != 0) {
    return cudaErrorInvalidValue;
  }
  const int blocks_y = (n + rows_per_block - 1) / rows_per_block;
  if (blocks_y > 65535) return cudaErrorInvalidValue;
  auto kernel = attention_fwd_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  kernel<<<dim3(bh, blocks_y), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, n, m, d, rows_per_block, kv_rows, scale, use_dropout, seed,
      seed_ptr, threshold, keep_scale, hrows, vec);
  return cudaGetLastError();
}

// ---- mma_bf16 ---------------------------------------------------------------

constexpr int kKeyChunk = 64;  // keys per online-softmax step of the tensor-core kernel

// KSTEPS = ceil(D / 16): k-steps of the score product. MT: 16-row tiles a warp
// owns (with two, a K or V fragment read from shared memory feeds two
// products). MINB: blocks an SM should hold.
template <int KSTEPS, int MT, int MINB>
__global__ void __launch_bounds__(kMmaWarps * 32, MINB)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int n, int m, int d, int rows_per_block,
                         int kv_rows, float scale, int use_dropout, uint32_t seed_value,
                         const long long* __restrict__ seed_ptr, uint32_t threshold,
                         float keep_scale, HashRows hrows, int vec_flag) {
  constexpr int DPAD = KSTEPS * 16;
  constexpr int LD = DPAD + kMmaPad;
  constexpr int NT = DPAD / 8;       // 8-column tiles of the output
  constexpr int WR = MT * kMmaRows;  // query rows a warp owns
  constexpr int NS = kKeyChunk / 8;  // 8-key tiles of a chunk
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kv_rows][LD]
  bf16* vs = ks + (size_t)kv_rows * LD;          // [kv_rows][LD]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  bf16* qbuf = vs + (size_t)kv_rows * LD + warp * 2 * WR * LD;  // this warp's two Q tiles

  const int bh = blockIdx.x;
  const uint32_t hbh = hash_bh(bh, hrows);  // the head's row of the global batch
  const int block_row0 = blockIdx.y * rows_per_block;
  const int rounds = rows_per_block / (kMmaWarps * WR);
  const bool vec = vec_flag != 0;
  const bool resident = m <= kv_rows;  // K and V stay in shared memory for the whole block
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const float c2 = scale * kLog2e;  // exp(scale x) = 2^(c2 x)
  const bf16* qb = q + (size_t)bh * n * d;
  const bf16* kb = k + (size_t)bh * m * d;
  const bf16* vb = v + (size_t)bh * m * d;
  bf16* ob = o + (size_t)bh * n * d;

  if (resident) {
    const int rows = ((m + 15) / 16) * 16;
    stage_rows<DPAD>(ks, kb, 0, rows, m, d, vec, tid, blockDim.x);
    stage_rows<DPAD>(vs, vb, 0, rows, m, d, vec, tid, blockDim.x);
  }
  {
    const int row0 = block_row0 + warp * WR;
    if (row0 < n) stage_rows<DPAD>(qbuf, qb, row0, WR, n, d, vec, lane, 32);
  }
  cp_async_commit();

  for (int round = 0; round < rounds; ++round) {
    const int row0 = block_row0 + (round * kMmaWarps + warp) * WR;
    const bool active = row0 < n;  // warp-uniform
    bf16* qcur = qbuf + (round & 1) * WR * LD;
    {  // the next tile's copy is in flight during this tile's math
      const int next0 = row0 + kMmaWarps * WR;
      if (round + 1 < rounds && next0 < n) {
        stage_rows<DPAD>(qbuf + ((round + 1) & 1) * WR * LD, qb, next0, WR, n, d, vec, lane,
                         32);
      }
      cp_async_commit();
    }
    cp_async_wait<1>();  // all but the newest group: K, V and this tile have landed
    if (round == 0) __syncthreads(); else __syncwarp();

    uint32_t qf[MT][KSTEPS][4];
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          ldmatrix_x4(qf[mt][kk],
                      qcur + (mt * 16 + (lane & 15)) * LD + kk * 16 + 8 * (lane >> 4));
        }
      }
    }
    float m_run[MT][2], l_run[MT][2];  // l_run: this thread's share of the row sums
    float oacc[MT][NT][4];
    uint32_t row_hash[MT][2];  // the hash's terms in seed, bh and row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[mt][r] = -INFINITY;
        l_run[mt][r] = 0.f;
        row_hash[mt][r] = seed + hbh * kHashBh +
                          (uint32_t)(row0 + mt * 16 + g + 8 * r) * kHashRow;
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][i][e] = 0.f;
      }
    }

    for (int sc = 0; sc < m; sc += kv_rows) {
      const int kv_n = min(kv_rows, m - sc);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous keys
        const int rows = ((kv_n + 15) / 16) * 16;
        stage_rows<DPAD>(ks, kb, sc, rows, m, d, vec, tid, blockDim.x);
        stage_rows<DPAD>(vs, vb, sc, rows, m, d, vec, tid, blockDim.x);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      // One chunk of 64 keys. FULL: every key of the chunk exists, so the code has
      // no branch and the compiler may move the ldmatrix loads ahead of the products.
      auto chunk = [&](auto full_tag, const int c0, const int nvalid) {
        constexpr bool FULL = decltype(full_tag)::value;
        float s[MT][NS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.f;
          }
        }
        // s = q k^T: 16 keys (two 8-key tiles) per ldmatrix
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
          for (int jp = 0; jp < NS / 2; ++jp) {
            if (FULL || jp * 16 < nvalid) {
              uint32_t b[4];
              ldmatrix_x4(b, ks + (c0 + jp * 16 + (lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                                 8 * ((lane >> 3) & 1));
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(s[mt][2 * jp], qf[mt][kk], b[0], b[1]);
                mma_bf16(s[mt][2 * jp + 1], qf[mt][kk], b[2], b[3]);
              }
            }
          }
        }
        const uint32_t col_hash = (uint32_t)(sc + c0 + 2 * t) * kHashCol;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // keys past m masked; row max over the chunk, of the raw products (scale > 0)
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < NS; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (!FULL && i * 8 + 2 * t + (e & 1) >= nvalid) s[mt][i][e] = -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][i][e]);
            }
          }
          float neg_max[2];  // -max in units of log 2
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[mt][r], quad_max(mx[r]));
            const float alpha = fast_exp2((m_run[mt][r] - m_new) * c2);  // 0 on the first chunk
            m_run[mt][r] = m_new;
            neg_max[r] = -m_new * c2;
            l_run[mt][r] *= alpha;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              oacc[mt][i][2 * r] *= alpha;
              oacc[mt][i][2 * r + 1] *= alpha;
            }
          }
          // e = exp(scale (s - max)), 0 for a masked key: the denominator takes e
#pragma unroll
          for (int i = 0; i < NS; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ev = fast_exp2(fmaf(s[mt][i][e], c2, neg_max[e >> 1]));
              l_run[mt][e >> 1] += ev;
              s[mt][i][e] = ev;
            }
          }
          if (use_dropout) {  // and the numerator e * keep; 1 / (1 - rate) waits for the end
#pragma unroll
            for (int i = 0; i < NS; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const uint32_t h = row_hash[mt][e >> 1] + col_hash +
                                   (uint32_t)(i * 8 + (e & 1)) * kHashCol;
                if (!keep_from_sum(h, hbh, threshold)) s[mt][i][e] = 0.f;
              }
            }
          }
        }
        // o += p v: the C fragments of two 8-key tiles are one A fragment
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          if (FULL || j * 16 < nvalid) {
            uint32_t pf[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              pf[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
              pf[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
              pf[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
              pf[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
            }
#pragma unroll
            for (int dp = 0; dp < NT / 2; ++dp) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, vs + (c0 + j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                       dp * 16 + 8 * (lane >> 4));
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(oacc[mt][2 * dp], pf[mt], b[0], b[1]);
                mma_bf16(oacc[mt][2 * dp + 1], pf[mt], b[2], b[3]);
              }
            }
          }
        }
      };
      for (int c0 = 0; c0 < kv_n; c0 += kKeyChunk) {
        if (kv_n - c0 >= kKeyChunk) {
          chunk(std::true_type{}, c0, kKeyChunk);
        } else {
          chunk(std::false_type{}, c0, kv_n - c0);
        }
      }
    }

    if (active) {
      // normalise, stage the tile through the warp's Q buffer, store 16 bytes a lane
      __syncwarp();  // every lane has its Q fragments
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float l0 = quad_sum(l_run[mt][0]);
        const float l1 = quad_sum(l_run[mt][1]);
        const float inv0 = keep_scale / l0;  // keep_scale is 1 without dropout
        const float inv1 = keep_scale / l1;
        bf16* orow = qcur + (mt * 16 + g) * LD + 2 * t;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          *reinterpret_cast<uint32_t*>(orow + i * 8) =
              pack_bf16(oacc[mt][i][0] * inv0, oacc[mt][i][1] * inv0);
          *reinterpret_cast<uint32_t*>(orow + 8 * LD + i * 8) =
              pack_bf16(oacc[mt][i][2] * inv1, oacc[mt][i][3] * inv1);
        }
        // the row's log-sum-exp of the scaled scores, for the backward kernel
        if (lse != nullptr && t == 0) {
          const int r0 = row0 + mt * 16 + g;
          if (r0 < n) lse[(size_t)bh * n + r0] = m_run[mt][0] * scale + logf(l0);
          if (r0 + 8 < n) lse[(size_t)bh * n + r0 + 8] = m_run[mt][1] * scale + logf(l1);
        }
      }
      __syncwarp();
      if (vec) {
        const int cpr = d / 8;
        for (int i = lane; i < WR * cpr; i += 32) {
          const int r = i / cpr;
          const int c = (i - r * cpr) * 8;
          if (row0 + r < n) {
            *reinterpret_cast<uint4*>(ob + (size_t)(row0 + r) * d + c) =
                *reinterpret_cast<const uint4*>(qcur + r * LD + c);
          }
        }
      } else {
        for (int i = lane; i < WR * d; i += 32) {
          const int r = i / d;
          const int c = i - r * d;
          if (row0 + r < n) ob[(size_t)(row0 + r) * d + c] = qcur[r * LD + c];
        }
      }
      __syncwarp();  // the buffer is free for the prefetch after next
    }
  }
}

// Keys that fit beside the Q buffers, in whole chunks.
inline int mma_fwd_kv_rows(int m, int dpad, int mt) {
  const int row_bytes = (dpad + kMmaPad) * 2;
  const int q_bytes = kMmaWarps * 2 * mt * kMmaRows * row_bytes;
  const int cap = (kMaxSmem - q_bytes) / (2 * row_bytes) / kKeyChunk * kKeyChunk;
  const int want = (m + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  return want < cap ? want : cap;
}

template <int KSTEPS, int MT, int MINB>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int n, int m, int d, int rows_per_block, int smem_bytes, float scale,
                       int use_dropout, uint32_t seed, const long long* seed_ptr,
                       uint32_t threshold, float keep_scale, HashRows hrows, cudaStream_t stream) {
  constexpr int DPAD = KSTEPS * 16;
  const int kv_rows = mma_fwd_kv_rows(m, DPAD, MT);
  const int row_bytes = (DPAD + kMmaPad) * 2;
  const int smem = (2 * kv_rows + kMmaWarps * 2 * MT * kMmaRows) * row_bytes;
  if (smem != smem_bytes || rows_per_block < 1 ||
      rows_per_block % (kMmaWarps * MT * kMmaRows) != 0) {
    return cudaErrorInvalidValue;
  }
  const int blocks_y = (n + rows_per_block - 1) / rows_per_block;
  if (blocks_y > 65535) return cudaErrorInvalidValue;
  auto kernel = attention_fwd_mma_kernel<KSTEPS, MT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  kernel<<<dim3(bh, blocks_y), kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, n, m, d, rows_per_block, kv_rows, scale, use_dropout, seed,
      seed_ptr, threshold, keep_scale, hrows, vec);
  return cudaGetLastError();
}

// ---- small_m ------------------------------------------------------------------

template <typename T, int G>
__global__ void __launch_bounds__(kSmallThreads)
attention_fwd_small_m_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ lse, int n, int m, int d, int rows_per_block,
                             float scale, int use_dropout, uint32_t seed_value,
                             const long long* __restrict__ seed_ptr, uint32_t threshold,
                             float keep_scale, HashRows hrows, int vec_flag) {
  constexpr int DS = 8 * G;                 // columns a group covers
  constexpr int RPP = kSmallThreads / G;    // rows per pass of the block
  __shared__ __align__(16) float ks[kSmallM * DS];
  __shared__ __align__(16) float vs[kSmallM * DS];
  const int tid = threadIdx.x;
  const int j = tid % G;
  const int bh = blockIdx.x;
  const uint32_t hbh = hash_bh(bh, hrows);  // the head's row of the global batch
  const int block_row0 = blockIdx.y * rows_per_block;
  const int row_end = min(n, block_row0 + rows_per_block);
  const bool vec = vec_flag != 0;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  stage_small_kv<T, DS>(ks, vs, k + (size_t)bh * m * d, v + (size_t)bh * m * d, m, d, tid);
  __syncthreads();

  for (int base = block_row0; base < row_end; base += RPP) {
    const int row = base + tid / G;
    const bool valid = row < row_end;
    const size_t off = ((size_t)bh * n + row) * d;
    float qx[8];
    load_row8<G>(qx, q + off, j, d, valid, vec);
    float s[kSmallM];
    float mx = -INFINITY;
#pragma unroll
    for (int jk = 0; jk < kSmallM; ++jk) {
      s[jk] = -INFINITY;
      if (jk < m) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qx[i], ks[jk * DS + small_col<T, G>(j, i)], part);
        s[jk] = group_sum<G>(part) * scale;
        mx = fmaxf(mx, s[jk]);
      }
    }
    float l = 0.f;
    float out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = 0.f;
#pragma unroll
    for (int jk = 0; jk < kSmallM; ++jk) {
      if (jk < m) {
        const float e = expf(s[jk] - mx);
        l += e;
        float w = e;
        if (use_dropout) {
          w = keep_element(seed, hbh, (uint32_t)row, (uint32_t)jk, threshold)
                  ? e * keep_scale
                  : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) out[i] = fmaf(w, vs[jk * DS + small_col<T, G>(j, i)], out[i]);
      }
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] /= l;
      store_row8<G>(o + off, out, j, d, vec);
      if (lse != nullptr && j == 0) lse[(size_t)bh * n + row] = mx + logf(l);
    }
  }
}

template <typename T, int G>
cudaError_t launch_small_m(const void* q, const void* k, const void* v, void* o, float* lse,
                           int bh, int n, int m, int d, int rows_per_block, float scale,
                           int use_dropout, uint32_t seed, const long long* seed_ptr,
                           uint32_t threshold, float keep_scale, HashRows hrows, cudaStream_t stream) {
  const int blocks_y = (n + rows_per_block - 1) / rows_per_block;
  if (rows_per_block < 1 || rows_per_block % (kSmallThreads / 8) != 0 || blocks_y > 65535) {
    return cudaErrorInvalidValue;
  }
  const int vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(q) && aligned16(o);
  attention_fwd_small_m_kernel<T, G><<<dim3(bh, blocks_y), kSmallThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n, m, d, rows_per_block, scale, use_dropout, seed, seed_ptr,
      threshold, keep_scale, hrows, vec);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, n, d), k and v: (bh, m, d), o: (bh, n, d), all contiguous on `device`.
// dtype: 0 = float32, 1 = bfloat16 (all four tensors). lse: float32 (bh, n) that
// takes each row's log-sum-exp, or null. variant: kVariantF32 (float32 only),
// kVariantMma (bfloat16 only) or kVariantSmallM (m <= 8). rows_per_block: query
// rows a block walks; row_tiles: 16-row tiles a warp of kVariantMma owns (1 or
// 2; 1 for the others); smem_bytes: the block's dynamic shared memory; all as
// the wrapper sized them, and the call is refused when they are not the kernel's own.
// seed_ptr: a device int64 whose low 32 bits are the dropout seed, or null to
// take `seed`. heads, batch_off, batch_stride, head0, head_total: the rows and heads
// of the dropout hash (HashRows; 1, 0, 1, 0, 1 hash each head's own index). Returns
// a cudaError_t.
extern "C" int stcd_cross_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, float* lse, int bh, int n, int m, int d,
                                        int dtype, int variant, int rows_per_block,
                                        int row_tiles, int smem_bytes, float scale,
                                        int use_dropout,
                                        unsigned int seed, const long long* seed_ptr,
                                        unsigned int threshold, float keep_scale,
                                        int heads, int batch_off, int batch_stride,
                                        int head0, int head_total, int device,
                                        void* stream) {
  if (bh < 1 || n < 1 || m < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 1 ||
      !hash_rows_valid(bh, heads, batch_off, batch_stride, head0, head_total)) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceGuard guard;
  cudaError_t err = guard.set(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STCD_FWD_ARGS q, k, v, o, lse, bh, n, m, d
  const HashRows hrows{heads, batch_off, batch_stride, head0, head_total};
#define STCD_FWD_TAIL scale, use_dropout, seed, seed_ptr, threshold, keep_scale, hrows, s
  if (variant == kVariantF32) {
    if (dtype != 0 || row_tiles != 1) return (int)cudaErrorInvalidValue;
#define STCD_F32(DP) launch_f32<DP>(STCD_FWD_ARGS, rows_per_block, smem_bytes, STCD_FWD_TAIL)
    switch (f32_dpad(d)) {
      case 32: err = STCD_F32(32); break;
      case 48: err = STCD_F32(48); break;
      case 64: err = STCD_F32(64); break;
      case 80: err = STCD_F32(80); break;
      default: err = STCD_F32(128); break;
    }
#undef STCD_F32
  } else if (variant == kVariantMma) {
    if (dtype != 1 || row_tiles < 1 || row_tiles > 2 || (row_tiles == 2 && d > 80)) {
      return (int)cudaErrorInvalidValue;
    }
#define STCD_MMA(KSTEPS, MT, MINB) \
  launch_mma<KSTEPS, MT, MINB>(STCD_FWD_ARGS, rows_per_block, smem_bytes, STCD_FWD_TAIL)
    if (row_tiles == 2) {
      err = d <= 32 ? STCD_MMA(2, 2, 1) : d <= 64 ? STCD_MMA(4, 2, 1) : STCD_MMA(5, 2, 1);
    } else {
      err = d <= 32 ? STCD_MMA(2, 1, 2)
                    : d <= 64 ? STCD_MMA(4, 1, 2) : d <= 80 ? STCD_MMA(5, 1, 1) : STCD_MMA(8, 1, 1);
    }
#undef STCD_MMA
  } else if (variant == kVariantSmallM) {
    if (m > kSmallM || smem_bytes != 0 || row_tiles != 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
      err = d <= 64 ? launch_small_m<float, 8>(STCD_FWD_ARGS, rows_per_block, STCD_FWD_TAIL)
                    : launch_small_m<float, 16>(STCD_FWD_ARGS, rows_per_block, STCD_FWD_TAIL);
    } else {
      err = d <= 64 ? launch_small_m<bf16, 8>(STCD_FWD_ARGS, rows_per_block, STCD_FWD_TAIL)
                    : launch_small_m<bf16, 16>(STCD_FWD_ARGS, rows_per_block, STCD_FWD_TAIL);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef STCD_FWD_ARGS
#undef STCD_FWD_TAIL
  return (int)err;
}

extern "C" const char* stcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
