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
// f32_cuda (f32, M > 8): the CUDA-core kernel below.
// - One block per (bh, tile of kBlockN = 64 query rows); 8 warps, 8 rows each.
// - K and V of that bh are staged through shared memory in chunks of
//   kChunk = 32 keys, converted to f32; the Q tile is staged once.
// - The dot products run in f32 out of shared memory, about one shared-memory
//   read per multiply-add, which holds it to a fraction of the f32 rate;
//   register tiling of the score product is its later work.
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

namespace {

using namespace stcd;

// DPL = ceil(D / 32): output columns held per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
cross_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int n, int m, int d, float scale,
                           int use_dropout, uint32_t seed_value,
                           const long long* __restrict__ seed_ptr, uint32_t threshold,
                           float keep_scale) {
  extern __shared__ float smem[];
  const int ks = d + 1;              // padded stride: lane j reads row j conflict-free
  float* qs = smem;                  // [kBlockN][d]
  float* kc = qs + kBlockN * d;      // [kChunk][ks]
  float* vc = kc + kChunk * ks;      // [kChunk][ks]

  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const T* qb = q + (size_t)bh * n * d;
  const T* kb = k + (size_t)bh * m * d;
  const T* vb = v + (size_t)bh * m * d;

  // Q rows past n are zero: they give finite scores and are never stored.
  for (int i = tid; i < kBlockN * d; i += blockDim.x) {
    const int r = i / d;
    const int gr = row0 + r;
    qs[i] = gr < n ? to_f32(qb[(size_t)row0 * d + i]) : 0.f;
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const float* qw = qs + warp * kRowsPerWarp * d;
  const int wrow0 = row0 + warp * kRowsPerWarp;

  for (int c0 = 0; c0 < m; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and the Q tile staged)
    for (int i = tid; i < kChunk * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      const int gr = c0 + r;
      float kx = 0.f, vx = 0.f;
      if (gr < m) {
        kx = to_f32(kb[(size_t)gr * d + c]);
        vx = to_f32(vb[(size_t)gr * d + c]);
      }
      kc[r * ks + c] = kx;
      vc[r * ks + c] = vx;
    }
    __syncthreads();

    // scores: lane j owns key c0 + j, for the warp's 8 rows at once
    const int col = c0 + lane;
    const bool valid = col < m;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = kc + lane * ks;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float kx = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qw[r * d + c], kx, s[r]);
    }

    // online softmax update; w = numerator weight of this lane's key
    float w[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first chunk
      const float e = valid ? expf(sr - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(e);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      float wr = e;
      if (use_dropout) {
        wr = (valid && keep_element(seed, (uint32_t)bh, (uint32_t)(wrow0 + r),
                                    (uint32_t)col, threshold))
                 ? e * keep_scale
                 : 0.f;
      }
      w[r] = wr;
    }

    // acc[r][:] += sum_j w_j v_j: lane holds columns lane + 32 * c
    const int nvalid = min(kChunk, m - c0);
    for (int j = 0; j < nvalid; ++j) {
      float vx[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int col_d = lane + 32 * c;
        vx[c] = col_d < d ? vc[j * ks + col_d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float wj = __shfl_sync(kFull, w[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(wj, vx[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = wrow0 + r;
    if (gr >= n) continue;
    T* orow = o + ((size_t)bh * n + gr) * d;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col_d = lane + 32 * c;
      if (col_d < d) store_as(orow + col_d, acc[r][c] / l_run[r]);
    }
    // the row's log-sum-exp of the scaled scores, for the backward kernel
    if (lse != nullptr && lane == 0) lse[(size_t)bh * n + gr] = m_run[r] + logf(l_run[r]);
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int n, int m, int d, float scale, int use_dropout,
                   uint32_t seed, const long long* seed_ptr, uint32_t threshold,
                   float keep_scale, cudaStream_t stream) {
  auto kernel = cross_attention_fwd_kernel<T, DPL>;
  const size_t smem = (size_t)(kBlockN * d + 2 * kChunk * (d + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bh, (n + kBlockN - 1) / kBlockN);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n, m, d, scale, use_dropout, seed, seed_ptr, threshold,
      keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int n, int m, int d, float scale,
                       int use_dropout, uint32_t seed, const long long* seed_ptr,
                       uint32_t threshold, float keep_scale, cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    default: return launch<T, 4>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
  }
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
                         float keep_scale, int vec_flag) {
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
        row_hash[mt][r] = seed + (uint32_t)bh * kHashBh +
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
                if (!keep_from_sum(h, (uint32_t)bh, threshold)) s[mt][i][e] = 0.f;
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
                       uint32_t threshold, float keep_scale, cudaStream_t stream) {
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
      seed_ptr, threshold, keep_scale, vec);
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
                             float keep_scale, int vec_flag) {
  constexpr int DS = 8 * G;                 // columns a group covers
  constexpr int RPP = kSmallThreads / G;    // rows per pass of the block
  __shared__ __align__(16) float ks[kSmallM * DS];
  __shared__ __align__(16) float vs[kSmallM * DS];
  const int tid = threadIdx.x;
  const int j = tid % G;
  const int bh = blockIdx.x;
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
          w = keep_element(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)jk, threshold)
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
                           uint32_t threshold, float keep_scale, cudaStream_t stream) {
  const int blocks_y = (n + rows_per_block - 1) / rows_per_block;
  if (rows_per_block < 1 || rows_per_block % (kSmallThreads / 8) != 0 || blocks_y > 65535) {
    return cudaErrorInvalidValue;
  }
  const int vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(q) && aligned16(o);
  attention_fwd_small_m_kernel<T, G><<<dim3(bh, blocks_y), kSmallThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n, m, d, rows_per_block, scale, use_dropout, seed, seed_ptr,
      threshold, keep_scale, vec);
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
// take `seed`. Returns a cudaError_t.
extern "C" int stcd_cross_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, float* lse, int bh, int n, int m, int d,
                                        int dtype, int variant, int rows_per_block,
                                        int row_tiles, int smem_bytes, float scale,
                                        int use_dropout,
                                        unsigned int seed, const long long* seed_ptr,
                                        unsigned int threshold, float keep_scale,
                                        int device, void* stream) {
  if (bh < 1 || n < 1 || m < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STCD_FWD_ARGS q, k, v, o, lse, bh, n, m, d
#define STCD_FWD_TAIL scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s
  if (variant == kVariantF32) {
    const size_t smem = (size_t)(kBlockN * d + 2 * kChunk * (d + 1)) * sizeof(float);
    if (dtype != 0 || rows_per_block != kBlockN || row_tiles != 1 ||
        (size_t)smem_bytes != smem ||
        (n + kBlockN - 1) / kBlockN > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    err = dispatch_d<float>(STCD_FWD_ARGS, STCD_FWD_TAIL);
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
