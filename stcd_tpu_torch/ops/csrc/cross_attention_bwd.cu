// Cross-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = (softmax(q k^T * scale) . md) v, md the inverted-dropout multiplier.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/attention.py::_attention_bwd_kernel
// (launched by _bwd). The TPU kernel walks the Q tiles of one head in order and
// keeps dk and dv resident in VMEM between them. Blocks on the GPU run in no
// order and share nothing, so the accumulation over Q tiles is laid out anew:
//
// - One block per (bh, tile of kBlockN = 64 query rows); 8 warps, 8 rows each.
//   The Q and the g tile are staged once in shared memory as f32; K and V go
//   through in chunks of kChunk = 32 keys, lane j of a warp owning key j.
// - The softmax is rebuilt in one pass from the forward's per-row log-sum-exp:
//   p = exp(s * scale - lse). The row term sum_j p_j md_j dp_j of the softmax
//   transpose equals sum_d g_d o_d with o the forward output (dropout
//   included), so it is taken from the saved o and needs no second pass over
//   the keys. The keep mask is the same keep_element hash on (seed, bh, global
//   row, col) as the forward.
// - Per chunk: dp = g v^T; ds = p (dp md - delta); dq += ds k (registers, lane
//   holds columns lane + 32 c); ds and p md of the tile go to shared memory,
//   and the block then forms this tile's share of dk = scale ds^T q and
//   dv = (p md)^T g for the chunk's 32 keys.
// - Deterministic accumulation: each block writes its share to an f32 scratch
//   buffer (bh, tiles, M, D); a second launch sums the tiles in index order and
//   casts to k's and v's dtype. No float atomics: two runs agree bit for bit.
// - Inputs f32 or bf16, math in f32, dq in q's dtype. Any N and M (the ragged
//   last Q tile and KV chunk are masked); D <= 128.
//
// What bounds it: 10 N M D operations per head against q, k, v, g, o read and
// dq, dk, dv written once. At the ChangeFormerV6 training shapes (M = 256) that
// is bound by operations at the f32 rate. The products run on the CUDA cores
// from shared memory, about one shared-memory read per multiply-add, so the
// kernel sits well under that bound; the scratch traffic (2 M D floats per 64
// rows) comes on top. wgmma tiles, several Q tiles per block (less scratch) and
// a path for tiny M (at M = 4 only 4 of 32 lanes own a key) are later work.

#include "attention_common.cuh"

namespace {

using namespace stcd;

constexpr int kPStride = kChunk + 1;          // padded row of the ds / p md tiles
constexpr int kKeysPerWarp = kChunk / kWarps;  // keys a warp owns in the dk/dv stage

// DPL = ceil(D / 32): columns held per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
cross_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const T* __restrict__ g, const float* __restrict__ lse,
                           T* __restrict__ dq, float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int n, int m, int d, float scale,
                           int use_dropout, uint32_t seed_value,
                           const long long* __restrict__ seed_ptr, uint32_t threshold,
                           float keep_scale) {
  extern __shared__ float smem[];
  const int ks = d + 1;                  // padded stride: lane j reads row j conflict-free
  float* qs = smem;                      // [kBlockN][d]
  float* gs = qs + kBlockN * d;          // [kBlockN][d]
  float* kc = gs + kBlockN * d;          // [kChunk][ks]
  float* vc = kc + kChunk * ks;          // [kChunk][ks]
  float* dss = vc + kChunk * ks;         // [kBlockN][kPStride]: ds of this chunk
  float* pds = dss + kBlockN * kPStride;  // [kBlockN][kPStride]: p md of this chunk

  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int row0 = tile * kBlockN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t seed = use_dropout ? resolve_seed(seed_value, seed_ptr) : 0u;
  const T* qb = q + (size_t)bh * n * d;
  const T* gb = g + (size_t)bh * n * d;
  const T* ob = o + (size_t)bh * n * d;
  const T* kb = k + (size_t)bh * m * d;
  const T* vb = v + (size_t)bh * m * d;

  // Rows past n are zero in q and g: they add nothing to dk and dv.
  for (int i = tid; i < kBlockN * d; i += blockDim.x) {
    const bool in = row0 + i / d < n;
    qs[i] = in ? to_f32(qb[(size_t)row0 * d + i]) : 0.f;
    gs[i] = in ? to_f32(gb[(size_t)row0 * d + i]) : 0.f;
  }
  __syncthreads();

  const float* qw = qs + warp * kRowsPerWarp * d;
  const float* gw = gs + warp * kRowsPerWarp * d;
  const int wrow0 = row0 + warp * kRowsPerWarp;

  // per row: the log-sum-exp and delta = sum_d g_d o_d
  float lse_r[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = wrow0 + r;
    float part = 0.f;
    if (gr < n) {
      for (int c = lane; c < d; c += 32) part += gw[r * d + c] * to_f32(ob[(size_t)gr * d + c]);
    }
    delta[r] = warp_sum(part);
    lse_r[r] = gr < n ? lse[(size_t)bh * n + gr] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const size_t part_base = ((size_t)bh * gridDim.y + tile) * m * d;

  for (int c0 = 0; c0 < m; c0 += kChunk) {
    __syncthreads();  // the previous chunk's dk/dv stage is done with dss, pds, kc, vc
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

    // lane j owns key c0 + j: s = q k^T and dp = g v^T for the warp's 8 rows
    const int col = c0 + lane;
    const bool valid = col < m;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = 0.f;
      dp[r] = 0.f;
    }
    const float* krow = kc + lane * ks;
    const float* vrow = vc + lane * ks;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      const float kx = krow[c];
      const float vx = vrow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qw[r * d + c], kx, s[r]);
        dp[r] = fmaf(gw[r * d + c], vx, dp[r]);
      }
    }

    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int gr = wrow0 + r;
      const float p = (valid && gr < n) ? expf(s[r] * scale - lse_r[r]) : 0.f;
      float md = 1.f;
      if (use_dropout) {
        md = keep_element(seed, (uint32_t)bh, (uint32_t)gr, (uint32_t)col, threshold)
                 ? keep_scale
                 : 0.f;
      }
      ds[r] = p * (dp[r] * md - delta[r]);
      const int row = warp * kRowsPerWarp + r;
      dss[row * kPStride + lane] = ds[r];
      pds[row * kPStride + lane] = p * md;
    }

    // dq[r][:] += sum_j ds_j k_j: lane holds columns lane + 32 * c
    const int nvalid = min(kChunk, m - c0);
    for (int j = 0; j < nvalid; ++j) {
      float kx[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int col_d = lane + 32 * c;
        kx[c] = col_d < d ? kc[j * ks + col_d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(dsj, kx[c], acc[r][c]);
      }
    }
    __syncthreads();  // the tile's ds and p md are in shared memory

    // this tile's share of dk and dv for the chunk: the warp owns keys
    // warp + 8 * i, the lane columns lane + 32 * c, summed over the 64 rows
    float ak[kKeysPerWarp][DPL], av[kKeysPerWarp][DPL];
#pragma unroll
    for (int i = 0; i < kKeysPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        ak[i][c] = 0.f;
        av[i][c] = 0.f;
      }
    }
    if (warp < nvalid) {  // a warp whose first key is past m owns none
#pragma unroll 2
      for (int r = 0; r < kBlockN; ++r) {
        float qx[DPL], gx[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int col_d = lane + 32 * c;
          qx[c] = col_d < d ? qs[r * d + col_d] : 0.f;
          gx[c] = col_d < d ? gs[r * d + col_d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kKeysPerWarp; ++i) {
          const float dsv = dss[r * kPStride + warp + kWarps * i];
          const float pdv = pds[r * kPStride + warp + kWarps * i];
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            ak[i][c] = fmaf(dsv, qx[c], ak[i][c]);
            av[i][c] = fmaf(pdv, gx[c], av[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) {
        const int key = c0 + warp + kWarps * i;
        if (key >= m) continue;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int col_d = lane + 32 * c;
          if (col_d < d) {
            dk_part[part_base + (size_t)key * d + col_d] = ak[i][c] * scale;
            dv_part[part_base + (size_t)key * d + col_d] = av[i][c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = wrow0 + r;
    if (gr >= n) continue;
    T* dqrow = dq + ((size_t)bh * n + gr) * d;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col_d = lane + 32 * c;
      if (col_d < d) store_as(dqrow + col_d, acc[r][c] * scale);
    }
  }
}

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

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* g, const float* lse, void* dq, void* dk, void* dv,
                   float* dk_part, float* dv_part, int bh, int n, int m, int d,
                   float scale, int use_dropout, uint32_t seed, const long long* seed_ptr,
                   uint32_t threshold, float keep_scale, cudaStream_t stream) {
  auto kernel = cross_attention_bwd_kernel<T, DPL>;
  const size_t smem = (size_t)(2 * kBlockN * d + 2 * kChunk * (d + 1) +
                               2 * kBlockN * kPStride) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (n + kBlockN - 1) / kBlockN;
  const dim3 grid(bh, tiles);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), lse, static_cast<T*>(dq),
      dk_part, dv_part, n, m, d, scale, use_dropout, seed, seed_ptr, threshold,
      keep_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t md = (size_t)m * d;
  const size_t total = (size_t)bh * md;
  reduce_tiles_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), tiles, md, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, void* dq, void* dk, void* dv,
                       float* dk_part, float* dv_part, int bh, int n, int m, int d,
                       float scale, int use_dropout, uint32_t seed,
                       const long long* seed_ptr, uint32_t threshold, float keep_scale,
                       cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
    default: return launch<T, 4>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, stream);
  }
}

}  // namespace

// q, o, g, dq: (bh, n, d); k, v, dk, dv: (bh, m, d); lse: float32 (bh, n) as the
// forward wrote it; dk_part, dv_part: float32 scratch of (bh, tiles, m, d), where
// tiles must be the Q tiles of the launch, ceil(n / kBlockN), or the call is refused.
// All contiguous on `device`. dtype: 0 = float32, 1 = bfloat16 (every tensor but
// lse and the scratch). seed_ptr: a device int64 whose low 32 bits are the
// dropout seed, or null to take `seed`. Returns a cudaError_t.
extern "C" int stcd_cross_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const float* lse,
                                        void* dq, void* dk, void* dv, float* dk_part,
                                        float* dv_part, int tiles, int bh, int n, int m,
                                        int d, int dtype, float scale, int use_dropout,
                                        unsigned int seed, const long long* seed_ptr,
                                        unsigned int threshold, float keep_scale,
                                        int device, void* stream) {
  if (bh < 1 || n < 1 || m < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 1 ||
      tiles != (n + kBlockN - 1) / kBlockN || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? dispatch_d<float>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s)
            : dispatch_d<__nv_bfloat16>(q, k, v, o, g, lse, dq, dk, dv, dk_part, dv_part, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s);
  return (int)err;
}
