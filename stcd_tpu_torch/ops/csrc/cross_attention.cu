// Cross-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v,
// with optional attention-matrix dropout after normalisation.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/attention.py::_attention_kernel
// (launched by _flash_fwd). It computes the same function but is written for
// the GPU rather than carried over block by block:
//
// - One block per (bh, tile of kBlockN = 64 query rows); 8 warps, 8 rows each.
// - K and V of that bh are staged through shared memory in chunks of
//   kChunk = 32 keys, converted to f32; the Q tile is staged once.
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
// - Inputs f32 or bf16, math in f32, output in q's dtype. Any N and M (the
//   ragged last Q tile and KV chunk are masked); D <= 128.
// - When the caller will need the gradient it also writes each row's
//   log-sum-exp of the scaled scores, from which cross_attention_bwd.cu
//   rebuilds the softmax in one pass.
//
// What bounds it: at the ChangeFormerV6 SRA shapes (M = 64, D = 64 or 80)
// each block does only 2*64*64*D flops per tile against its own loads, and the
// whole call is a few microseconds of work, so it is bound by latency and
// launch rather than by bytes or tensor-core rate. The dot products run on the
// CUDA cores in f32 from shared memory. wgmma tiles, TMA loads and keeping
// several Q tiles per block in flight are later work.

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

}  // namespace

// q: (bh, n, d), k and v: (bh, m, d), o: (bh, n, d), all contiguous on `device`.
// dtype: 0 = float32, 1 = bfloat16 (all four tensors). lse: float32 (bh, n) that
// takes each row's log-sum-exp, or null. seed_ptr: a device int64 whose low 32
// bits are the dropout seed, or null to take `seed`. Returns a cudaError_t.
extern "C" int stcd_cross_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, float* lse, int bh, int n, int m, int d,
                                        int dtype, float scale, int use_dropout,
                                        unsigned int seed, const long long* seed_ptr,
                                        unsigned int threshold, float keep_scale,
                                        int device, void* stream) {
  if (bh < 1 || n < 1 || m < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 1 ||
      (n + kBlockN - 1) / kBlockN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? dispatch_d<float>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s)
            : dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, n, m, d, scale, use_dropout, seed, seed_ptr, threshold, keep_scale, s);
  return (int)err;
}

extern "C" const char* stcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
