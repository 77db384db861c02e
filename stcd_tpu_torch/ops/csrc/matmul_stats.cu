// A bf16 matrix product for Hopper (sm_90a), alone or with the two BatchNorm
// sums of its f32 result: y = x . w with x (M, K) and w (K, N) in bf16, f32
// accumulation, y rounded to bf16 once at the end; sum(acc) and sum(acc^2)
// over the rows, taken from the f32 accumulator before y is rounded. This is
// a ResNet bottleneck's 1x1 convolution that emits its BatchNorm statistics
// while the output tile is still on chip.
//
// Replaces four Pallas TPU kernels of the JAX repo's feasibility benchmarks
// where TMA cannot describe the operands, with three entries:
//
//   stcd_matmul_bf16_tiles  benchmarks/bench_bnstats_diag.py::_mm_kernel
//                           (pallas_mm): the product alone, for the shapes
//                           that the wgmma route of matmul_hopper.cu
//                           (stcd_matmul_bf16) cannot take
//   stcd_matmul_stats_tiles benchmarks/bench_conv_bn_epilogue.py::_kernel
//                           (pallas_fused) and, for matmul_stats_rows,
//                           benchmarks/bench_bnstats_diag.py::_fused1d_kernel
//                           (pallas_1d): a 2-D decomposition, one block for
//                           each (M tile, N tile), the sums on the CUDA cores,
//                           for the shapes that the wgmma route of
//                           matmul_hopper.cu (stcd_matmul_stats) cannot take
//   stcd_matmul_stats_mma_tiles  benchmarks/bench_bnstats_diag.py::_mxu_stats_kernel
//                           (pallas_mxu_stats): as pallas_1d, the two column sums
//                           formed on the tensor cores (ones . acc, ones . acc^2),
//                           for the shapes that the wgmma route of
//                           matmul_hopper.cu (stcd_matmul_stats_mma) cannot take
//
// Each entry runs only where matmul_plan (ops/matmul_stats.py) picks the route
// `wmma`: e.g. at (333, 37, 91), where TMA cannot describe x and y.
//
// One device function, tile_product, serves all three: it computes a 128 x 64
// output tile with nvcuda::wmma on bf16 fragments (8 warps, 32 x 32 each, K in
// chunks of 64 through shared memory), stages the f32 accumulator in shared
// memory over the load buffers, writes y in 16-byte stores, and runs the
// epilogue its template argument names. The product is in this file's own
// body: no library GEMM is called.
//
// What the TPU kernels do that is not carried over: the stats block stays in
// VMEM across a sequential grid there. A CUDA grid has no order, so every
// (M tile, N tile) writes its 64 column sums to an f32 scratch (M tiles, N)
// and a second launch adds the M tiles per column in index order (lane-strided,
// then a fixed shuffle tree). No float atomics: two runs agree bit for bit.
// The fold to 8 sublane rows and the tile arguments bm, bn, pipeline are TPU
// layout knobs and have no counterpart.
//
// The tensor-core epilogue: a bf16 ones . acc would round acc to 8 bits of
// mantissa, and the TPU kernel's contraction is f32. Here acc (or acc^2,
// squared in f32) is split into three TF32 parts, hi = tf32(v), mid =
// tf32(v - hi), lo = v - hi - mid, whose sum is v exactly (3 x 11 bits cover
// f32's 24), and three m16n16k8 TF32 products with a fragment of ones add them
// into one f32 accumulator: every product is exact and only the additions
// round, as in an f32 sum.
//
// Any M, K, N >= 1 is computed: rows, columns and depth beyond the edge are
// loaded as zeros (so they add nothing to the sums) and not stored; the
// 16-byte loads and stores fall back to single elements where K or N is not
// a multiple of 8 or a pointer is not 16-byte aligned.
//
// What bounds it: bytes. At the ResNet-50 bottleneck shapes (K, N <= 1024, M
// in the hundreds of thousands) the 2 M K N operations take under a fifth of
// the time that reading x and w and writing y takes at the card's rates. The
// design reads x once from device memory (in the 2-D decomposition the N
// tiles of one M tile are neighbouring blocks, in the row decomposition one
// block walks them, so the re-reads hit L2), and keeps the f32 result out of
// device memory altogether. Loads are not overlapped with the products inside
// a block; several resident blocks per SM hide them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int XS_LD = BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int WS_LD = BN + 8;
constexpr int CS_LD = BN + 4;  // f32 elements
constexpr int kLoadBytes = (BM * XS_LD + BK * WS_LD) * 2;
constexpr int kAccBytes = BM * CS_LD * 4;
constexpr int kTileBytes = kLoadBytes > kAccBytes ? kLoadBytes : kAccBytes;
constexpr int kRedFloats = 2048;  // 8 warps x a 16 x 16 f32 fragment

enum Epilogue { kNone = 0, kCudaCores = 1, kTensorCores = 2 };

struct Args {
  const bf16* x;
  const bf16* w;
  bf16* y;
  float* part_sum;  // (m_tiles, n) scratch, unused with kNone
  float* part_sq;
  long long m;
  int k, n;
  int vec_x, vec_w, vec_y;  // 16-byte accesses are allowed on this operand
};

// Eight bf16 of row r from column c on, zeros beyond the edge.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ base, long long r, int c,
                                       long long rows, int cols, int vec) {
  if (r >= rows || c >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* p = base + (size_t)r * cols + c;
  if (vec && c + 8 <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (c + e < cols) {
      word[e >> 1] |= (uint32_t)__bfloat16_as_ushort(p[e]) << (16 * (e & 1));
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// One 128 x 64 tile of y at (m_tile, n_tile) and its epilogue. `smem` holds
// the load buffers during the K loop and the f32 accumulator after it.
template <int EPI>
__device__ __forceinline__ void tile_product(const Args& a, long long m_tile, int n_tile,
                                             unsigned char* smem, float* red) {
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + BM * XS_LD;
  float* cs = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 corner
  const long long m0 = m_tile * BM;
  const int n0 = n_tile * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k0 = 0; k0 < a.k; k0 += BK) {
    for (int v = t; v < BM * (BK / 8); v += kThreads) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + r * XS_LD + c) =
          load8(a.x, m0 + r, k0 + c, a.m, a.k, a.vec_x);
    }
    for (int v = t; v < BK * (BN / 8); v += kThreads) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + r * WS_LD + c) =
          load8(a.w, k0 + r, n0 + c, a.k, a.n, a.vec_w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * XS_LD + kk, XS_LD);
        wmma::load_matrix_sync(fb[i], ws + kk * WS_LD + wn * 32 + i * 16, WS_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next chunk, or the accumulator, overwrites the buffers
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16, acc[i][j],
                              CS_LD, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // y: rounded to bf16 here and nowhere else; a thread stores 8 columns
  for (int v = t; v < BM * (BN / 8); v += kThreads) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const long long row = m0 + r;
    const int col = n0 + c;
    if (row >= a.m || col >= a.n) continue;
    const float4 lo = *reinterpret_cast<const float4*>(cs + r * CS_LD + c);
    const float4 hi = *reinterpret_cast<const float4*>(cs + r * CS_LD + c + 4);
    bf16* out = a.y + (size_t)row * a.n + col;
    if (a.vec_y && col + 8 <= a.n) {
      *reinterpret_cast<uint4*>(out) = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                                                  pack2(hi.x, hi.y), pack2(hi.z, hi.w));
    } else {
      const float val[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (col + e < a.n) out[e] = __float2bfloat16_rn(val[e]);
      }
    }
  }

  if (EPI == kCudaCores) {
    // a thread owns one column and every fourth row, in order; the four row
    // slots are then added in index order
    const int col = t & (BN - 1), slot = t >> 6;
    float s = 0.f, q = 0.f;
#pragma unroll 8
    for (int r = slot; r < BM; r += kThreads / BN) {
      const float v = cs[r * CS_LD + col];
      s += v;
      q = fmaf(v, v, q);
    }
    red[slot * BN + col] = s;
    red[kThreads + slot * BN + col] = q;
    __syncthreads();
    if (t < BN && n0 + t < a.n) {
      float ts = 0.f, tq = 0.f;
#pragma unroll
      for (int sl = 0; sl < kThreads / BN; ++sl) {
        ts += red[sl * BN + t];
        tq += red[kThreads + sl * BN + t];
      }
      a.part_sum[(size_t)m_tile * a.n + n0 + t] = ts;
      a.part_sq[(size_t)m_tile * a.n + n0 + t] = tq;
    }
  } else if (EPI == kTensorCores) {
    // warps 0-3 form ones . acc for the tile's four 16-column groups, warps 4-7
    // ones . acc^2, each as three exact TF32 parts (see the header)
    const int group = warp & 3;
    const bool square = warp >= 4;
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> ones;
    wmma::fragment<wmma::accumulator, 16, 16, 8, float> sums;
    wmma::fill_fragment(ones, 1.f);
    wmma::fill_fragment(sums, 0.f);
    for (int r0 = 0; r0 < BM; r0 += 8) {
      wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> v, part;
      wmma::load_matrix_sync(v, cs + r0 * CS_LD + group * 16, CS_LD);
      if (square) {
#pragma unroll
        for (int e = 0; e < v.num_elements; ++e) v.x[e] = v.x[e] * v.x[e];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int e = 0; e < v.num_elements; ++e) {
          part.x[e] = wmma::__float_to_tf32(v.x[e]);
          v.x[e] -= part.x[e];
        }
        wmma::mma_sync(sums, ones, part, sums);
      }
    }
    // all 16 rows of the result are the same column sums: row 0 is read
    wmma::store_matrix_sync(red + warp * 256, sums, 16, wmma::mem_row_major);
    __syncwarp();
    const int col = n0 + group * 16 + lane;
    if (lane < 16 && col < a.n) {
      (square ? a.part_sq : a.part_sum)[(size_t)m_tile * a.n + col] = red[warp * 256 + lane];
    }
  }
  __syncthreads();  // the next tile's loads overwrite the accumulator
}

// One block for each (M tile, N tile); the N tiles of an M tile are neighbours.
template <int EPI>
__global__ void __launch_bounds__(kThreads) matmul_grid_kernel(Args a, int n_tiles) {
  __shared__ __align__(128) unsigned char smem[kTileBytes];
  __shared__ __align__(32) float red[kRedFloats];
  const long long b = blockIdx.x;
  tile_product<EPI>(a, b / n_tiles, (int)(b % n_tiles), smem, red);
}

// One block for each M tile; it walks that tile's N tiles.
template <int EPI>
__global__ void __launch_bounds__(kThreads) matmul_rows_kernel(Args a, int n_tiles) {
  __shared__ __align__(128) unsigned char smem[kTileBytes];
  __shared__ __align__(32) float red[kRedFloats];
  for (int nt = 0; nt < n_tiles; ++nt) tile_product<EPI>(a, blockIdx.x, nt, smem, red);
}

// One warp per column: lane l adds M tiles l, l + 32, ... in order, then a
// fixed shuffle tree adds the 32 lanes.
__global__ void __launch_bounds__(kThreads)
matmul_stats_final_kernel(const float* __restrict__ part_sum, const float* __restrict__ part_sq,
                          float* __restrict__ out_sum, float* __restrict__ out_sq,
                          long long m_tiles, int n) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (col >= n) return;  // whole warps leave together
  float s = 0.f, q = 0.f;
  for (long long i = lane; i < m_tiles; i += 32) {
    s += part_sum[(size_t)i * n + col];
    q += part_sq[(size_t)i * n + col];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(kFull, s, o);
    q += __shfl_xor_sync(kFull, q, o);
  }
  if (lane == 0) {
    out_sum[col] = s;
    out_sq[col] = q;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// rows: the row decomposition (one block per M tile) or the 2-D one.
template <int EPI>
int run(const void* x, const void* w, void* y, float* part_sum, float* part_sq,
        float* out_sum, float* out_sq, long long m, int k, int n, long long m_tiles,
        bool rows, int device, void* stream) {
  const long long want_tiles = (m + BM - 1) / BM;
  const int n_tiles = (n + BN - 1) / BN;
  if (m < 1 || k < 1 || n < 1 || m_tiles != want_tiles ||
      want_tiles * (rows ? 1 : n_tiles) > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<bf16*>(y);
  a.part_sum = part_sum;
  a.part_sq = part_sq;
  a.m = m;
  a.k = k;
  a.n = n;
  a.vec_x = k % 8 == 0 && aligned16(x);
  a.vec_w = n % 8 == 0 && aligned16(w);
  a.vec_y = n % 8 == 0 && aligned16(y);
  if (rows) {
    matmul_rows_kernel<EPI><<<(unsigned)want_tiles, kThreads, 0, s>>>(a, n_tiles);
  } else {
    matmul_grid_kernel<EPI><<<(unsigned)(want_tiles * n_tiles), kThreads, 0, s>>>(a, n_tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || EPI == kNone) return (int)err;
  const int warps_per_block = kThreads / 32;
  matmul_stats_final_kernel<<<(n + warps_per_block - 1) / warps_per_block, kThreads, 0, s>>>(
      part_sum, part_sq, out_sum, out_sq, want_tiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

// All entries: x (m, k), w (k, n), y (m, n), contiguous bf16 on `device`; they
// return a cudaError_t. The three with sums also take part_sum and part_sq,
// f32 scratch of (m_tiles, n) with m_tiles = ceil(m / 128) (any other count is
// refused), and write out_sum and out_sq, f32[n].

// The product alone on the wmma tile: the route of stcd_matmul_bf16
// (matmul_hopper.cu) for the shapes that TMA cannot describe.
extern "C" int stcd_matmul_bf16_tiles(const void* x, const void* w, void* y, long long m, int k,
                                      int n, int device, void* stream) {
  return run<kNone>(x, w, y, nullptr, nullptr, nullptr, nullptr, m, k, n, (m + BM - 1) / BM,
                    true, device, stream);
}

// The sums on the CUDA cores, one block for each (M tile, N tile): the route of
// stcd_matmul_stats (matmul_hopper.cu) for the shapes that TMA cannot describe.
extern "C" int stcd_matmul_stats_tiles(const void* x, const void* w, void* y, float* part_sum,
                                       float* part_sq, float* out_sum, float* out_sq,
                                       long long m, int k, int n, long long m_tiles, int device,
                                       void* stream) {
  return run<kCudaCores>(x, w, y, part_sum, part_sq, out_sum, out_sq, m, k, n, m_tiles, false,
                         device, stream);
}

// The sums on the tensor cores on this tile: the route of stcd_matmul_stats_mma
// (matmul_hopper.cu) for the shapes that TMA cannot describe.
extern "C" int stcd_matmul_stats_mma_tiles(const void* x, const void* w, void* y,
                                           float* part_sum, float* part_sq, float* out_sum,
                                           float* out_sq, long long m, int k, int n,
                                           long long m_tiles, int device, void* stream) {
  return run<kTensorCores>(x, w, y, part_sum, part_sq, out_sum, out_sq, m, k, n, m_tiles, true,
                           device, stream);
}

// out_sum[c] = sum of part_sum[r][c] over r = 0 .. rows - 1 in index order (and
// out_sq of part_sq): the second launch of the wgmma routes of stcd_matmul_stats
// and stcd_matmul_stats_mma.
extern "C" int stcd_matmul_stats_sum_parts(const float* part_sum, const float* part_sq,
                                           float* out_sum, float* out_sq, long long rows, int n,
                                           void* stream) {
  const int warps_per_block = kThreads / 32;
  matmul_stats_final_kernel<<<(n + warps_per_block - 1) / warps_per_block, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(part_sum, part_sq, out_sum,
                                                                   out_sq, rows, n);
  return (int)cudaGetLastError();
}
