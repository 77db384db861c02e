// Per-channel sum and sum of squares for Hopper (sm_90a): the two batch
// statistics of a channels-last (rows, C) view, accumulated in f32.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/bn_stats.py::_stats_kernel
// (launched by bn_stats_pallas). The TPU kernel walks row tiles in order and
// keeps the (1, C) sums resident in VMEM; its lane folding of narrow C and its
// supports_pallas shape rule are TPU layout matters and are not carried over.
// Here any rows and any C are taken:
//
// - A thread owns a group of V neighbouring channels (V = 16 bytes of the
//   input: 4 floats or 8 bf16, or 1 where C or the pointer does not allow a
//   16-byte load) and walks down rows. A block of 256 threads covers
//   W = min(C / V, 256) groups and R = 256 / W rows at a time, so for C / V
//   <= 256 a pass reads one contiguous run of memory. Wider C takes
//   gridDim.y column tiles.
// - Deterministic accumulation: each thread sums its rows in order, the R row
//   slots of a block are added in index order through shared memory, the
//   block writes its share to an f32 scratch (blocks, C), and a second launch
//   sums the blocks per channel (lane-strided in order, then a fixed shuffle
//   tree). No float atomics: two runs agree bit for bit.
//
// What bounds it: bytes. x is read once (2 operations per element against 2
// or 4 bytes), so the least time is the size of x over the memory rate; the
// design aims at 16-byte coalesced loads with enough blocks in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int V>
struct Loader;

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* out) { out[0] = *p; }
};
template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(*p);
  }
};
template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part_sum,
                        float* __restrict__ part_sq, long long rows, int c,
                        long long rows_per_block) {
  __shared__ float sh_sum[kThreads * V];
  __shared__ float sh_sq[kThreads * V];
  const int groups = c / V;
  const int g0 = blockIdx.y * kThreads;
  const int w = min(groups - g0, kThreads);  // groups of this column tile
  const int r_slots = kThreads / w;          // rows covered per pass
  const int t = threadIdx.x;
  const int slot = t / w;
  const int group = g0 + t - slot * w;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float sum[V], sq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sum[e] = 0.f;
    sq[e] = 0.f;
  }
  if (slot < r_slots) {
    const T* col = x + (size_t)group * V;
#pragma unroll 4
    for (long long r = r0 + slot; r < r1; r += r_slots) {
      float val[V];
      Loader<T, V>::load(col + (size_t)r * c, val);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum[e] += val[e];
        sq[e] = fmaf(val[e], val[e], sq[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sh_sum[t * V + e] = sum[e];
    sh_sq[t * V + e] = sq[e];
  }
  __syncthreads();
  if (t < w) {  // add the row slots in index order
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float a = 0.f, b = 0.f;
      for (int s = 0; s < r_slots; ++s) {
        a += sh_sum[(s * w + t) * V + e];
        b += sh_sq[(s * w + t) * V + e];
      }
      const size_t at = (size_t)blockIdx.x * c + (size_t)(g0 + t) * V + e;
      part_sum[at] = a;
      part_sq[at] = b;
    }
  }
}

// One warp per channel: lane l adds blocks l, l + 32, ... in order, then a
// fixed shuffle tree adds the 32 lanes.
__global__ void __launch_bounds__(kThreads)
bn_stats_final_kernel(const float* __restrict__ part_sum, const float* __restrict__ part_sq,
                      float* __restrict__ out_sum, float* __restrict__ out_sq, int blocks,
                      int c) {
  const int ch = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ch >= c) return;  // whole warps leave together
  float a = 0.f, b = 0.f;
  for (int i = lane; i < blocks; i += 32) {
    a += part_sum[(size_t)i * c + ch];
    b += part_sq[(size_t)i * c + ch];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  if (lane == 0) {
    out_sum[ch] = a;
    out_sq[ch] = b;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, float* part_sum, float* part_sq, float* out_sum,
                   float* out_sq, long long rows, int c, int blocks, cudaStream_t stream) {
  const int groups = c / V;
  const dim3 grid(blocks, (groups + kThreads - 1) / kThreads);
  const long long rows_per_block = (rows + blocks - 1) / blocks;
  bn_stats_partial_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_sum, part_sq, rows, c, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps_per_block = kThreads / 32;
  bn_stats_final_kernel<<<(c + warps_per_block - 1) / warps_per_block, kThreads, 0, stream>>>(
      part_sum, part_sq, out_sum, out_sq, blocks, c);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, c) contiguous on `device`; dtype: 0 = float32, 1 = bfloat16.
// vec: channels per load, 1 or 16 bytes' worth (4 for float32, 8 for bfloat16);
// with vec > 1, c must divide by vec and x must be 16-byte aligned.
// part_sum, part_sq: float32 scratch of (blocks, c); out_sum, out_sq: float32[c].
// Returns a cudaError_t.
extern "C" int stcd_bn_stats_fwd(const void* x, float* part_sum, float* part_sq,
                                 float* out_sum, float* out_sq, long long rows, int c,
                                 int dtype, int vec, int blocks, int device,
                                 void* stream) {
  const int full = dtype == 0 ? 4 : 8;
  if (rows < 1 || c < 1 || dtype < 0 || dtype > 1 || blocks < 1 || blocks > 65535 * 32 ||
      (vec != 1 && vec != full) || c % vec != 0 ||
      (vec > 1 && reinterpret_cast<uintptr_t>(x) % 16 != 0) ||
      (c / vec + kThreads - 1) / kThreads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = vec == 1 ? launch<float, 1>(x, part_sum, part_sq, out_sum, out_sq, rows, c, blocks, s)
                   : launch<float, 4>(x, part_sum, part_sq, out_sum, out_sq, rows, c, blocks, s);
  } else {
    err = vec == 1
              ? launch<__nv_bfloat16, 1>(x, part_sum, part_sq, out_sum, out_sq, rows, c, blocks, s)
              : launch<__nv_bfloat16, 8>(x, part_sum, part_sq, out_sum, out_sq, rows, c, blocks, s);
  }
  return (int)err;
}
