// Shared by cross_attention.cu (forward) and cross_attention_bwd.cu (backward):
// the tile geometry, the dtype conversions, the warp reductions and the
// stateless dropout hash. Both kernels take the keep decision from
// keep_element below, so the forward and the backward mask cannot drift apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stcd {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockN = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kChunk = 32;                      // keys per chunk: one per lane
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// murmur3 finaliser, as _fmix32 in stcd_tpu/ops/attention.py
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// dropout_keep_mask (stcd_tpu/ops/attention.py:48-63) in plain uint32
// arithmetic on (seed, bh, global row, col): bit-identical to the JAX and the
// plain PyTorch versions.
__device__ __forceinline__ bool keep_element(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t threshold) {
  uint32_t h = seed + bh * 0x9E3779B9u + row * 0x85EBCA6Bu + col * 0xC2B2AE35u;
  h = fmix32(fmix32(h) ^ bh);
  return h >= threshold;
}

// The seed is a host value, or the low 32 bits of an int64 that lies on the
// device (so that drawing it on the card forces no host sync).
__device__ __forceinline__ uint32_t resolve_seed(uint32_t seed, const long long* seed_ptr) {
  return seed_ptr != nullptr ? (uint32_t)(*seed_ptr) : seed;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace stcd
