// Shared by cross_attention.cu (forward) and cross_attention_bwd.cu (backward):
// the tile geometry, the dtype conversions, the warp reductions, the stateless
// dropout hash, and the tensor-core building blocks of the bf16 variant
// (ldmatrix, mma.sync.m16n8k16, cp.async, the staging of bf16 rows into padded
// shared memory). Every variant takes the keep decision from keep_element
// below, so the forward and the backward mask cannot drift apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stcd {

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
constexpr uint32_t kHashBh = 0x9E3779B9u, kHashRow = 0x85EBCA6Bu, kHashCol = 0xC2B2AE35u;

// The keep decision from the linear part of the hash, which a kernel may sum
// in pieces (uint32 addition wraps, so the order does not matter).
__device__ __forceinline__ bool keep_from_sum(uint32_t h, uint32_t bh, uint32_t threshold) {
  return fmix32(fmix32(h) ^ bh) >= threshold;
}

__device__ __forceinline__ bool keep_element(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t threshold) {
  return keep_from_sum(seed + bh * kHashBh + row * kHashRow + col * kHashCol, bh, threshold);
}

// The batch rows and heads of the hash. A launch over one shard of a batch (a
// data-parallel rank's rows, a pipeline's microbatch) and of its heads (a
// tensor-parallel rank's heads h0 .. h0 + heads of head_total) hashes its head
// bh = b * heads + h as (off + stride * b) * head_total + h0 + h, the index that
// head has in the global array's mask; memory is indexed by bh as before.
// {1, 0, 1, 0, 1} hashes bh itself, and so does any heads with {0, 1, 0, heads}.
struct HashRows {
  int heads, off, stride, h0, head_total;
};

__device__ __forceinline__ uint32_t hash_bh(int bh, HashRows r) {
  return (uint32_t)(r.off + r.stride * (bh / r.heads)) * (uint32_t)r.head_total +
         (uint32_t)(r.h0 + bh % r.heads);
}

inline bool hash_rows_valid(int bh, int heads, int off, int stride, int h0, int head_total) {
  return heads >= 1 && bh % heads == 0 && off >= 0 && stride >= 1 && h0 >= 0 &&
         h0 + heads <= head_total;
}

// The seed is a host value, or the low 32 bits of an int64 that lies on the
// device (so that drawing it on the card forces no host sync).
__device__ __forceinline__ uint32_t resolve_seed(uint32_t seed, const long long* seed_ptr) {
  return seed_ptr != nullptr ? (uint32_t)(*seed_ptr) : seed;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---- the variants; the wrapper picks one from (dtype, M) and passes its code
constexpr int kVariantF32 = 0;     // f32 at M > 8: CUDA cores
constexpr int kVariantMma = 1;     // bf16 at M > 8: tensor cores
constexpr int kVariantSmallM = 2;  // M <= 8, either dtype: a lane group per query row
constexpr int kSmallM = 8;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may ask for

// ---- bf16 tensor-core building blocks -------------------------------------
typedef __nv_bfloat16 bf16;
constexpr int kMmaWarps = 8;    // warps per block of the tensor-core kernels
constexpr int kMmaRows = 16;    // rows of one mma.sync tile
constexpr int kMmaPad = 8;      // bf16 of padding per shared-memory row: the row
                                // stride in 16-byte units is odd, so the eight
                                // rows of an ldmatrix land in distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lane l gives the address of row (l & 7) of matrix (l >> 3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col). With g = lane >> 2
// and t = lane & 3 a lane holds c[0], c[1] = (row g, cols 2t, 2t + 1) and
// c[2], c[3] = (row g + 8, the same cols); a[0..3] = (g, 2t..), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..); b0 = (k 2t.., n g), b1 = (k 2t + 8.., n g).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special-function unit alone (relative error 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + nrows) of a contiguous (total_rows, d) bf16 matrix go to
// dst[r][0 .. DPAD) with a row stride of DPAD + kMmaPad; rows past total_rows
// and columns past d are zero. `vec`: d is a multiple of 8 and src is 16-byte
// aligned, so whole 16-byte pieces are copied by cp.async (the caller commits
// and waits); else, and for the zero fill, plain stores. Thread `tid` of
// `nthreads` takes every nthreads-th piece.
template <int DPAD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                           int total_rows, int d, bool vec, int tid,
                                           int nthreads) {
  constexpr int LD = DPAD + kMmaPad;
  constexpr int CPR = DPAD / 8;  // 16-byte pieces a row
  for (int i = tid; i < nrows * CPR; i += nthreads) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * 8;
    bf16* p = dst + r * LD + c;
    const int gr = row0 + r;
    if (vec && gr < total_rows && c + 8 <= d) {
      cp_async16(p, src + (size_t)gr * d + c);
    } else {
      alignas(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        tmp[e] = (gr < total_rows && c + e < d) ? src[(size_t)gr * d + c + e]
                                                : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---- the M <= 8 variant: a group of G lanes owns a query row ---------------
// Lane j of the group holds 8 columns of the row, laid out so that the group's
// 16-byte pieces are neighbours: f32 as two pieces at columns (p * G + j) * 4,
// p = 0, 1; bf16 as one piece at column j * 8. A group covers 8 G >= D columns.
constexpr int kSmallThreads = 256;

template <typename T, int G>
__device__ __forceinline__ int small_col(int j, int i) {
  return sizeof(T) == 4 ? ((i >> 2) * G + j) * 4 + (i & 3) : j * 8 + i;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The lane's 8 columns of a row of d values, as f32; zeros past d or when
// !valid. `vec`: whole 16-byte pieces may be read (d a multiple of the piece
// and the tensor 16-byte aligned).
template <int G>
__device__ __forceinline__ void load_row8(float (&x)[8], const float* row, int j, int d,
                                          bool valid, bool vec) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = (p * G + j) * 4;
    if (valid && vec && c + 4 <= d) {
      const float4 t = *reinterpret_cast<const float4*>(row + c);
      x[4 * p] = t.x; x[4 * p + 1] = t.y; x[4 * p + 2] = t.z; x[4 * p + 3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * p + e] = (valid && c + e < d) ? row[c + e] : 0.f;
    }
  }
}
template <int G>
__device__ __forceinline__ void load_row8(float (&x)[8], const bf16* row, int j, int d,
                                          bool valid, bool vec) {
  const int c = j * 8;
  if (valid && vec && c + 8 <= d) {
    const uint4 t = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x; x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = (valid && c + e < d) ? __bfloat162float(row[c + e]) : 0.f;
  }
}

template <int G>
__device__ __forceinline__ void store_row8(float* row, const float (&x)[8], int j, int d,
                                           bool vec) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = (p * G + j) * 4;
    if (vec && c + 4 <= d) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(x[4 * p], x[4 * p + 1], x[4 * p + 2], x[4 * p + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) if (c + e < d) row[c + e] = x[4 * p + e];
    }
  }
}
template <int G>
__device__ __forceinline__ void store_row8(bf16* row, const float (&x)[8], int j, int d,
                                           bool vec) {
  const int c = j * 8;
  if (vec && c + 8 <= d) {
    uint4 t;
    t.x = pack_bf16(x[0], x[1]); t.y = pack_bf16(x[2], x[3]);
    t.z = pack_bf16(x[4], x[5]); t.w = pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(row + c) = t;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) if (c + e < d) row[c + e] = __float2bfloat16(x[e]);
  }
}

// K and V of one head (m <= kSmallM rows of d) as f32 rows of DS columns, zero past d.
template <typename T, int DS>
__device__ __forceinline__ void stage_small_kv(float* ks, float* vs, const T* kb, const T* vb,
                                               int m, int d, int tid) {
  for (int i = tid; i < m * DS; i += kSmallThreads) {
    const int r = i / DS;
    const int c = i - r * DS;
    ks[i] = c < d ? to_f32(kb[(size_t)r * d + c]) : 0.f;
    vs[i] = c < d ? to_f32(vb[(size_t)r * d + c]) : 0.f;
  }
}

// ---- the f32 variants (f32_cuda): rows of D padded to an odd number of float4s
constexpr int kF32Threads = 256;

// D as the f32 kernels pad it in shared memory (their template instances).
inline int f32_dpad(int d) { return d <= 32 ? 32 : d <= 48 ? 48 : d <= 64 ? 64 : d <= 80 ? 80 : 128; }

// Rows [row0, row0 + nrows) of a contiguous (total, d) f32 matrix into
// dst[r][0 .. DP) with a row stride of DP + 4 floats (an odd number of 16-byte
// pieces: eight neighbouring rows read as float4 hit eight distinct bank
// groups); zero past `total` and past d. `vec`: d % 4 == 0 and src 16-byte
// aligned; whole pieces then go by cp.async (the caller commits and waits), the
// rest by plain stores.
template <int DP>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, int row0,
                                          int nrows, int total, int d, bool vec, int tid) {
  constexpr int LD = DP + 4;
  constexpr int Q4 = DP / 4;
  for (int i = tid; i < nrows * Q4; i += kF32Threads) {
    const int r = i / Q4;
    const int c = (i - r * Q4) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < total && c < d) {
      const float* p = src + (size_t)gr * d + c;
      if (vec) {
        cp_async16(dst + r * LD + c, p);
        continue;
      } else {
        x.x = p[0];
        if (c + 1 < d) x.y = p[1];
        if (c + 2 < d) x.z = p[2];
        if (c + 3 < d) x.w = p[3];
      }
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The f32 kernels' columns of thread tx (of 16 along a row of DP): C = 4 G4 + G1 of
// them, 4 tx + 64 g (a float4, g < G4) and 64 G4 + tx + 16 u (one column, u < G1).
template <int DP>
__device__ __forceinline__ void load_cols(float (&x)[4 * (DP / 64) + (DP % 64) / 16],
                                          const float* row, int tx) {
  constexpr int G4 = DP / 64, G1 = (DP % 64) / 16;
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const float4 t = *reinterpret_cast<const float4*>(row + 4 * tx + 64 * g);
    x[4 * g] = t.x;
    x[4 * g + 1] = t.y;
    x[4 * g + 2] = t.z;
    x[4 * g + 3] = t.w;
  }
#pragma unroll
  for (int u = 0; u < G1; ++u) x[4 * G4 + u] = row[64 * G4 + tx + 16 * u];
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace stcd
