// Fused train-time photometric augmentation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/augment_kernel.py::_augment_kernel
// (launched by _planar_pallas). Per image it computes the same function:
// uint8 -> [0, 1] (float input passes through); if the jitter flag is set, the
// four ColorJitter ops in the image's own order `perm` (0 brightness,
// 1 contrast, 2 saturation, 3 hue), each clamped to [0, 1]; RandomGrayscale;
// an 11-tap separable Gaussian blur with edge-replicate borders; ImageNet
// normalisation to float32. The random draws arrive as arguments, as the
// sampler made them (perm int64, the three flags bool): the wrapper converts
// nothing.
//
// It is not carried over block by block. The TPU kernel holds one whole planar
// image in VMEM, so the contrast op can take the mean of the image's grayscale
// in the middle of the chain. A 256x256 RGB image is 768 KB in f32 and an SM
// has 227 KB of shared memory, so here the work is two launches:
//
//  (a) gray_mean_partials: for the jittered images, each thread runs the
//      chain's prefix up to the contrast op on runs of 4 pixels (brightness,
//      saturation and hue are pointwise) and the block reduces the gray
//      values; kReduceBlocks partial sums per image, every sum taken in a
//      fixed order (no float atomics), so two runs agree bit for bit. The
//      mean of the whole image must exist before any pixel's chain runs, so
//      this launch stays;
//  (b) augment_tiles: a block owns a kTileH x kTileW tile of one image (the
//      geometry of ops/augment.py::augment_plan, which the C entry checks). It
//      adds the image's partials in a fixed order for the mean, then:
//      - an image that is not blurred: a thread takes runs of 4 pixels of the
//        tile, runs the chain and grayscale, normalises and stores; no shared
//        memory, no halo;
//      - a blurred image: the block runs the chain and grayscale on the tile
//        and its 5-pixel halo (indices clamped to the edge, which is
//        edge-replicate padding) into shared memory, one plane a channel;
//        blurs vertically in place (a thread owns a column of a plane and
//        slides a window of 11 rows in registers down it), then horizontally
//        (a thread reads 16 values of a row by four 16-byte loads and forms 4
//        outputs), as the plain version does, normalises and stores.
//      A thread of an image that is not blurred reads runs of 4 pixels as three
//      4-byte words (uint8) or three 16-byte words (float32) wherever W is a
//      multiple of 4 and the run lies inside the image; the staging of a
//      blurred tile takes single pixels, which spreads the 3108 chains of the
//      tile and halo evenly over the threads. Every thread issues its next
//      load before it runs the chain on its current pixels. A warp's runs
//      leave through 1.5 KB of shared memory of its own, so that each tile row
//      goes out as 48 consecutive 16-byte stores; the ragged edges take single
//      pixels.
//
// The flags are per image, so a whole block takes one side of each gate; the
// TPU kernel evaluates both sides of every select. The layout is NHWC in and
// out (the planar (N, 3H, W) form was a lane trick of the TPU), any H and W
// (ragged tiles are masked, nothing is padded in device memory). The blur is a
// direct f32 stencil instead of band-matrix matmuls.
//
// Arithmetic follows the plain PyTorch version op by op: __fmul_rn, __fadd_rn
// and __fsub_rn keep nvcc from contracting a*b+c into an FMA, the divisions
// are IEEE, and the floor-mod of the hue is x - floorf(x). The equality tests
// of the HSV conversion compare the same values the plain version compares.
// So a halo pixel that two blocks compute comes out the same in both. A uint8
// channel is converted by a 256-entry table of dvd(b, 255) in shared memory:
// the division's own results, looked up.
//
// What bounds it: bytes. Each pixel is read once (3 or 12 bytes) and written
// once (12 bytes) against some 100-250 f32 operations, so the least time is
// the traffic over the memory rate. This design moves that, plus a second read
// of the jittered images by (a) (3 bytes a pixel for uint8) and the halo's
// re-reads, which L2 serves: no scratch image goes through device memory. The
// halo costs a blurred tile (32 + 10) x (64 + 10) / (32 x 64) = 1.52 times its
// chain computations; an image that is not blurred pays nothing for it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceBlocks = 16;  // partial sums per image, at most 32 (ops/augment.py REDUCE_BLOCKS)
constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileH = 32;  // ops/augment.py augment_plan: TILE_H, TILE_W
constexpr int kTileW = 64;
constexpr int kRun = 4;                             // pixels a thread loads and stores at once
constexpr int kStageRows = kTileH + 2 * kRadius;    // 42
constexpr int kStageW = kTileW + 2 * kRadius;       // 74 staged pixels a row
constexpr int kStageStride = 76;                    // floats a staged row: 16-byte rows
constexpr int kStageBytes = 3 * kStageRows * kStageStride * 4;
constexpr int kStoreBytes = kThreads * 3 * 16;  // each warp's 96 16-byte words for stores
constexpr int kSmemBytes = kStageBytes + kStoreBytes;

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float floor_mod1(float x) { return sub(x, floorf(x)); }

__device__ __forceinline__ float gray_of(const Rgb& p) {
  return add(add(mul(0.299f, p.r), mul(0.587f, p.g)), mul(0.114f, p.b));
}

__device__ __forceinline__ float channel_mean(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}

__device__ __forceinline__ float channel_std(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}

__device__ __forceinline__ float normalize(float x, int c) {
  return dvd(sub(x, channel_mean(c)), channel_std(c));
}

__device__ __forceinline__ Rgb blend(const Rgb& p, float f, float other) {
  // x * f + other * (1 - f), clamped: contrast (other = the image's gray mean)
  // and saturation (other = the pixel's gray)
  const float o = mul(other, sub(1.0f, f));
  return {clamp01(add(mul(p.r, f), o)), clamp01(add(mul(p.g, f), o)),
          clamp01(add(mul(p.b, f), o))};
}

__device__ __forceinline__ Rgb adjust_hue(const Rgb& in, float shift) {
  const float r = clamp01(in.r), g = clamp01(in.g), b = clamp01(in.b);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float deltac = sub(maxc, minc);
  const float s_any = dvd(deltac, fmaxf(maxc, 1e-8f));  // then selected: no branch
  const float s = maxc > 0.0f ? s_any : 0.0f;
  const float dsafe = fmaxf(deltac, 1e-8f);
  const float rc = dvd(sub(maxc, r), dsafe);
  const float gc = dvd(sub(maxc, g), dsafe);
  const float bc = dvd(sub(maxc, b), dsafe);
  float hh = r == maxc ? sub(bc, gc)
                       : (g == maxc ? sub(add(2.0f, rc), bc) : sub(add(4.0f, gc), rc));
  hh = floor_mod1(dvd(hh, 6.0f));
  if (deltac == 0.0f) hh = 0.0f;
  hh = floor_mod1(add(hh, shift));
  const float v = maxc;
  const float h6 = mul(hh, 6.0f);
  const float i = floorf(h6);
  const float f = sub(h6, i);
  const float p = mul(v, sub(1.0f, s));
  const float q = mul(v, sub(1.0f, mul(f, s)));
  const float t = mul(v, sub(1.0f, mul(sub(1.0f, f), s)));
  // the sector picks (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q) by
  // selects, not a branch that splits the warp; i is 6 where hh rounded up to 1.0
  const int sec = ((int)i) % 6;
  const float ro = (sec == 0 || sec == 5) ? v : sec == 1 ? q : sec == 4 ? t : p;
  const float go = sec == 0 ? t : (sec == 1 || sec == 2) ? v : sec == 3 ? q : p;
  const float bo = (sec == 0 || sec == 1) ? p : sec == 2 ? t : sec == 5 ? q : v;
  return {ro, go, bo};
}

__device__ __forceinline__ Rgb apply_op(int op, const Rgb& p, const float* fac, float mean) {
  switch (op) {
    case 0: return {clamp01(mul(p.r, fac[0])), clamp01(mul(p.g, fac[0])),
                    clamp01(mul(p.b, fac[0]))};
    case 1: return blend(p, fac[1], mean);
    case 2: return blend(p, fac[2], gray_of(p));
    case 3: return adjust_hue(p, fac[3]);
    default: return p;
  }
}

// The 256 values of dvd(b, 255) in the block's shared memory: a uint8 channel is
// converted by a look-up that gives the division's own result.
__device__ __forceinline__ void fill_u8_table(float* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) table[i] = dvd((float)i, 255.0f);
  __syncthreads();
}

// A run of up to 4 consecutive pixels as read from device memory: fetch_run issues
// the loads, decode_run converts, so that a thread can fetch its next run before it
// works on the current one. uint8: the 12 channel bytes in three words; float: the
// 12 channel values.
template <typename T>
struct Raw;
template <>
struct Raw<uint8_t> {
  uint32_t word[3];
};
template <>
struct Raw<float> {
  float v[3 * kRun];
};

// `count` (0-4) pixels from `px` on: three words (three 4-byte loads for uint8, three
// 16-byte loads for float) where `vec` says a whole run may be read so (4-byte
// aligned for uint8, 16-byte for float), else single channels.
__device__ __forceinline__ Raw<uint8_t> fetch_run(const uint8_t* px, int count, bool vec) {
  Raw<uint8_t> r = {{0u, 0u, 0u}};
  if (vec && count == kRun) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(px);
#pragma unroll
    for (int e = 0; e < 3; ++e) r.word[e] = q[e];
    return r;
  }
#pragma unroll
  for (int b = 0; b < 3 * kRun; ++b) {  // static indices: r stays in registers
    if (b < 3 * count) r.word[b >> 2] |= (uint32_t)px[b] << (8 * (b & 3));
  }
  return r;
}

__device__ __forceinline__ Raw<float> fetch_run(const float* px, int count, bool vec) {
  Raw<float> r;
  if (vec && count == kRun) {
    const float4* q = reinterpret_cast<const float4*>(px);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float4 f = q[e];
      r.v[4 * e] = f.x;
      r.v[4 * e + 1] = f.y;
      r.v[4 * e + 2] = f.z;
      r.v[4 * e + 3] = f.w;
    }
    return r;
  }
#pragma unroll
  for (int e = 0; e < 3 * kRun; ++e) r.v[e] = e < 3 * count ? px[e] : 0.0f;
  return r;
}

// uint8 channels go through `table` (fill_u8_table): the division's own results.
__device__ __forceinline__ void decode_run(const Raw<uint8_t>& r, const float* table,
                                           Rgb (&p)[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    float c[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int b = 3 * j + e;
      c[e] = table[(r.word[b >> 2] >> (8 * (b & 3))) & 0xffu];
    }
    p[j] = Rgb{c[0], c[1], c[2]};
  }
}

__device__ __forceinline__ void decode_run(const Raw<float>& r, const float*, Rgb (&p)[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) p[j] = Rgb{r.v[3 * j], r.v[3 * j + 1], r.v[3 * j + 2]};
}

// The 12 floats of each lane's run of 4 pixels, RGB interleaved. Lanes 16 hw ..
// 16 hw + 15 of a warp hold the 64 pixels of tile row y (half-warp hw), lane `lane`
// those from column x on. Where the whole tile row lies inside the image and 16-byte
// stores are allowed (`rows`, uniform over the block), the runs go through the warp's
// 96 16-byte words of shared memory `xw` (three a lane, 48 bytes apart: no bank
// conflicts), and each half-warp stores its row's 768 bytes as 48 consecutive 16-byte
// words, 16 lanes on neighbouring words. Else each lane stores its own run's floats.
// Every lane of the warp calls it.
__device__ __forceinline__ void store_runs(float4* xw, const float (&o)[3 * kRun], float* dst,
                                           int y, int x, int x0, int h, int w, bool rows,
                                           int lane) {
  if (rows) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      xw[3 * lane + e] = make_float4(o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3]);
    }
    __syncwarp();
    if (y < h) {
      float4* g = reinterpret_cast<float4*>(dst + ((size_t)y * w + x0) * 3);
      const int half = lane >> 4, hl = lane & 15;
#pragma unroll
      for (int m = 0; m < 3; ++m) g[hl + 16 * m] = xw[48 * half + hl + 16 * m];
    }
    __syncwarp();
    return;
  }
  if (y >= h || x >= w) return;
  float* out = dst + ((size_t)y * w + x) * 3;
#pragma unroll
  for (int e = 0; e < 3 * kRun; ++e) {
    if (e < 3 * (w - x)) out[e] = o[e];
  }
}

// One image's draws, read once a block.
struct Chain {
  int jitter, gray;
  int op[4];
  float fac[4];
  float mean;
};

__device__ __forceinline__ Chain read_chain(const long long* perm, const float* factors,
                                            const uint8_t* jitter, const uint8_t* gray, int n) {
  Chain c;
  c.jitter = jitter[n] != 0;
  c.gray = gray[n] != 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.op[k] = (int)perm[n * 4 + k];
    c.fac[k] = factors[n * 4 + k];
  }
  c.mean = 0.0f;
  return c;
}

// The pointwise part: the jitter chain in the image's order, then grayscale.
__device__ __forceinline__ Rgb run_chain(Rgb p, const Chain& c) {
  if (c.jitter) {
#pragma unroll
    for (int k = 0; k < 4; ++k) p = apply_op(c.op[k], p, c.fac, c.mean);
  }
  if (c.gray) {
    const float g = gray_of(p);
    p = Rgb{g, g, g};
  }
  return p;
}

// (a) partials[n, blockIdx.x] = sum of gray(prefix chain(pixel)) over the
// block's runs of image n. The run-to-thread map, the shuffle tree and the warp
// order are fixed, so the sum is reproducible.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gray_mean_partials(const T* __restrict__ img, const long long* __restrict__ perm,
                   const float* __restrict__ factors, const uint8_t* __restrict__ jitter,
                   float* __restrict__ partials, int hw, int vec) {
  const int n = blockIdx.y;
  if (jitter[n] == 0) return;
  __shared__ float table[256];
  fill_u8_table(table);
  int op[4];
  float fac[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    op[k] = (int)perm[n * 4 + k];
    fac[k] = factors[n * 4 + k];
  }
  const T* src = img + (size_t)n * hw * 3;
  float acc = 0.0f;
  const int runs = (hw + kRun - 1) / kRun;
  constexpr int kStride = kReduceBlocks * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  auto count_of = [&](int run) { return run < runs ? min(kRun, hw - kRun * run) : 0; };
  Raw<T> next = fetch_run(src + (size_t)kRun * i * 3, count_of(i), vec != 0);
  for (; i < runs; i += kStride) {
    const int count = count_of(i);
    const Raw<T> cur = next;
    next = fetch_run(src + (size_t)kRun * (i + kStride) * 3, count_of(i + kStride), vec != 0);
    Rgb p[kRun];
    decode_run(cur, table, p);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j >= count) break;
      Rgb q = p[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (op[k] == 1) break;
        q = apply_op(op[k], q, fac, 0.0f);
      }
      acc = add(acc, gray_of(q));
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc = add(acc, __shfl_down_sync(0xffffffffu, acc, off));
  __shared__ float warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int wi = 0; wi < kThreads / 32; ++wi) total = add(total, warp_sums[wi]);
    partials[n * kReduceBlocks + blockIdx.x] = total;
  }
}

// (b) one kTileH x kTileW tile of image blockIdx.z at (blockIdx.x, blockIdx.y):
// chain, grayscale, the blur where the image's flag says so, normalisation.
// vec_in, vec_out: the bases allow whole-run loads and stores and W % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
augment_tiles(const T* __restrict__ img, const long long* __restrict__ perm,
              const float* __restrict__ factors, const uint8_t* __restrict__ jitter,
              const uint8_t* __restrict__ gray, const uint8_t* __restrict__ blur,
              const float* __restrict__ kern, const float* __restrict__ partials,
              float* __restrict__ out, int h, int w, int vec_in, int vec_out) {
  extern __shared__ float4 smem_raw[];
  // the staged tile and halo, one plane a channel; then each warp's 96 words for stores
  float(*stage)[kStageRows][kStageStride] =
      reinterpret_cast<float(*)[kStageRows][kStageStride]>(smem_raw);
  __shared__ float s_mean;
  __shared__ float table[256];
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  float4* xw = smem_raw + kStageBytes / 16 + (tid >> 5) * 3 * 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int hw = h * w;
  Chain chain = read_chain(perm, factors, jitter, gray, n);
  fill_u8_table(table);
  if (chain.jitter) {  // uniform over the block: the mean from (a)'s partials in a fixed order
    if (tid < 32) {
      float total = tid < kReduceBlocks ? partials[n * kReduceBlocks + tid] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        total = add(total, __shfl_xor_sync(0xffffffffu, total, off));
      }
      if (tid == 0) s_mean = dvd(total, (float)hw);
    }
    __syncthreads();
    chain.mean = s_mean;
  }
  const T* src = img + (size_t)n * hw * 3;
  float* dst = out + (size_t)n * hw * 3;
  const bool rows = vec_out != 0 && x0 + kTileW <= w;
  // the tile's runs: item i is row i / 16, run i % 16 (its 4 pixels from x0 + 4 (i % 16));
  // every lane takes the same number of items, so that the stores can go by warps
  constexpr int kItems = kTileH * (kTileW / kRun);
  static_assert(kItems % kThreads == 0, "whole rounds of items");

  if (blur[n] == 0) {
    // the pixels item i holds, 0 past the image's edges
    auto count_of = [&](int i) {
      const int y = y0 + i / (kTileW / kRun), x = x0 + kRun * (i % (kTileW / kRun));
      return i < kItems && y < h ? max(0, min(kRun, w - x)) : 0;
    };
    auto fetch = [&](int i) {
      const int y = y0 + i / (kTileW / kRun), x = x0 + kRun * (i % (kTileW / kRun));
      const int count = count_of(i);
      return fetch_run(src + (count > 0 ? ((size_t)y * w + x) * 3 : 0), count, vec_in != 0);
    };
    Raw<T> next = fetch(tid);
    for (int i = tid; i < kItems; i += kThreads) {
      const int y = y0 + i / (kTileW / kRun), x = x0 + kRun * (i % (kTileW / kRun));
      const int count = count_of(i);
      const Raw<T> cur = next;
      next = fetch(i + kThreads);  // in flight while this item's chain runs
      float o[3 * kRun];
      if (count > 0) {
        Rgb p[kRun];
        decode_run(cur, table, p);
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (j < count) {
            const Rgb q = run_chain(p[j], chain);
            o[3 * j] = normalize(q.r, 0);
            o[3 * j + 1] = normalize(q.g, 1);
            o[3 * j + 2] = normalize(q.b, 2);
          }
        }
      }
      store_runs(xw, o, dst, y, x, x0, h, w, rows, lane);
    }
    return;
  }

  // staged pixel (sy, sx) is image pixel (clamp(y0 - 5 + sy), clamp(x0 - 5 + sx)); a
  // thread takes single pixels (every thread but a few has 13 of the 3108), the next
  // one's load in flight while the chain runs on this one
  constexpr int kStaged = kStageRows * kStageW;
  auto fetch_staged = [&](int i) {
    const int row = min(max(y0 - kRadius + i / kStageW, 0), h - 1);
    const int col = min(max(x0 - kRadius + i % kStageW, 0), w - 1);
    return fetch_run(src + ((size_t)row * w + col) * 3, i < kStaged ? 1 : 0, false);
  };
  Raw<T> next = fetch_staged(tid);
  for (int i = tid; i < kStaged; i += kThreads) {
    const Raw<T> cur = next;
    next = fetch_staged(i + kThreads);
    Rgb p[kRun];
    decode_run(cur, table, p);
    const Rgb q = run_chain(p[0], chain);
    const int sy = i / kStageW, sx = i % kStageW;
    stage[0][sy][sx] = q.r;
    stage[1][sy][sx] = q.g;
    stage[2][sy][sx] = q.b;
  }
  float tap[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) tap[t] = kern[n * kTaps + t];
  __syncthreads();

  // vertical, in place: output row r needs staged rows r .. r + 10, and a thread
  // owns its column, so row r is written only after every read of it
  for (int col = tid; col < 3 * kStageW; col += kThreads) {
    float* c = &stage[col / kStageW][0][col % kStageW];
    float win[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps - 1; ++t) win[t] = c[t * kStageStride];
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      win[kTaps - 1] = c[(r + kTaps - 1) * kStageStride];
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = add(acc, mul(tap[t], win[t]));
      c[r * kStageStride] = acc;
#pragma unroll
      for (int t = 0; t < kTaps - 1; ++t) win[t] = win[t + 1];
    }
  }
  __syncthreads();

  // horizontal: output pixel x0 + 4 g + j of row r reads staged columns 4 g + j ..
  // 4 g + j + 10 of each plane, 16 of them by four 16-byte loads
  for (int i = tid; i < kItems; i += kThreads) {
    const int r = i / (kTileW / kRun), gx = i % (kTileW / kRun);
    const int y = y0 + r, x = x0 + kRun * gx;
    float o[3 * kRun];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[16];
      const float4* q = reinterpret_cast<const float4*>(&stage[ch][r][kRun * gx]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 f = q[e];
        v[4 * e] = f.x;
        v[4 * e + 1] = f.y;
        v[4 * e + 2] = f.z;
        v[4 * e + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) acc = add(acc, mul(tap[t], v[j + t]));
        o[3 * j + ch] = normalize(acc, ch);
      }
    }
    store_runs(xw, o, dst, y, x, x0, h, w, rows, lane);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* img, const long long* perm, const float* factors,
                   const uint8_t* jitter, const uint8_t* gray, const uint8_t* blur,
                   const float* kern, float* out, float* partials, int n, int h, int w,
                   int tiles_x, int tiles_y, cudaStream_t stream) {
  const int hw = h * w;
  const T* src = static_cast<const T*>(img);
  // whole runs of 4 pixels start on 16-byte boundaries of every image (float) or on
  // 4-byte ones (uint8) when the base does and a row holds a multiple of 4 pixels
  const int vec_in = aligned16(img) && w % kRun == 0;
  const int vec_out = aligned16(out) && w % kRun == 0;
  gray_mean_partials<T><<<dim3(kReduceBlocks, n), kThreads, 0, stream>>>(
      src, perm, factors, jitter, partials, hw, aligned16(img) && hw % kRun == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(augment_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  augment_tiles<T><<<dim3(tiles_x, tiles_y, n), kThreads, kSmemBytes, stream>>>(
      src, perm, factors, jitter, gray, blur, kern, partials, out, h, w, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// img: (n, h, w, 3) contiguous, uint8 (is_u8 != 0) or float32 in [0, 1];
// perm (n, 4) int64, factors (n, 4) float32 (brightness, contrast, saturation,
// hue), jitter, gray, blur (n,) bool (one byte each), kern (n, 11) float32;
// out (n, h, w, 3) float32, partials (n, 16) float32 scratch; all on `device`.
// tiles_x, tiles_y and smem_bytes are ops/augment.py::augment_plan's; a call
// whose numbers are not this file's is refused. Two launches. Returns a
// cudaError_t.
extern "C" int stcd_augment_fwd(const void* img, int is_u8, const long long* perm,
                                const float* factors, const uint8_t* jitter,
                                const uint8_t* gray, const uint8_t* blur, const float* kern,
                                float* out, float* partials, int n, int h, int w, int tiles_x,
                                int tiles_y, int smem_bytes, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || (int64_t)h * w > (1 << 24) ||
      tiles_x != (w + kTileW - 1) / kTileW || tiles_y != (h + kTileH - 1) / kTileH ||
      tiles_y > 65535 || smem_bytes != kSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceGuard guard;
  cudaError_t err = guard.set(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_u8 ? launch<uint8_t>(img, perm, factors, jitter, gray, blur, kern, out, partials, n,
                                h, w, tiles_x, tiles_y, s)
              : launch<float>(img, perm, factors, jitter, gray, blur, kern, out, partials, n,
                              h, w, tiles_x, tiles_y, s);
  return (int)err;
}
