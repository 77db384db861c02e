// Fused train-time photometric augmentation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/augment_kernel.py::_augment_kernel
// (launched by _planar_pallas). Per image it computes the same function:
// uint8 -> [0, 1] (float input passes through); if the jitter flag is set, the
// four ColorJitter ops in the image's own order `perm` (0 brightness,
// 1 contrast, 2 saturation, 3 hue), each clamped to [0, 1]; RandomGrayscale;
// an 11-tap separable Gaussian blur with edge-replicate borders; ImageNet
// normalisation to float32. The random draws arrive as arguments.
//
// It is not carried over block by block. The TPU kernel holds one whole planar
// image in VMEM, so the contrast op can take the mean of the image's grayscale
// in the middle of the chain. A 256x256 RGB image is 768 KB in f32 and an SM
// has 227 KB of shared memory, so here the work is three launches:
//
//  (a) gray_mean_partials: for the jittered images, each thread runs the
//      chain's prefix up to the contrast op on its pixels (brightness,
//      saturation and hue are pointwise) and the block reduces the gray
//      values; kReduceBlocks partial sums per image, every sum taken in a
//      fixed order (no float atomics), so two runs agree bit for bit;
//  (b) pointwise_chain: one thread per pixel adds the partials in order, runs
//      the whole chain with that mean, then grayscale; it writes the
//      normalised result, or for an image that will be blurred the pre-blur
//      pixel to a scratch buffer;
//  (c) blur_normalize: for the blurred images, a block stages a tile with a
//      5-pixel halo in shared memory (indices clamped to the edge, which is
//      edge-replicate padding), blurs vertically then horizontally as the
//      plain version does, and normalises.
//
// The flags are per image, so a whole block skips a stage its image does not
// take; the TPU kernel evaluates both sides of every select. The layout is
// NHWC in and out (the planar (N, 3H, W) form was a lane trick of the TPU),
// any H and W (ragged tiles are masked, nothing is padded in device memory).
// The blur is a direct f32 stencil instead of band-matrix matmuls.
//
// Arithmetic follows the plain PyTorch version op by op: __fmul_rn, __fadd_rn
// and __fsub_rn keep nvcc from contracting a*b+c into an FMA, the divisions
// are IEEE, and the floor-mod of the hue is x - floorf(x). The equality tests
// of the HSV conversion compare the same values the plain version compares.
//
// What bounds it: bytes. Each pixel is read once (3 or 12 bytes) and written
// once (12 bytes) against some 100-250 f32 operations, so the least time is
// the traffic over the memory rate. This first version moves more than that:
// the jittered images are read twice (a, b) and the blurred images make a
// round trip through the scratch buffer. Fewer passes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceBlocks = 64;  // partial sums per image (ops/augment.py REDUCE_BLOCKS)
constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kTileCols = (kTileW + 2 * kRadius) * 3;  // floats per staged row

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

__device__ __forceinline__ Rgb load_px(const uint8_t* img, size_t px) {
  const uint8_t* s = img + px * 3;
  return {dvd((float)s[0], 255.0f), dvd((float)s[1], 255.0f), dvd((float)s[2], 255.0f)};
}

__device__ __forceinline__ Rgb load_px(const float* img, size_t px) {
  const float* s = img + px * 3;
  return {s[0], s[1], s[2]};
}

__device__ __forceinline__ Rgb blend(const Rgb& p, float f, float other) {
  // x * f + other * (1 - f), clamped: contrast (other = the image's gray mean)
  // and saturation (other = the pixel's gray)
  const float o = mul(other, sub(1.0f, f));
  return {clamp01(add(mul(p.r, f), o)), clamp01(add(mul(p.g, f), o)),
          clamp01(add(mul(p.b, f), o))};
}

__device__ Rgb adjust_hue(const Rgb& in, float shift) {
  const float r = clamp01(in.r), g = clamp01(in.g), b = clamp01(in.b);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float deltac = sub(maxc, minc);
  const float s = maxc > 0.0f ? dvd(deltac, fmaxf(maxc, 1e-8f)) : 0.0f;
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
  switch (((int)i) % 6) {  // i is 6 where hh rounded up to 1.0
    case 0: return {v, t, p};
    case 1: return {q, v, p};
    case 2: return {p, v, t};
    case 3: return {p, q, v};
    case 4: return {t, p, v};
    default: return {v, p, q};
  }
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

// (a) partials[n, blockIdx.x] = sum of gray(prefix chain(pixel)) over the
// block's pixels of image n. The pixel-to-thread map, the shuffle tree and the
// warp order are fixed, so the sum is reproducible.
template <typename T>
__global__ void gray_mean_partials(const T* __restrict__ img, const int* __restrict__ perm,
                                   const float* __restrict__ factors,
                                   const int* __restrict__ flags,
                                   float* __restrict__ partials, int hw) {
  const int n = blockIdx.y;
  if (flags[n * 3] == 0) return;
  const int* pm = perm + n * 4;
  const float* fac = factors + n * 4;
  const T* src = img + (size_t)n * hw * 3;
  float acc = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < hw; i += kReduceBlocks * kThreads) {
    Rgb p = load_px(src, i);
    for (int k = 0; k < 4; ++k) {
      const int op = pm[k];
      if (op == 1) break;
      p = apply_op(op, p, fac, 0.0f);
    }
    acc = add(acc, gray_of(p));
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

// (b) one thread per pixel: the whole chain, grayscale, and either the
// normalised output or, for an image that (c) will blur, the pre-blur pixel.
template <typename T>
__global__ void pointwise_chain(const T* __restrict__ img, const int* __restrict__ perm,
                                const float* __restrict__ factors,
                                const int* __restrict__ flags,
                                const float* __restrict__ partials, float* __restrict__ out,
                                float* __restrict__ scratch, int hw) {
  const int n = blockIdx.y;
  const int jitter = flags[n * 3], gray = flags[n * 3 + 1], blur = flags[n * 3 + 2];
  __shared__ float s_mean;
  if (jitter) {  // uniform over the block
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int j = 0; j < kReduceBlocks; ++j) total = add(total, partials[n * kReduceBlocks + j]);
      s_mean = dvd(total, (float)hw);
    }
    __syncthreads();
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hw) return;
  Rgb p = load_px(img + (size_t)n * hw * 3, i);
  if (jitter) {
    const float mean = s_mean;
    const int* pm = perm + n * 4;
    const float* fac = factors + n * 4;
    for (int k = 0; k < 4; ++k) p = apply_op(pm[k], p, fac, mean);
  }
  if (gray) {
    const float g = gray_of(p);
    p = Rgb{g, g, g};
  }
  const size_t o = ((size_t)n * hw + i) * 3;
  if (blur) {
    scratch[o] = p.r;
    scratch[o + 1] = p.g;
    scratch[o + 2] = p.b;
  } else {
    out[o] = normalize(p.r, 0);
    out[o + 1] = normalize(p.g, 1);
    out[o + 2] = normalize(p.b, 2);
  }
}

// (c) separable 11-tap blur of the flagged images, vertical then horizontal,
// through shared memory; a row of the tile is (kTileW + 10) pixels x 3 floats.
__global__ void blur_normalize(const float* __restrict__ pre, const int* __restrict__ flags,
                               const float* __restrict__ kern, float* __restrict__ out, int h,
                               int w) {
  const int n = blockIdx.z;
  if (flags[n * 3 + 2] == 0) return;
  __shared__ float tile[kTileH + 2 * kRadius][kTileCols];
  __shared__ float vert[kTileH][kTileCols];
  __shared__ float taps[kTaps];
  const int tid = threadIdx.x;
  if (tid < kTaps) taps[tid] = kern[n * kTaps + tid];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float* src = pre + (size_t)n * h * w * 3;
  for (int idx = tid; idx < (kTileH + 2 * kRadius) * kTileCols; idx += kThreads) {
    const int ty = idx / kTileCols, tx = idx % kTileCols;
    const int gy = min(max(y0 - kRadius + ty, 0), h - 1);
    const int gx = min(max(x0 - kRadius + tx / 3, 0), w - 1);
    tile[ty][tx] = src[((size_t)gy * w + gx) * 3 + tx % 3];
  }
  __syncthreads();
  for (int idx = tid; idx < kTileH * kTileCols; idx += kThreads) {
    const int ty = idx / kTileCols, tx = idx % kTileCols;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) acc = add(acc, mul(taps[t], tile[ty + t][tx]));
    vert[ty][tx] = acc;
  }
  __syncthreads();
  float* dst = out + (size_t)n * h * w * 3;
  for (int idx = tid; idx < kTileH * kTileW * 3; idx += kThreads) {
    const int ty = idx / (kTileW * 3), e = idx % (kTileW * 3);
    const int px = e / 3, c = e % 3;
    const int gy = y0 + ty, gx = x0 + px;
    if (gy < h && gx < w) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = add(acc, mul(taps[t], vert[ty][(px + t) * 3 + c]));
      dst[((size_t)gy * w + gx) * 3 + c] = normalize(acc, c);
    }
  }
}

template <typename T>
cudaError_t launch(const void* img, const int* perm, const float* factors, const int* flags,
                   const float* kern, float* out, float* scratch, float* partials, int n,
                   int h, int w, cudaStream_t stream) {
  const int hw = h * w;
  const T* src = static_cast<const T*>(img);
  gray_mean_partials<T><<<dim3(kReduceBlocks, n), kThreads, 0, stream>>>(
      src, perm, factors, flags, partials, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pointwise_chain<T><<<dim3((hw + kThreads - 1) / kThreads, n), kThreads, 0, stream>>>(
      src, perm, factors, flags, partials, out, scratch, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  blur_normalize<<<tiles, kThreads, 0, stream>>>(scratch, flags, kern, out, h, w);
  return cudaGetLastError();
}

}  // namespace

// img: (n, h, w, 3) contiguous, uint8 (is_u8 != 0) or float32 in [0, 1];
// perm (n, 4) int32, factors (n, 4) float32 (brightness, contrast, saturation,
// hue), flags (n, 3) int32 (jitter, gray, blur), kern (n, 11) float32;
// out and scratch (n, h, w, 3) float32, partials (n, 64) float32; all on
// `device`. Returns a cudaError_t.
extern "C" int stcd_augment_fwd(const void* img, int is_u8, const int* perm,
                                const float* factors, const int* flags, const float* kern,
                                float* out, float* scratch, float* partials, int n, int h,
                                int w, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || (int64_t)h * w > (1 << 24) ||
      (h + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_u8 ? launch<uint8_t>(img, perm, factors, flags, kern, out, scratch, partials, n, h,
                                w, s)
              : launch<float>(img, perm, factors, flags, kern, out, scratch, partials, n, h,
                              w, s);
  return (int)err;
}
