// y = x . w in bf16 with f32 accumulation for Hopper (sm_90a), alone or with
// the two BatchNorm sums of its f32 accumulator: the route of stcd_matmul_bf16,
// stcd_matmul_stats and stcd_matmul_stats_mma for every shape that the Tensor
// Memory Accelerator (TMA) can describe. Replaces three Pallas TPU kernels:
// benchmarks/bench_bnstats_diag.py::_mm_kernel (pallas_mm, no epilogue),
// benchmarks/bench_conv_bn_epilogue.py::_kernel (pallas_fused, the sums on the
// CUDA cores) and benchmarks/bench_bnstats_diag.py::_mxu_stats_kernel
// (pallas_mxu_stats, the sums on the tensor cores). The shapes TMA cannot take
// go to the wmma tile of matmul_stats.cu (the route is chosen from the shapes
// by matmul_plan, ops/matmul_stats.py, mirrored by plan_for below).
//
// What bounds it: bytes. At the ResNet-50 bottleneck shapes of its tools (K, N
// <= 1024, M >= 32768) the 2 M K N operations need at most about 100 per byte
// moved, where the card needs 295 before its tensor cores are the limit. So the
// design moves each byte once and keeps loads in flight:
//
// - Persistent blocks, at most one per SM. A block stages w once, transposed
//   to K-major (w^T, rows of 64 bf16 = 128 bytes in the 128-byte swizzle),
//   and keeps it in shared memory while it walks its M tiles of 128 rows. When
//   all of w does not fit beside the ring, the grid's y dimension splits N
//   into groups whose w does fit, and x is read once for each group: the only
//   re-read. The TPU kernels' sequential (gn, gm) grid, which keeps the sums in
//   VMEM, becomes this walk: a block's sums stay in its registers.
// - A ring of x chunks (128 rows x 64 columns, 16 KB) in shared memory. One
//   producer thread loads them by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//   zero fill past the edges) and each stage completes on an mbarrier.
// - Two consumer warpgroups, 64 rows each, run wgmma.mma_async m64nNk16 (N =
//   64, 128 or 256 columns a pass) with both operands read from shared memory
//   through K-major swizzled descriptors, accumulating in registers. A stage
//   goes back to the producer when wgmma.wait_group says that its products are
//   done. N above 256 is several passes over chunks still in shared memory
//   (the ring then holds at least a whole tile's K), never a re-read of x.
// - The epilogue: the accumulator is rounded to bf16 once in registers, the
//   warpgroup writes the bf16 words of 64 columns into a 64 x 64 box of shared
//   memory in the 128-byte swizzle (no bank conflicts), and one thread stores
//   it by TMA while the next box is filled (two boxes a warpgroup). There is
//   no f32 round trip through shared memory, and y leaves in whole lines.
// - The sums, where asked for (the epilogue kind, a template argument; y is the
//   same bit for bit with every kind): kEpiCudaCores adds each lane's two rows
//   and their squares in f32 and reduces over the warp's eight row groups by a
//   transposing butterfly of shuffles (warp_sums_cuda); kEpiTensorCores forms
//   them by mma.sync on three exact tf32 parts of each value (slice_sums).
//   Either way the four warps of a warpgroup are added in warp order through
//   its y boxes, the tiles in registers in tile order, and the two warpgroups
//   at the end: one f32 partial per block, which stcd_matmul_stats_sum_parts
//   adds in index order.
// - No split over K and no atomics: two runs agree bit for bit.
//
// The TMA descriptor is built in the C entry, on the host, by
// cuTensorMapEncodeTiled, which is reached through cudaGetDriverEntryPoint so
// that the library links against nothing but the CUDA runtime; it is passed
// to the kernel as a __grid_constant__ parameter.

#include <cuda.h>  // CUtensorMap and its enums only: the library links the CUDA runtime alone
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// the wmma routes and the fixed-order sum of the partials, matmul_stats.cu
extern "C" int stcd_matmul_bf16_tiles(const void* x, const void* w, void* y, long long m, int k,
                                      int n, int device, void* stream);
extern "C" int stcd_matmul_stats_tiles(const void* x, const void* w, void* y, float* part_sum,
                                       float* part_sq, float* out_sum, float* out_sq, long long m,
                                       int k, int n, long long m_tiles, int device, void* stream);
extern "C" int stcd_matmul_stats_mma_tiles(const void* x, const void* w, void* y,
                                           float* part_sum, float* part_sq, float* out_sum,
                                           float* out_sq, long long m, int k, int n,
                                           long long m_tiles, int device, void* stream);
extern "C" int stcd_matmul_stats_sum_parts(const float* part_sum, const float* part_sq,
                                           float* out_sum, float* out_sq, long long rows, int n,
                                           void* stream);

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kSms = 132;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may ask for on sm_90
constexpr int kRows = 128;        // rows of an M tile: two consumer warpgroups of 64
constexpr int kDepth = 64;        // columns of x in a chunk: 128 bytes, the swizzle's span
constexpr int kStageBytes = kRows * kDepth * 2;
constexpr int kMaxStages = 8;
// The epilogue kinds: y alone, or y and the column sums formed on the CUDA cores
// or on the tensor cores (ops/matmul_stats.py EPILOGUES, in this order).
constexpr int kEpiNone = 0, kEpiCudaCores = 1, kEpiTensorCores = 2;
constexpr int kThreads = 288;  // warps 0-7: two consumer warpgroups; warp 8: the producer
// With the sums the producer is a warpgroup of its own (warps 8-11, one thread
// issues the loads), so that setmaxnreg can move its registers to the consumers:
// 384 threads launch at 168 registers; the producer drops to 40 and each consumer
// rises to 232, which holds the accumulator, the sums and their temporaries.
constexpr int kStatsThreads = 384;
__host__ __device__ constexpr int block_threads(int epi) {
  return epi != kEpiNone ? kStatsThreads : kThreads;
}
constexpr int kBoxBytes = 64 * 64 * 2;  // a y box: 64 rows x 64 columns (128 bytes)

// y boxes a consumer warpgroup cycles through: one is filled while the TMA
// reads the other; two at most, so that the ring keeps its room.
__host__ __device__ constexpr int y_boxes(int bn) { return bn / 64 < 2 ? bn / 64 : 2; }

// Shared memory besides w^T and the ring: alignment slack, the mbarriers, and
// each consumer warpgroup's y boxes.
constexpr int overhead_bytes(int bn) {
  return 1024 + 2 * kMaxStages * 8 + 2 * y_boxes(bn) * kBoxBytes;
}
constexpr int kRouteWgmma = 0, kRouteWmma = 1;

// The launch geometry; plan_for and ops/matmul_stats.py::matmul_plan compute the same.
struct Plan {
  int route, pass_cols, passes_per_group, groups, stages, blocks_x, smem;
};

// The sums epilogues keep the column sums of at most this many passes a group in
// registers: sum_passes(epi) x BN / 64 floats a consumer thread. The tensor-core
// epilogue stops at 2 (8 floats at BN 256; its transposes and tf32 parts take the
// rest). The CUDA-core one needs 32 temporaries a 64-column slice beside the 128
// of the accumulator at BN 256, so 4 passes (16 floats) keep a thread under the
// 232 registers that setmaxnreg gives it (ops/matmul_stats.py SUM_PASSES).
constexpr int kStatsPasses = 2, kCudaSumPasses = 4;
__host__ __device__ constexpr int sum_passes(int epi) {
  return epi == kEpiTensorCores ? kStatsPasses : epi == kEpiCudaCores ? kCudaSumPasses : 1;
}

// max_npg: the most passes a group may hold (sum_passes with the sums, else no cap).
Plan plan_for(long long m, int k, int n, bool aligned, int max_npg) {
  const long long m_tiles = (m + kRows - 1) / kRows;
  const Plan wmma = {kRouteWmma, 0, 0, 1, 0, (int)(m_tiles < INT_MAX ? m_tiles : INT_MAX), 0};
  // TMA: 16-byte aligned bases, row strides of whole 16 bytes, a box inside the tensor
  if (!aligned || k % 8 != 0 || n % 8 != 0 || k < kDepth || n < 64 || m < kRows ||
      m > INT_MAX) {
    return wmma;
  }
  const int chunks = (k + kDepth - 1) / kDepth;
  for (int bn = n <= 64 ? 64 : n <= 128 ? 128 : 256; bn >= 64; bn /= 2) {
    const int passes = (n + bn - 1) / bn;
    const long long pass_bytes = (long long)bn * chunks * kDepth * 2;  // w^T of one pass
    for (int npg = passes < max_npg ? passes : max_npg; npg >= 1; --npg) {
      // several passes share a tile's chunks, so the ring must hold all of them
      const int min_stages = npg > 1 ? (chunks > 2 ? chunks : 2) : 2;
      const long long room = kMaxSmem - overhead_bytes(bn) - npg * pass_bytes;
      if (room < (long long)min_stages * kStageBytes) continue;
      const int groups = (passes + npg - 1) / npg;
      if (groups > kSms) return wmma;
      const int stages = (int)(room / kStageBytes < kMaxStages ? room / kStageBytes : kMaxStages);
      const long long per_group = kSms / groups;
      return {kRouteWgmma, bn, npg, groups, stages,
              (int)(m_tiles < per_group ? m_tiles : per_group),
              (int)(overhead_bytes(bn) + npg * pass_bytes + (long long)stages * kStageBytes)};
    }
  }
  return wmma;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// An arrival, made only where `pred` holds: predicated inside the asm, so that
// the products around it stay on a path that does not diverge.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// Returns once the phase of the given parity has completed (at once if it has).
// The loop is inside the asm for the same reason.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of the tensor map (column c0, row c1) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma operand in shared memory: K-major, rows of 128 bytes in the 128-byte
// swizzle, 8-row groups 1024 bytes apart (the stride field), the leading-byte
// field unused by this layout (1); bits 62-63 = 1: the 128-byte swizzle. A step
// of 16 along K is 32 bytes added to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler must not move reads or writes of the accumulator across the
// asynchronous products: each register is made an operand of an empty asm.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N f32, spread over the warpgroup) += a (64 x 16) . b (16 x N), both
// read from shared memory through descriptors; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, a, b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_m64n128(d, a, b, scale_d);
  } else {
    wgmma_m64n256(d, a, b, scale_d);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One box of shared memory into the tensor map's box at (column c0, row c1); the
// hardware clips it at the tensor's edges. The calling thread commits the group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// Waits until at most N of the calling thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The tf32 part of an f32: its top 19 bits (sign, exponent and 10 of the 23
// mantissa bits), by one integer instruction where cvt.rna.tf32.f32 takes the
// conversion unit.
__device__ __forceinline__ uint32_t tf32_bits(float x) { return __float_as_uint(x) & 0xffffe000u; }

// d (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col). With g = lane >> 2
// and q = lane & 3: a0 = (g, q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4);
// b0 = (q, g), b1 = (q + 4, g); d0, d1 = (g, 2q), (g, 2q + 1); d2, d3 = (g + 8, ...).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%8}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b));
}

// The column sums of one 64-column slice of a warp's 16 x BN accumulator (lane (g,
// q) holds columns 8 j + 2 q, + 1 of rows g and g + 8) and of its square, formed on
// the tensor cores: t (16 x 8) += A_j . B_j for the slice's blocks j of 8 columns.
// A_j is the block transposed: rows 0-7 its eight columns, rows 8-15 their squares,
// k its rows. Two shuffles a row half move it there: lane (g, q) reads column g of
// rows q + 4 (g & 1) and q + 4 (~g & 1) from lanes (q + 4 (g & 1), g / 2) and (q + 4
// (~g & 1), g / 2), each of which sends element g >> 2, resp. its complement, of its
// pair: every lane sends one value a shuffle and every value is read once. B_j
// selects output column j (ones in column j, zeros elsewhere), so the eight blocks
// of the slice land in the eight columns of t: lane (g, q) ends with the sums of
// slice columns 16 q + g and 16 q + 8 + g (t[.][0], t[.][1]) over the warp's 16
// rows, and of their squares (t[.][2], t[.][3]). Each value goes in as three tf32 parts, hi = tf32(v), mid =
// tf32(v - hi), lo = v - hi - mid (tf32: truncated to 11 significant bits), whose
// sum is v exactly (v - hi has at most 13 significant bits, lo at most 2): the
// products are exact and only the additions round. Each part has its own fragment
// t[part], so that three chains of products are in flight, not one.
template <int BN>
__device__ __forceinline__ void slice_sums(float (&t)[3][4], const float (&acc)[BN / 2], int sl,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int src0 = 4 * (q + 4 * (g & 1)) + (g >> 1);
  const int src1 = 4 * (q + 4 * ((g & 1) ^ 1)) + (g >> 1);
  const bool odd = (g >> 2) != 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = sl * 8 + jj;
    const uint32_t b = g == jj ? 0x3f800000u : 0u;  // 1.0 or 0.0, exact in tf32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
      const float v0 = __shfl_sync(0xffffffffu, odd ? x1 : x0, src0);
      const float v1 = __shfl_sync(0xffffffffu, odd ? x0 : x1, src1);
      float r[4] = {v0, v0 * v0, v1, v1 * v1};
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        uint32_t a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = part < 2 ? tf32_bits(r[e]) : __float_as_uint(r[e]);  // lo is a tf32 value
          if (part < 2) r[e] -= __uint_as_float(a[e]);
        }
        mma_tf32(t[part], a, b);
      }
    }
  }
}

// One step of warp_sums_cuda's butterfly: v[i] and v[i + H] (blocks jj and jj + H /
// 4) go to the lanes whose bit H is clear and set; H is a template argument so that
// every index is static and v stays in registers.
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The column sums of one 64-column slice of a warp's 16 x BN accumulator and of its
// square, formed on the CUDA cores. Lane (g, q) holds columns 8 j + 2 q, + 1 of rows g
// and g + 8; it adds its two rows (and their squares, by fmaf) in f32 into v[4 jj + e],
// jj the slice's block of 8 columns, e = 0, 1: the sums of columns 2 q, 2 q + 1, e = 2,
// 3: of their squares. A transposing butterfly then adds the eight lanes that share q:
// at each step (lane masks 16, 8, 4: bits 2, 1, 0 of g) a lane keeps the half of its
// values whose block has that bit equal to its own, sends the other half to its
// partner and adds what it receives, so the steps take 16 + 8 + 4 shuffles and leave
// lane (g, q) with v[0..3]: the whole sums over the warp's 16 rows of slice columns
// 8 g + 2 q, + 1 and of their squares, in a fixed order (no copies of other lanes'
// sums, so four registers hold the result).
template <int BN>
__device__ __forceinline__ void warp_sums_cuda(float (&v)[32], const float (&acc)[BN / 2], int sl,
                                               int lane) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = sl * 8 + jj;
    const float a0 = acc[4 * j], a1 = acc[4 * j + 1], a2 = acc[4 * j + 2], a3 = acc[4 * j + 3];
    v[4 * jj] = a0 + a2;
    v[4 * jj + 1] = a1 + a3;
    v[4 * jj + 2] = fmaf(a0, a0, a2 * a2);
    v[4 * jj + 3] = fmaf(a1, a1, a3 * a3);
  }
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
}

// The barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// BN: output columns of a pass (64, 128 or 256). Grid: (blocks_x, groups); the
// block of group g owns passes [g * passes_per_group, ...) of N and walks M
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... EPI other than kEpiNone: the
// epilogue also sums the f32 accumulator and its square over the rows: each warp
// over its 16 rows (warp_sums_cuda on the CUDA cores, slice_sums on the tensor
// cores), the four warps of a warpgroup in warp order through its y boxes, the
// tiles into registers in tile order (at most sum_passes(EPI) passes a group),
// and at the end the two warpgroups; the block leaves its sums as row blockIdx.x
// of part_sum and part_sq (blocks_x, n). y is the same with every EPI, bit for bit.
template <int BN, int EPI>
__global__ void __launch_bounds__(block_threads(EPI), 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap y_map, const bf16* __restrict__ w,
                    long long m, int k, int n, int passes_per_group, int stages,
                    float* __restrict__ part_sum, float* __restrict__ part_sq) {
  constexpr int kTile = BN * kDepth * 2;  // bytes of w^T for one pass and one chunk
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int chunks = (k + kDepth - 1) / kDepth;
  const int pass0 = blockIdx.y * passes_per_group;
  const int npass = min(passes_per_group, (n + BN - 1) / BN - pass0);
  unsigned char* ws = smem;
  unsigned char* xs = ws + (size_t)passes_per_group * chunks * kTile;
  constexpr int kYBoxes = y_boxes(BN);
  unsigned char* ys = xs + (size_t)stages * kStageBytes;  // [warpgroup][kYBoxes] y boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + 2 * kYBoxes * kBoxBytes);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  // taken from lane 0, so that the compiler knows it is the same across the warp
  // and that the products below do not sit on a divergent path
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const long long m_tiles = (m + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival; the bytes complete it
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: one thread keeps the ring full from the start
    if constexpr (EPI != kEpiNone) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < m_tiles; t += gridDim.x) {
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[slot], phase ^ 1u);  // passes at once on the first round
          mbar_expect_tx(&full[slot], kStageBytes);
          tma_load_2d(xs + (size_t)slot * kStageBytes, &x_map, c * kDepth, (int)(t * kRows),
                      &full[slot]);
          if (++slot == stages) {
            slot = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  if constexpr (EPI != kEpiNone) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  }

  // Meanwhile the consumers stage w^T of the block's passes, K-major: row nn of
  // the tile (pass, chunk) holds w[chunk * 64 .. + 64][(pass0 + pass) * BN + nn],
  // zero past K and N, its octet o (8 values of K) at 16 (o ^ (nn % 8)). A thread
  // takes an 8 x 8 block: eight 16-byte rows of w (K and N are multiples of 8),
  // transposed in registers, written as eight 16-byte octets. Neighbouring threads
  // take neighbouring octets, whose rows differ in their swizzle: no bank conflicts.
#pragma unroll 2
  for (int i = tid; i < npass * chunks * 8 * (BN / 8); i += 256) {
    const int o = i % 8;
    const int nb = (i / 8) % (BN / 8);
    const int chunk = (i / (8 * (BN / 8))) % chunks;
    const int p = i / (8 * (BN / 8) * chunks);
    const int col = (pass0 + p) * BN + 8 * nb;
    const int k0 = chunk * kDepth + 8 * o;
    uint4 rows[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rows[r] = (col < n && k0 < k)
                    ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * n + col))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    unsigned char* tile = ws + (size_t)(p * chunks + chunk) * kTile;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      // the nn-th bf16 of each row: half (nn % 2) of word nn / 2
      const uint32_t sel = nn % 2 ? 0x7632u : 0x5410u;
      uint32_t word[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(&rows[2 * e]);
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(&rows[2 * e + 1]);
        word[e] = __byte_perm(lo[nn / 2], hi[nn / 2], sel);
      }
      const int row = 8 * nb + nn;
      *reinterpret_cast<uint4*>(tile + row * 128 + ((o ^ nn) << 4)) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
  // the products read w^T through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 3, 256;\n" ::: "memory");  // the two consumer warpgroups

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp >> 2;
  // the thread that releases a stage and stores y for its warpgroup
  const bool signals = (tid & 127) == 0;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* boxes = ys + (size_t)wg * kYBoxes * kBoxBytes;
  int box = 0;  // boxes this warpgroup has stored
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // With the sums: thread i of a warpgroup keeps, for each pass and 64-column slice,
  // the warpgroup's running sum of value i of the slice (i < 64: column i; i >= 64:
  // the square of column i - 64) over the tiles it walks.
  constexpr int kSumPasses = sum_passes(EPI);
  float sums[kSumPasses][BN / 64];
#pragma unroll
  for (int pp = 0; pp < kSumPasses; ++pp) {
#pragma unroll
    for (int sl = 0; sl < BN / 64; ++sl) sums[pp][sl] = 0.f;
  }
  int slot = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < m_tiles; t += gridDim.x) {
    const int slot0 = slot;
    const uint32_t phase0 = phase;
    for (int p = 0; p < npass; ++p) {
      int s = slot0, prev = slot0;
      uint32_t ph = phase0;
      wgmma_fence();
      fence_acc(acc);
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&full[s], ph);  // in passes after the first the phase is long complete
        const uint32_t a = smem_u32(xs + (size_t)s * kStageBytes + wg * 64 * 128);
        const uint32_t b = smem_u32(ws + (size_t)(p * chunks + c) * kTile);
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          wgmma_tile<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk), (c | kk) != 0);
        }
        wgmma_commit();
        if (npass == 1 && c > 0) {  // the previous chunk's products are done: free its stage
          wgmma_wait<1>();
          mbar_arrive_if(&empty[prev], signals);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (p == npass - 1) {  // the last pass over this tile: free its stages
        if (npass == 1) {
          mbar_arrive_if(&empty[prev], signals);
        } else {
          int r = slot0;
          for (int c = 0; c < chunks; ++c) {
            mbar_arrive_if(&empty[r], signals);
            if (++r == stages) r = 0;
          }
        }
        slot = s;
        phase = ph;
      }

      // epilogue: lane (g, q) of warp wq holds, for each 8-column block j, columns
      // 8 j + 2 q, + 1 of rows 16 wq + g and 16 wq + g + 8 of the warpgroup's 64. The
      // rounded words of 64 columns go into a 64 x 64 box in the 128-byte swizzle
      // (block j of row r at 16 (j ^ (r % 8)): conflict-free), which one thread
      // stores by TMA while the next box is filled.
      const int r0 = (warp & 3) * 16 + g;
#pragma unroll
      for (int sl = 0; sl < BN / 64; ++sl, ++box) {
        unsigned char* buf = boxes + (box % kYBoxes) * kBoxBytes;
        if (signals) bulk_wait_read<kYBoxes - 1>();  // the box's last store has read it
        warpgroup_sync(wg);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = sl * 8 + jj;
          const int chunk = (jj ^ g) << 4;
          *reinterpret_cast<uint32_t*>(buf + r0 * 128 + chunk + 4 * q) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(buf + (r0 + 8) * 128 + chunk + 4 * q) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the TMA
        warpgroup_sync(wg);
        if (signals) {
          tma_store_2d(&y_map, buf, (pass0 + p) * BN + sl * 64, (int)(t * kRows) + wg * 64);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
      if constexpr (EPI != kEpiNone) {
        // The warps' sums of their 16 rows go through the warpgroup's y boxes, which the
        // TMA has done reading (the next tile's epilogue waits at its barrier for the
        // reads below): [slice][warp of the warpgroup][128 values: the 64 columns' sums,
        // then their squares'], 2 KB a slice.
        float* sc = reinterpret_cast<float*>(boxes);
        if (signals) bulk_wait_read<0>();
        warpgroup_sync(wg);
#pragma unroll
        for (int sl = 0; sl < BN / 64; ++sl) {
          float* dst = sc + (sl * 4 + (warp & 3)) * 128;
          if constexpr (EPI == kEpiCudaCores) {
            float v[32];
            warp_sums_cuda<BN>(v, acc, sl, lane);
            // columns 8 g + 2 q, + 1: 8-byte stores, 256 consecutive bytes a warp
            *reinterpret_cast<float2*>(dst + 8 * g + 2 * q) = make_float2(v[0], v[1]);
            *reinterpret_cast<float2*>(dst + 64 + 8 * g + 2 * q) = make_float2(v[2], v[3]);
          } else {
            float t[3][4] = {};
            slice_sums<BN>(t, acc, sl, lane);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dst[(e >> 1) * 64 + 16 * q + 8 * (e & 1) + g] = (t[0][e] + t[1][e]) + t[2][e];
            }
          }
        }
        warpgroup_sync(wg);
        const int i = tid & 127;
#pragma unroll
        for (int sl = 0; sl < BN / 64; ++sl) {
          const float* v = sc + sl * 4 * 128 + i;
          const float tile_sum = ((v[0] + v[128]) + v[256]) + v[384];  // in warp order
#pragma unroll
          for (int pp = 0; pp < kSumPasses; ++pp) {  // the pass by static indices: registers
            if (pp == p) sums[pp][sl] += tile_sum;
          }
        }
      }
    }
  }
  if (signals) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if constexpr (EPI != kEpiNone) {
    // The block's sums: the two warpgroups' go to shared memory over the ring (no
    // load is left in flight once both are past their last tile), [warpgroup][sum,
    // square][cols], at most 16 KB, and each column is added over the two in order.
    const int cols = npass * BN;
    float* red = reinterpret_cast<float*>(xs);
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    const int i = tid & 127;
#pragma unroll
    for (int pp = 0; pp < kSumPasses; ++pp) {
      if (pp < npass) {
#pragma unroll
        for (int sl = 0; sl < BN / 64; ++sl) {
          red[(2 * wg + (i >> 6)) * cols + pp * BN + sl * 64 + (i & 63)] = sums[pp][sl];
        }
      }
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    for (int col = tid; col < cols; col += 256) {
      const int gc = pass0 * BN + col;
      if (gc >= n) continue;
      part_sum[(size_t)blockIdx.x * n + gc] = red[col] + red[2 * cols + col];
      part_sq[(size_t)blockIdx.x * n + gc] = red[cols + col] + red[3 * cols + col];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

template <int BN, int EPI>
cudaError_t launch_wgmma(const Plan& plan, const void* x, const void* w, void* y, long long m,
                         int k, int n, float* part_sum, float* part_sq, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x in boxes of 128 rows x 64 columns, y in boxes of 64 x 64; both in the 128-byte
  // swizzle. Loads past the edges read zeros, stores past them are dropped.
  CUtensorMap x_map, y_map;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};  // innermost first
  const cuuint64_t x_strides[1] = {(cuuint64_t)k * 2};           // bytes, of the outer dim
  const cuuint32_t x_box[2] = {(cuuint32_t)kDepth, (cuuint32_t)kRows};
  const cuuint64_t y_dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t y_strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t y_box[2] = {64, 64};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims,
             x_strides, x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, y_dims, y_strides, y_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  auto kernel = matmul_wgmma_kernel<BN, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(plan.blocks_x, plan.groups), block_threads(EPI), plan.smem, stream>>>(
      x_map, y_map, static_cast<const bf16*>(w), m, k, n,
      plan.passes_per_group, plan.stages, part_sum, part_sq);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Checks a plan from the wrapper against plan_for's for these shapes and pointers.
bool same_plan(const Plan& plan, int route, int pass_cols, int passes_per_group, int stages,
               int blocks_x, int smem_bytes) {
  return route == plan.route && pass_cols == plan.pass_cols &&
         passes_per_group == plan.passes_per_group && stages == plan.stages &&
         blocks_x == plan.blocks_x && smem_bytes == plan.smem;
}

template <int EPI>
cudaError_t run_wgmma(const Plan& plan, const void* x, const void* w, void* y, long long m, int k,
                      int n, float* part_sum, float* part_sq, int device, cudaStream_t s) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (plan.pass_cols) {
    case 64: return launch_wgmma<64, EPI>(plan, x, w, y, m, k, n, part_sum, part_sq, s);
    case 128: return launch_wgmma<128, EPI>(plan, x, w, y, m, k, n, part_sum, part_sq, s);
    default: return launch_wgmma<256, EPI>(plan, x, w, y, m, k, n, part_sum, part_sq, s);
  }
}

// The product with the column sums of its f32 accumulator and of its square,
// out_sum, out_sq f32[n], with the epilogue EPI on the wgmma route. The plan is
// matmul_plan's for that epilogue (at most sum_passes(EPI) passes a group).
// part_sum, part_sq: f32 scratch of (part_rows, n), part_rows = blocks_x on the
// wgmma route (one partial per persistent block), ceil(m / 128) on the wmma
// route (one per M tile, where `tiles` runs); a second launch adds them in
// index order.
template <int EPI, typename Tiles>
int run_stats(Tiles tiles, const void* x, const void* w, void* y, float* part_sum,
              float* part_sq, float* out_sum, float* out_sq, long long m, int k, int n,
              int route, int pass_cols, int passes_per_group, int stages, int blocks_x,
              int smem_bytes, long long part_rows, int device, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Plan plan =
      plan_for(m, k, n, aligned16(x) && aligned16(w) && aligned16(y), sum_passes(EPI));
  if (!same_plan(plan, route, pass_cols, passes_per_group, stages, blocks_x, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (plan.route == kRouteWmma) {
    return tiles(x, w, y, part_sum, part_sq, out_sum, out_sq, m, k, n, part_rows, device,
                 stream);
  }
  if (part_rows != plan.blocks_x) return (int)cudaErrorInvalidValue;
  cudaError_t err = run_wgmma<EPI>(plan, x, w, y, m, k, n, part_sum, part_sq, device,
                                   static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return stcd_matmul_stats_sum_parts(part_sum, part_sq, out_sum, out_sq, part_rows, n, stream);
}

}  // namespace

// y = x . w: x (m, k), w (k, n), y (m, n), contiguous bf16 on `device`. route,
// pass_cols, passes_per_group, stages, blocks_x and smem_bytes are the plan of
// ops/matmul_stats.py::matmul_plan for these shapes and pointers (route 0:
// wgmma with TMA, 1: the wmma tile of matmul_stats.cu); a call whose numbers
// are not plan_for's is refused. Returns a cudaError_t.
extern "C" int stcd_matmul_bf16(const void* x, const void* w, void* y, long long m, int k,
                                int n, int route, int pass_cols, int passes_per_group,
                                int stages, int blocks_x, int smem_bytes, int device,
                                void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(m, k, n, aligned16(x) && aligned16(w) && aligned16(y), INT_MAX);
  if (!same_plan(plan, route, pass_cols, passes_per_group, stages, blocks_x, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (plan.route == kRouteWmma) return stcd_matmul_bf16_tiles(x, w, y, m, k, n, device, stream);
  return (int)run_wgmma<kEpiNone>(plan, x, w, y, m, k, n, nullptr, nullptr, device,
                                  static_cast<cudaStream_t>(stream));
}

// The product with its sums formed on the CUDA cores (run_stats above); where TMA
// cannot describe the operands, the 2-D wmma tile of matmul_stats.cu. Returns a
// cudaError_t.
extern "C" int stcd_matmul_stats(const void* x, const void* w, void* y, float* part_sum,
                                 float* part_sq, float* out_sum, float* out_sq, long long m,
                                 int k, int n, int route, int pass_cols, int passes_per_group,
                                 int stages, int blocks_x, int smem_bytes, long long part_rows,
                                 int device, void* stream) {
  return run_stats<kEpiCudaCores>(stcd_matmul_stats_tiles, x, w, y, part_sum, part_sq, out_sum,
                                  out_sq, m, k, n, route, pass_cols, passes_per_group, stages,
                                  blocks_x, smem_bytes, part_rows, device, stream);
}

// The product with its sums formed on the tensor cores (run_stats above); where TMA
// cannot describe the operands, the wmma tile of matmul_stats.cu with its
// tensor-core sums. Returns a cudaError_t.
extern "C" int stcd_matmul_stats_mma(const void* x, const void* w, void* y, float* part_sum,
                                     float* part_sq, float* out_sum, float* out_sq, long long m,
                                     int k, int n, int route, int pass_cols,
                                     int passes_per_group, int stages, int blocks_x,
                                     int smem_bytes, long long part_rows, int device,
                                     void* stream) {
  return run_stats<kEpiTensorCores>(stcd_matmul_stats_mma_tiles, x, w, y, part_sum, part_sq,
                                    out_sum, out_sq, m, k, n, route, pass_cols,
                                    passes_per_group, stages, blocks_x, smem_bytes, part_rows,
                                    device, stream);
}
