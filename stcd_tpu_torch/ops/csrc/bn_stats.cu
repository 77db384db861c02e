// Per-channel sum and sum of squares for Hopper (sm_90a): the two batch
// statistics of a channels-last (rows, C) view, accumulated in f32, in one
// launch.
//
// Replaces the Pallas TPU kernel stcd_tpu/ops/bn_stats.py::_stats_kernel
// (launched by bn_stats_pallas). The TPU kernel walks row tiles in order and
// keeps the (1, C) sums resident in VMEM; its lane folding of narrow C and its
// supports_pallas shape rule are TPU layout matters and are not carried over.
// Here any rows and any C are taken.
//
// What bounds it: bytes. x is read once with 2 operations an element against 2
// or 4 bytes, so the least time is the size of x over the memory rate. The
// design streams x with enough bytes in flight and finishes in the same launch:
//
// - Persistent blocks (ops/bn_stats.py::bn_stats_plan, which the C entry
//   recomputes and checks): kBlocksPerSm blocks an SM, all resident at once.
//   A block owns a contiguous run of whole rows, a whole number of passes.
// - A thread owns a group of V neighbouring channels (V = 16 bytes of the
//   input: 4 floats or 8 bf16, or 1 where C or the pointer does not allow a
//   16-byte load) and walks down its rows. A block of 256 threads covers
//   W = min(C / V, 256) groups and R = 256 / W rows a pass (its row slots), so
//   a pass reads one contiguous run of memory. Wider C takes gridDim.y column
//   tiles. The thread keeps its V sums and V sums of squares in registers.
// - Loads: 16-byte ld.global.nc, kDepth independent loads a thread issued
//   before any is summed: 64 KB in flight an SM. (1-D bulk copies into a ring
//   of shared memory, cp.async.bulk on an mbarrier, were measured beside it on
//   an H100 and were no faster at any of the six SegCD-r50 shapes.)
// - The finish, with no float atomics: each block adds its row slots in index
//   order through shared memory and writes one partial row of the scratch
//   (blocks, C). Blocks form finishing groups of `group_blocks` neighbours.
//   The last block of a group to arrive (an integer ticket: __threadfence,
//   atomicAdd) adds its group's partial rows in index order; with more than
//   one group it writes a group row and takes the top ticket, and the last
//   group to arrive adds the group rows in index order into sum and sumsq.
//   Each finisher resets its ticket to 0. Two levels keep a finisher's reads
//   small: one last block reading all 264 rows at C = 1024 would read 2.2 MB
//   on one SM. The order of every addition is fixed by the plan, so two runs
//   agree bit for bit.
// - The tickets live in a static device array, zero at load, in slots: the
//   wrapper gives each (device, stream) a slot of its own for its eager calls
//   and each call captured into a CUDA graph another, so two streams never
//   share a ticket, and each call leaves its tickets at 0 for the next call
//   and for every replay of a CUDA graph that captured it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;          // ops/bn_stats.py: SMS
constexpr int kBlocksPerSm = 2;    // BLOCKS_PER_SM
constexpr int kDepth = 8;          // DEPTH: loads a thread has in flight
constexpr int kAddBatch = 9;       // rows a finisher has in flight: 17 in two rounds
constexpr int kTicketSlots = 4096;  // TICKET_SLOTS
constexpr int kTicketsPerSlot = 32;  // TICKETS_PER_SLOT: >= groups + 1
constexpr int kMaxDevices = 64;

__device__ int g_tickets[kTicketSlots * kTicketsPerSlot];

struct Plan {
  int vec, col_tiles, row_slots, blocks, group_blocks, groups;
  long long rows_per_block, part_rows;
};

// ops/bn_stats.py::bn_stats_plan, for the same arguments.
bool plan_for(long long rows, int c, int itemsize, bool aligned, Plan* p) {
  if (rows < 1 || c < 1 || (itemsize != 2 && itemsize != 4)) return false;
  const int full = 16 / itemsize;
  p->vec = (c % full == 0 && aligned) ? full : 1;
  const int groups = c / p->vec;
  p->col_tiles = (groups + kThreads - 1) / kThreads;
  if (p->col_tiles > 65535) return false;
  const int width = groups < kThreads ? groups : kThreads;
  p->row_slots = kThreads / width;
  long long target = kSms * kBlocksPerSm / p->col_tiles;
  if (target < 1) target = 1;
  const long long per = (rows + target - 1) / target;
  p->rows_per_block = (per + p->row_slots - 1) / p->row_slots * p->row_slots;
  p->blocks = (int)((rows + p->rows_per_block - 1) / p->rows_per_block);
  int g = 1;
  while (g * g < p->blocks) ++g;
  p->group_blocks = g;
  p->groups = (p->blocks + g - 1) / g;
  p->part_rows = p->blocks + (p->groups > 1 ? p->groups : 0);
  return true;
}

// V channels of one row: a raw load (which may be in flight) and its values.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  float raw;
  __device__ __forceinline__ void load(const float* p) { raw = __ldg(p); }
  __device__ __forceinline__ void get(float* out) const { out[0] = raw; }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  unsigned short raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = __uint_as_float((uint32_t)raw << 16);  // a bf16 is the high half of an f32
  }
};
template <typename T>
struct Vec16 {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                 : "l"(p));
  }
};
template <>
struct Vec<float, 4> : Vec16<float> {
  __device__ __forceinline__ void get(float* out) const {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> : Vec16<__nv_bfloat16> {
  __device__ __forceinline__ void get(float* out) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <int V>
__device__ __forceinline__ void accumulate(const float* val, float* sum, float* sq) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sum[e] += val[e];
    sq[e] = fmaf(val[e], val[e], sq[e]);
  }
}

struct Args {
  const void* x;
  float* part;  // (2, part_rows, c): sums, then squares; block rows, then group rows
  float* out;   // (2, c): sum, sumsq
  int* tickets;
  long long rows, rows_per_block, part_rows;
  int c, blocks, group_blocks, groups;
};

__device__ __forceinline__ void add_load(float (&acc)[1], float v) { acc[0] += v; }
__device__ __forceinline__ void add_load(float (&acc)[4], const float4& v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

// Adds rows first .. last - 1 of the scratch's sums and of its squares, channel
// by channel in index order, into dst (sums) and dst + dst_stride (squares). A
// thread takes W neighbouring channels of one of the two at once (16-byte
// loads where W = 4) and keeps kAddBatch rows' loads in flight.
template <int W>
__device__ void add_rows_w(const Args& a, long long first, long long last, float* dst,
                           long long dst_stride) {
  typedef typename std::conditional<W == 4, float4, float>::type Load;
  const int lanes = (a.c + W - 1) / W;  // W-channel pieces of one row
  for (int item = threadIdx.x; item < 2 * lanes; item += kThreads) {
    const int which = item >= lanes;  // 0: the sums, 1: the squares
    const int ch = (item - which * lanes) * W;
    const float* col = a.part + which * a.part_rows * a.c + ch;
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.f;
    for (long long i = first; i < last; i += kAddBatch) {
      Load v[kAddBatch];
#pragma unroll
      for (int j = 0; j < kAddBatch; ++j) {
        if (i + j < last) v[j] = __ldcg(reinterpret_cast<const Load*>(col + (i + j) * a.c));
      }
#pragma unroll
      for (int j = 0; j < kAddBatch; ++j) {
        if (i + j < last) add_load(acc, v[j]);
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) dst[which * dst_stride + ch + e] = acc[e];
  }
}

__device__ void add_rows(const Args& a, long long first, long long last, float* dst,
                         long long dst_stride) {
  if (a.c % 4 == 0) {
    add_rows_w<4>(a, first, last, dst, dst_stride);
  } else {
    add_rows_w<1>(a, first, last, dst, dst_stride);
  }
}

// The block's partial row, then the two levels of tickets.
template <int V>
__device__ void finish(const Args& a, const float* sum, const float* sq) {
  __shared__ float sh[2][kThreads * V];  // sums, squares: slot s, group g, channel e
  __shared__ int last;
  const int t = threadIdx.x;
  const int g0 = blockIdx.y * kThreads;
  const int w = min(a.c / V - g0, kThreads);
  const int r_slots = kThreads / w;
  const int width = w * V;  // channels of this column tile
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sh[0][t * V + e] = sum[e];
    sh[1][t * V + e] = sq[e];
  }
  __syncthreads();
  // every thread adds the row slots of its channels in index order, eight loads in flight
  for (int o = t; o < 2 * width; o += kThreads) {
    const int which = o >= width;
    const int idx = o - which * width;
    const float* col = sh[which] + idx;
    float acc = 0.f;
    for (int slot = 0; slot < r_slots; slot += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = slot + j < r_slots ? col[(slot + j) * width] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (slot + j < r_slots) acc += v[j];
      }
    }
    a.part[which * a.part_rows * a.c + (long long)blockIdx.x * a.c + g0 * V + idx] = acc;
  }
  __threadfence();  // the partial row is seen by the finisher before the ticket
  __syncthreads();
  const int group = blockIdx.x / a.group_blocks;
  const long long first = (long long)group * a.group_blocks;
  const long long end = min((long long)a.blocks, first + a.group_blocks);
  if (t == 0) {
    const int arrivals = (int)(end - first) * gridDim.y;
    last = atomicAdd(&a.tickets[group], 1) == arrivals - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.groups == 1) {  // one group: its finisher writes the sums
    add_rows(a, first, end, a.out, a.c);
    if (t == 0) a.tickets[group] = 0;
    return;
  }
  add_rows(a, first, end, a.part + (long long)(a.blocks + group) * a.c, a.part_rows * a.c);
  if (t == 0) a.tickets[group] = 0;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&a.tickets[a.groups], 1) == a.groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  add_rows(a, a.blocks, a.blocks + a.groups, a.out, a.c);
  if (t == 0) a.tickets[a.groups] = 0;
}

// Row slot `slot`, channel group `group` of this column tile; -1 for a thread
// beyond the groups.
__device__ __forceinline__ void thread_place(int c, int V, int* group, int* slot, int* r_slots) {
  const int g0 = blockIdx.y * kThreads;
  const int w = min(c / V - g0, kThreads);
  *r_slots = kThreads / w;
  *slot = threadIdx.x / w;
  *group = g0 + threadIdx.x - *slot * w;
  if (*slot >= *r_slots) *slot = -1;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) bn_stats_kernel(Args a) {
  int group, slot, r_slots;
  thread_place(a.c, V, &group, &slot, &r_slots);
  float sum[V], sq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sum[e] = 0.f;
    sq[e] = 0.f;
  }
  if (slot >= 0) {
    const T* col = static_cast<const T*>(a.x) + (size_t)group * V;
    const long long r0 = (long long)blockIdx.x * a.rows_per_block;
    const long long r1 = min(a.rows, r0 + a.rows_per_block);
    long long r = r0 + slot;
    for (; r + (kDepth - 1) * (long long)r_slots < r1; r += (long long)r_slots * kDepth) {
      Vec<T, V> v[kDepth];  // kDepth loads in flight before any is summed
#pragma unroll
      for (int i = 0; i < kDepth; ++i) v[i].load(col + (size_t)(r + i * r_slots) * a.c);
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        float val[V];
        v[i].get(val);
        accumulate<V>(val, sum, sq);
      }
    }
    for (; r < r1; r += r_slots) {
      Vec<T, V> v;
      v.load(col + (size_t)r * a.c);
      float val[V];
      v.get(val);
      accumulate<V>(val, sum, sq);
    }
  }
  finish<V>(a, sum, sq);
}

template <typename T, int V>
cudaError_t launch(const Plan& plan, const Args& a, cudaStream_t stream) {
  bn_stats_kernel<T, V><<<dim3(plan.blocks, plan.col_tiles), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, c) contiguous on `device`; dtype: 0 = float32, 1 = bfloat16.
// vec, blocks, rows_per_block, group_blocks and part_rows are
// ops/bn_stats.py::bn_stats_plan's for these arguments and x's alignment; a
// call whose numbers are not this file's is refused. part: float32 scratch of
// (2, part_rows, c); out: float32 (2, c), sum then sumsq. slot: the caller's
// ticket slot in [0, 4096), one for each device and stream and one for each
// captured call. One launch.
// Returns a cudaError_t.
extern "C" int stcd_bn_stats_fwd(const void* x, float* part, float* out, long long rows, int c,
                                 int dtype, int vec, int blocks, long long rows_per_block,
                                 int group_blocks, long long part_rows, int slot, int device,
                                 void* stream) {
  Plan plan;
  if (dtype < 0 || dtype > 1 || slot < 0 || slot >= kTicketSlots ||
      !plan_for(rows, c, dtype == 0 ? 4 : 2, reinterpret_cast<uintptr_t>(x) % 16 == 0, &plan) ||
      vec != plan.vec || blocks != plan.blocks || rows_per_block != plan.rows_per_block ||
      group_blocks != plan.group_blocks || part_rows != plan.part_rows ||
      plan.groups + 1 > kTicketsPerSlot) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the tickets' address on this device, looked up once (not while a stream captures)
  static int* tickets_of[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int* tickets = tickets_of[device];
  if (tickets == nullptr) {
    err = cudaGetSymbolAddress(reinterpret_cast<void**>(&tickets), g_tickets);
    if (err != cudaSuccess) return (int)err;
    tickets_of[device] = tickets;
  }
  Args a;
  a.x = x;
  a.part = part;
  a.out = out;
  a.tickets = tickets + slot * kTicketsPerSlot;
  a.rows = rows;
  a.rows_per_block = plan.rows_per_block;
  a.part_rows = plan.part_rows;
  a.c = c;
  a.blocks = plan.blocks;
  a.group_blocks = plan.group_blocks;
  a.groups = plan.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = vec == 1 ? launch<float, 1>(plan, a, s) : launch<float, 4>(plan, a, s);
  } else {
    err = vec == 1 ? launch<__nv_bfloat16, 1>(plan, a, s) : launch<__nv_bfloat16, 8>(plan, a, s);
  }
  return (int)err;
}
