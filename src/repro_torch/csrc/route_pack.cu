// route_pack: the routing plane's lane step on the card (sm_90a).
//
// Built by repro_torch/kernels/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the caller's stream, allocates nothing and
// returns the cudaGetLastError() of its launch.
//
// ---------------------------------------------------------------------
// Replaces repro/kernels/route_pack/ops.py:route_pack (backend "pallas"),
// which places destination-sorted wire rows at their send slots with the
// one-hot MXU segment sum of repro/kernels/segment_reduce/kernel.py and a
// zero fill, together with what repro/dist/router.py:MeshRouter.route_lanes
// does around it: pack the lane's fields into [C, W] wire rows, prepend
// the defer ring, gather the sorted rows, refill the ring with the rows
// that overflowed their bucket. The TPU has no scatter, so placement there
// is a matmul; here it is one gather-form copy. One kernel, two entries:
//
//   d3_route_pack : the placement alone over packed rows [N, W];
//   d3_route_lane : the fused lane step. Source row i is ring row i for
//                   i < K, else lane row i - K read from the lane's fields
//                   in place (f32, int64 or bool, each [C] or [C, d] with
//                   its own row stride) and value-cast to f32 as the wire
//                   packs it. It writes the send buffer and the new ring
//                   in one launch; no packed lane and no [K + C, W] buffer
//                   exist.
//
// Output rows and their sources, with order and starts from route_plan
// (kernels/route_pack/ops.py: the stable sort by destination, the first
// sorted position of every destination) and n_d = starts[d+1] - starts[d]:
//   send row s = d * cap + r : order[starts[d] + r] if r < n_d, else zero;
//   ring row j               : order[starts[d] + cap + j - ovf[d]] for the
//                              bucket d with ovf[d] <= j < ovf[d + 1],
//                              ovf the running sum of max(n_d - cap, 0)
//                              (the FIFO overflow, bucket by bucket); zero
//                              from ovf[n_dev] on.
//
// Bound: memory. Reads the shipped and deferred rows' source bytes once,
// their order entries and starts; writes every output word once. What the
// design does about it:
//   - Each output buffer is a flat span of 32-bit words cut into chunks of
//     kChunk = 512 words (2 KB, 16-byte aligned). A warp takes one chunk
//     at a time; the grid is sized to the warps the card holds at once and
//     strides over the chunks of both outputs.
//   - A chunk's rows come from a window of 32 consecutive output rows, one
//     source index a lane, read by shuffle. The order entries of
//     consecutive slots of a bucket are consecutive, so the window is one
//     coalesced load; starts and the running overflow sit in shared
//     memory, so no other global read precedes the rows, and the next
//     chunk's window loads while this chunk's rows do. At W >= 32 a
//     chunk's rows all fit one window and the loop holds no division.
//   - A chunk with no sourced row (a bucket's empty tail, the ring past
//     its fill) loads nothing and is written as 16-byte zero stores.
//   - Otherwise every lane issues its 16 word loads (word q0 + 32 j + lane:
//     coalesced) before any store, stages them in shared memory, and the
//     warp writes the chunk as 16-byte stores. Rows of W = 607 and 69
//     words are not 16-byte aligned; the flat span is.
//   - Values move as 32-bit words (f32 fields, ring and packed rows) or by
//     exact value casts (int64 -> f32 rounded to nearest, as
//     static_cast<float> and PyTorch's copy; bool -> 1.0 / 0.0), never
//     through float arithmetic, so NaN payloads, Inf and -0.0 arrive bit
//     for bit (the one-hot product spreads a NaN or Inf over its block and
//     turns -0.0 into +0.0).
// ---------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWordsPerLane = 16;
constexpr int kChunk = 32 * kWordsPerLane;     // words a warp takes at once
constexpr int kMaxDev = 1024;
constexpr int kMaxFields = 12;      // the QueryBatch wire lane has 11
constexpr unsigned kAll = 0xffffffffu;

enum : int64_t { kF32 = 0, kI64 = 1, kBool = 2 };

struct Field {
  const void* ptr;
  int64_t stride;      // elements between rows
  int64_t col;         // first packed column
  int64_t dtype;       // kF32, kI64, kBool
};

struct LaneArgs {
  const uint32_t* ring;        // [ring_rows, width]; d3_route_pack: the rows
  int64_t ring_rows;
  Field fields[kMaxFields];    // by column (FIELDS only)
  int64_t n_fields;
  const int64_t* order;
  const int64_t* starts;       // [n_dev + 1]
  uint32_t* send;              // [n_dev * cap, width]
  uint32_t* new_ring;          // [ring_out, width]
  int64_t ring_out;            // 0: no ring written
  int64_t n_dev, cap, width;
  int64_t send_chunks, chunks;
};

// a / b for 0 <= a, 0 < b; 32-bit division where both fit
__device__ __forceinline__ int64_t div_nn(int64_t a, int64_t b) {
  if (((a | b) >> 31) == 0) return (int64_t)((uint32_t)a / (uint32_t)b);
  return a / b;
}

__device__ __forceinline__ int64_t ld_i64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// Source row of output row `row` of the send buffer (ring false) or of the
// new ring (ring true); -1: a zero row. Source rows number under 2^31
// (the wrapper checks), so they ride in 32 bits.
__device__ __forceinline__ int row_source(const LaneArgs& a,
                                          const int64_t* starts,
                                          const int64_t* ovf, bool ring,
                                          int64_t row) {
  int64_t pos;
  if (!ring) {
    if (row >= a.n_dev * a.cap) return -1;
    const int64_t d = div_nn(row, a.cap);
    const int64_t r = row - d * a.cap;
    if (r >= starts[d + 1] - starts[d]) return -1;
    pos = starts[d] + r;
  } else {
    if (row >= a.ring_out || row >= ovf[a.n_dev]) return -1;
    int lo = 0, hi = (int)a.n_dev;          // ovf[lo] <= row < ovf[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ovf[mid] <= row) lo = mid; else hi = mid;
    }
    pos = starts[lo] + a.cap + (row - ovf[lo]);
  }
  return (int)ld_i64(a.order + pos);
}

// Word `col` of source row `src`, as the wire carries it.
// fcol: the fields' first columns, past n_fields INT32_MAX (registers).
template <bool FIELDS>
__device__ __forceinline__ uint32_t source_word(const LaneArgs& a,
                                                const Field* fs,
                                                const int* fcol, int src,
                                                int col) {
  if (!FIELDS || src < a.ring_rows)
    return __ldg(a.ring + (int64_t)src * a.width + col);
  const int64_t i = src - a.ring_rows;
  int f = 0;
#pragma unroll
  for (int k = 1; k < kMaxFields; ++k)
    if (col >= fcol[k]) f = k;
  const Field& F = fs[f];
  const int64_t at = i * F.stride + (col - F.col);
  if (F.dtype == kF32) return __ldg(static_cast<const uint32_t*>(F.ptr) + at);
  if (F.dtype == kI64)
    return __float_as_uint(
        (float)__ldg(static_cast<const long long*>(F.ptr) + at));
  return __ldg(static_cast<const unsigned char*>(F.ptr) + at) ? 0x3f800000u
                                                              : 0u;
}

// The words [at, min(at + 4, end)) of out: one 16-byte store when whole.
__device__ __forceinline__ void store4(uint32_t* out, int64_t at, int64_t end,
                                       uint4 x) {
  if (at + 4 <= end) {
    *reinterpret_cast<uint4*>(out + at) = x;
    return;
  }
  if (at < end) out[at] = x.x;
  if (at + 1 < end) out[at + 1] = x.y;
  if (at + 2 < end) out[at + 2] = x.z;
}

// One warp's chunk: its output buffer, words [q0, q1), its last row and
// the window of sources of rows wbase .. wbase + 31 (a lane each).
struct Chunk {
  uint32_t* out;
  int64_t q0, q1, row_last, wbase;
  int wsrc;
  bool ring;
};

__device__ __forceinline__ Chunk chunk_at(const LaneArgs& a,
                                          const int64_t* starts,
                                          const int64_t* ovf, int64_t c,
                                          int lane) {
  Chunk k;
  k.ring = c >= a.send_chunks;
  k.out = k.ring ? a.new_ring : a.send;
  k.q0 = (k.ring ? c - a.send_chunks : c) * kChunk;
  const int64_t n_words = (k.ring ? a.ring_out : a.n_dev * a.cap) * a.width;
  k.q1 = k.q0 + kChunk < n_words ? k.q0 + kChunk : n_words;
  k.wbase = div_nn(k.q0, a.width);
  k.row_last = k.q1 > k.q0 ? div_nn(k.q1 - 1, a.width) : k.wbase - 1;
  k.wsrc = k.wbase + lane <= k.row_last
               ? row_source(a, starts, ovf, k.ring, k.wbase + lane)
               : -1;
  return k;
}

// WIDE (width >= 32): a chunk's 512 words span at most 17 rows, all in
// its window, and a lane's column wraps at most once a step, so the loop
// holds no division and no window reload; narrower rows slide the window.
template <bool FIELDS, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    route_lane_kernel(const LaneArgs a) {
  __shared__ int64_t s_starts[kMaxDev + 1];
  __shared__ int64_t s_ovf[kMaxDev + 1];
  __shared__ Field s_fields[kMaxFields];
  __shared__ __align__(16) uint32_t s_stage[kWarps][kChunk];
  for (int i = threadIdx.x; i <= a.n_dev; i += kThreads)
    s_starts[i] = ld_i64(a.starts + i);
  if (FIELDS) {
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k)
      if ((int)threadIdx.x == k && k < a.n_fields) s_fields[k] = a.fields[k];
  }
  __syncthreads();
  if (a.ring_out > 0 && threadIdx.x == 0) {
    int64_t run = 0;
    for (int d = 0; d < a.n_dev; ++d) {
      s_ovf[d] = run;
      const int64_t o = s_starts[d + 1] - s_starts[d] - a.cap;
      run += o > 0 ? o : 0;
    }
    s_ovf[a.n_dev] = run;
  }
  __syncthreads();

  int fcol[kMaxFields];
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k)
    fcol[k] = FIELDS && k < a.n_fields ? (int)a.fields[k].col : INT32_MAX;
  const int lane = threadIdx.x & 31;
  uint32_t* stage = s_stage[threadIdx.x >> 5];
  const int W = (int)a.width;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the next chunk's window is loaded while this chunk's rows are
  Chunk nxt = chunk_at(a, s_starts, s_ovf, c, lane);
  for (; c < a.chunks; c += stride) {
    const Chunk k = nxt;
    const bool any = __any_sync(kAll, k.wsrc >= 0);
    if (!any && (WIDE || k.row_last - k.wbase < 32)) {
      nxt = chunk_at(a, s_starts, s_ovf, c + stride, lane);
#pragma unroll
      for (int i = 0; i < kWordsPerLane / 4; ++i)
        store4(k.out, k.q0 + 128 * i + 4 * lane, k.q1,
               make_uint4(0, 0, 0, 0));
      continue;
    }
    // this lane's word q0 + 32 j + lane: its row (from the window's
    // first) and column, stepped
    const int c0 = (int)(k.q0 - k.wbase * W);
    int col = c0 + lane, rr = 0;
    if (WIDE) {
      if (col >= W) { col -= W; rr = 1; }
    } else {
      rr = col / W;
      col -= rr * W;
    }
    int64_t wbase = k.wbase;
    int wsrc = k.wsrc;
    uint32_t v[kWordsPerLane];
#pragma unroll
    for (int j = 0; j < kWordsPerLane; ++j) {
      if (j > 0) {
        col += 32;
        if (WIDE) {
          if (col >= W) { col -= W; ++rr; }
        } else if (col >= W) {
          rr += col / W;
          col %= W;
        }
      }
      if (!WIDE) {
        const int top = __shfl_sync(kAll, rr, 31);
        if (top >= 32) {                    // warp-uniform: slide
          const int by = __shfl_sync(kAll, rr, 0);
          wbase += by;
          rr -= by;
          wsrc = wbase + lane <= k.row_last
                     ? row_source(a, s_starts, s_ovf, k.ring, wbase + lane)
                     : -1;
        }
      }
      const int src = __shfl_sync(kAll, wsrc, rr & 31);
      v[j] = (k.q0 + 32 * j + lane < k.q1 && src >= 0)
                 ? source_word<FIELDS>(a, s_fields, fcol, src, col)
                 : 0u;
    }
    nxt = chunk_at(a, s_starts, s_ovf, c + stride, lane);
#pragma unroll
    for (int j = 0; j < kWordsPerLane; ++j) stage[32 * j + lane] = v[j];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kWordsPerLane / 4; ++i)
      store4(k.out, k.q0 + 128 * i + 4 * lane, k.q1,
             *reinterpret_cast<const uint4*>(stage + 128 * i + 4 * lane));
    __syncwarp();
  }
}

// Blocks the card holds at once (cached: one kind of card a process).
template <bool FIELDS, bool WIDE>
int64_t resident_blocks() {
  static int64_t blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_lane_kernel<FIELDS, WIDE>, kThreads, 0);
    blocks = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <bool FIELDS, bool WIDE>
int launch_wide(const LaneArgs& a, cudaStream_t st) {
  const int64_t need = (a.chunks + kWarps - 1) / kWarps;
  const int64_t most = resident_blocks<FIELDS, WIDE>();
  route_lane_kernel<FIELDS, WIDE><<<(unsigned)(need < most ? need : most),
                                    kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool FIELDS>
int launch(LaneArgs a, cudaStream_t st) {
  if (a.n_dev < 1 || a.n_dev > kMaxDev || a.cap < 1 || a.width < 1 ||
      a.width > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.send) |
       reinterpret_cast<uintptr_t>(a.new_ring)) & 15)
    return (int)cudaErrorMisalignedAddress;
  a.send_chunks = (a.n_dev * a.cap * a.width + kChunk - 1) / kChunk;
  a.chunks = a.send_chunks + (a.ring_out * a.width + kChunk - 1) / kChunk;
  return a.width >= 32 ? launch_wide<FIELDS, true>(a, st)
                       : launch_wide<FIELDS, false>(a, st);
}

}  // namespace

extern "C" int d3_route_pack(const void* rows, const void* order,
                             const void* starts, void* out, int64_t n_dev,
                             int64_t cap, int64_t width, void* stream) {
  LaneArgs a = {};
  a.ring = (const uint32_t*)rows;
  a.order = (const int64_t*)order;
  a.starts = (const int64_t*)starts;
  a.send = (uint32_t*)out;
  a.n_dev = n_dev;
  a.cap = cap;
  a.width = width;
  return launch<false>(a, (cudaStream_t)stream);
}

// fields: host array of n_fields x {pointer, row stride, first column,
// dtype}, by column; ring_rows K rows of ring and of new_ring.
extern "C" int d3_route_lane(const void* ring, int64_t ring_rows,
                             const int64_t* fields, int64_t n_fields,
                             const void* order, const void* starts,
                             void* send, void* new_ring, int64_t n_dev,
                             int64_t cap, int64_t width, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields)
    return (int)cudaErrorInvalidValue;
  LaneArgs a = {};
  a.ring = (const uint32_t*)ring;
  a.ring_rows = ring_rows;
  for (int64_t f = 0; f < n_fields; ++f) {
    a.fields[f].ptr = (const void*)(uintptr_t)fields[4 * f];
    a.fields[f].stride = fields[4 * f + 1];
    a.fields[f].col = fields[4 * f + 2];
    a.fields[f].dtype = fields[4 * f + 3];
  }
  a.n_fields = n_fields;
  a.order = (const int64_t*)order;
  a.starts = (const int64_t*)starts;
  a.send = (uint32_t*)send;
  a.new_ring = (uint32_t*)new_ring;
  a.ring_out = ring_rows;
  a.n_dev = n_dev;
  a.cap = cap;
  a.width = width;
  return launch<true>(a, (cudaStream_t)stream);
}
