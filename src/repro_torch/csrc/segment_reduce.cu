// Segment-reduce kernels for the streaming tick's delivery plane (sm_90a).
//
// Built by repro_torch/kernels/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the caller's stream, allocates nothing
// (the wrapper passes outputs and scratch), and returns the
// cudaGetLastError() of its launches.
//
// ---------------------------------------------------------------------
// Kernel A: segment_sum_rows
//   Replaces the Pallas kernel repro/kernels/segment_reduce/kernel.py:
//   segment_sum_kernel (body _kernel), which sums destination-sorted rows
//   into output tiles with a one-hot MXU matmul and carries each tile
//   across sequential grid steps. That carry has no counterpart here:
//   blocks run in parallel and in no order. The layout (stable sort by
//   destination, segment ids seg and run offsets row_ptr) is computed by
//   the caller in PyTorch; the kernel is a segmented reduction over fixed
//   tiles of kTileRows sorted rows, in two launches:
//     pass 1: one warp per (tile, 32-column chunk) walks its tile in
//             sorted order, summing each run in f32. A run that lies
//             inside the tile is written to out; the (at most two) runs
//             that cross the tile's edges leave their partial in
//             carry[tile][0] (the tile's first run) or carry[tile][1]
//             (its last run).
//     pass 2: one warp per (destination row, column chunk) writes zeros
//             for an empty run and, for a run spanning several tiles,
//             sums its partials in tile order.
//   Every row is written exactly once, with no atomics: the result is
//   deterministic and independent of scheduling, which the canonical
//   delivery order (core/tick.py:canon_msg_batch) relies on. Fixed tiles
//   bound each warp's serial work, so a hub destination whose run holds
//   ~1e5 rows is spread over ~1e3 warps instead of one.
//   Bound: memory. Reads every live row once (E_live * W * 4 bytes),
//   seg (E_live * 8) and row_ptr, writes n_rows * W * 4 bytes; one add
//   per element read, far below the f32 rate. The 32 lanes of a warp
//   read 32 consecutive floats of a row: one coalesced 128-byte load.
//
// Kernel B: mean_rows_gather
//   Replaces repro/kernels/segment_reduce/kernel.py:mean_rows_kernel
//   (body _mean_rows_kernel) together with the agg[rows] / cnt[rows]
//   gather PallasDelivery.agg_read_rows does before it:
//     out[k] = cnt[r] > 0 ? agg[r] / max(cnt[r], 1) : 0,  r = rows[k].
//   Exact IEEE division (__fdiv_rn), not __fdividef.
//   Bound: memory. Reads K picked rows of d floats plus K counts and
//   indices, writes K * d floats. One warp per picked row, lanes over
//   columns, so the gathered row is read coalesced.
// ---------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kTileRows = 128;

unsigned int grid_for(int64_t n_warps) {
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // grid-stride loops cover the rest; 2^31-1 is gridDim.x's limit
  return (unsigned int)(blocks < 0x7fffffff ? blocks : 0x7fffffff);
}

__device__ __forceinline__ int64_t warp_id() {
  return (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t warps_total() {
  return (int64_t)gridDim.x * kWarpsPerBlock;
}

__global__ void segment_sum_tiles_kernel(const float* __restrict__ rows,
                                         const int64_t* __restrict__ seg,
                                         const int64_t* __restrict__ row_ptr,
                                         float* __restrict__ out,
                                         float* __restrict__ carry,
                                         int64_t n_rows, int64_t width,
                                         int64_t n_tiles) {
  const int64_t n_cc = (width + 31) / 32;
  const int64_t e_live = row_ptr[n_rows];
  const int lane = threadIdx.x & 31;
  for (int64_t item = warp_id(); item < n_tiles * n_cc;
       item += warps_total()) {
    const int64_t t = item / n_cc;
    const int64_t c = (item % n_cc) * 32 + lane;
    const int64_t t0 = t * kTileRows;
    if (t0 >= e_live || c >= width) continue;
    const int64_t t1 = min(t0 + kTileRows, e_live);
    const int64_t first = seg[t0];
    int64_t cur = first;
    float acc = 0.0f;
    for (int64_t j = t0; j <= t1; ++j) {
      const int64_t s = j < t1 ? seg[j] : -1;
      if (s != cur) {
        // flush run `cur`: inside the tile -> out, else -> carry slot
        const int64_t lo = row_ptr[cur], hi = row_ptr[cur + 1];
        if (lo >= t0 && hi <= t1)
          out[cur * width + c] = acc;
        else
          carry[(t * 2 + (cur == first ? 0 : 1)) * width + c] = acc;
        acc = 0.0f;
        cur = s;
      }
      if (j < t1) acc += rows[j * width + c];
    }
  }
}

__global__ void segment_sum_fixup_kernel(const int64_t* __restrict__ seg,
                                         const int64_t* __restrict__ row_ptr,
                                         const float* __restrict__ carry,
                                         float* __restrict__ out,
                                         int64_t n_rows, int64_t width) {
  const int64_t n_cc = (width + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int64_t item = warp_id(); item < n_rows * n_cc;
       item += warps_total()) {
    const int64_t r = item / n_cc;
    const int64_t c = (item % n_cc) * 32 + lane;
    if (c >= width) continue;
    const int64_t lo = row_ptr[r], hi = row_ptr[r + 1];
    if (hi == lo) {
      out[r * width + c] = 0.0f;          // empty run
      continue;
    }
    const int64_t ta = lo / kTileRows, tb = (hi - 1) / kTileRows;
    if (ta == tb) continue;               // single tile: written by pass 1
    float acc = 0.0f;
    for (int64_t t = ta; t <= tb; ++t) {
      const int slot = seg[t * kTileRows] == r ? 0 : 1;
      acc += carry[(t * 2 + slot) * width + c];
    }
    out[r * width + c] = acc;
  }
}

__global__ void mean_rows_gather_kernel(const float* __restrict__ agg,
                                        const float* __restrict__ cnt,
                                        const int64_t* __restrict__ rows,
                                        float* __restrict__ out, int64_t k,
                                        int64_t d) {
  const int lane = threadIdx.x & 31;
  for (int64_t i = warp_id(); i < k; i += warps_total()) {
    const int64_t r = rows[i];
    const float c = cnt[r];
    const float denom = fmaxf(c, 1.0f);
    const float* src = agg + r * d;
    float* dst = out + i * d;
    for (int64_t col = lane; col < d; col += 32)
      dst[col] = c > 0.0f ? __fdiv_rn(src[col], denom) : 0.0f;
  }
}

}  // namespace

extern "C" int d3_segment_sum_rows(const void* rows, const void* seg,
                                   const void* row_ptr, void* out,
                                   void* carry, int64_t n_rows,
                                   int64_t width, int64_t n_tiles,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_cc = (width + 31) / 32;
  if (n_tiles > 0) {
    segment_sum_tiles_kernel<<<grid_for(n_tiles * n_cc), kThreads, 0, s>>>(
        (const float*)rows, (const int64_t*)seg, (const int64_t*)row_ptr,
        (float*)out, (float*)carry, n_rows, width, n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_fixup_kernel<<<grid_for(n_rows * n_cc), kThreads, 0, s>>>(
      (const int64_t*)seg, (const int64_t*)row_ptr, (const float*)carry,
      (float*)out, n_rows, width);
  return (int)cudaGetLastError();
}

extern "C" int d3_mean_rows_gather(const void* agg, const void* cnt,
                                   const void* rows, void* out, int64_t k,
                                   int64_t d, void* stream) {
  mean_rows_gather_kernel<<<grid_for(k), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)agg, (const float*)cnt, (const int64_t*)rows,
      (float*)out, k, d);
  return (int)cudaGetLastError();
}

extern "C" int64_t d3_segment_sum_tile_rows() { return kTileRows; }
