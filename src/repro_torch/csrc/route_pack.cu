// route_pack: the routing plane's send-buffer placement (sm_90a).
//
// Built by repro_torch/kernels/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry point launches on the caller's stream, allocates nothing and
// returns the cudaGetLastError() of its launch.
//
// ---------------------------------------------------------------------
// Replaces repro/kernels/route_pack/ops.py:route_pack (backend "pallas"),
// which places destination-sorted wire rows at their send slots with the
// one-hot MXU segment sum of repro/kernels/segment_reduce/kernel.py, after
// the router gathered rows_s = allp[order] (repro/dist/router.py) and
// before a zero fill of the empty slots. The TPU has no scatter, so
// placement there is a matmul; here it is a copy, in gather form:
//
//   out [n_dev * cap, W], slot s -> bucket d = s / cap, rank r = s % cap
//   out[s] = r < starts[d + 1] - starts[d] ? rows[order[starts[d] + r]]
//                                          : 0
//
// `order` and `starts` come from route_plan (kernels/route_pack/ops.py):
// the stable sort of the rows by destination and the first sorted
// position of every destination (starts[n_dev] = the live row count).
// The kernel fuses the three passes JAX makes separately (the rows_s
// gather, the placement, the zero fill): each shipped row is read once,
// each output byte written once, no atomics. Values move as 32-bit words,
// never through float arithmetic, so NaN payloads, Inf and -0.0 arrive
// bit for bit (the one-hot product spreads a NaN or Inf over its whole
// block and turns -0.0 into +0.0), and integer columns value-cast to f32
// survive exactly.
//
// One warp per output slot (grid-stride), its lanes over the row's
// columns: the 32 lanes read 32 consecutive words of a row. Row widths
// are not multiples of 4 words (W = 607 and 69 on the main path), so
// rows are not 16-byte aligned and the lanes move one word each.
// Bound: memory. Reads the shipped rows (n_ship * W * 4 bytes), the
// order entries of the shipped rows and starts; writes n_dev * cap * W * 4
// bytes.
// ---------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

unsigned int grid_for(int64_t n_warps) {
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // grid-stride loops cover the rest; 2^31-1 is gridDim.x's limit
  return (unsigned int)(blocks < 0x7fffffff ? blocks : 0x7fffffff);
}

__global__ void route_pack_kernel(const uint32_t* __restrict__ rows,
                                  const int64_t* __restrict__ order,
                                  const int64_t* __restrict__ starts,
                                  uint32_t* __restrict__ out, int64_t cap,
                                  int64_t n_slots, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       s < n_slots; s += stride) {
    const int64_t d = s / cap;
    const int64_t r = s - d * cap;
    const int64_t lo = starts[d];
    uint32_t* dst = out + s * width;
    if (r < starts[d + 1] - lo) {
      const uint32_t* src = rows + order[lo + r] * width;
#pragma unroll 4
      for (int64_t c = lane; c < width; c += 32) dst[c] = __ldg(src + c);
    } else {
#pragma unroll 4
      for (int64_t c = lane; c < width; c += 32) dst[c] = 0u;
    }
  }
}

}  // namespace

extern "C" int d3_route_pack(const void* rows, const void* order,
                             const void* starts, void* out, int64_t n_dev,
                             int64_t cap, int64_t width, void* stream) {
  const int64_t n_slots = n_dev * cap;
  route_pack_kernel<<<grid_for(n_slots), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int64_t*)order, (const int64_t*)starts,
      (uint32_t*)out, cap, n_slots, width);
  return (int)cudaGetLastError();
}
