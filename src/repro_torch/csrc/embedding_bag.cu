// Fused embedding-bag kernel for the two-tower recsys serve path (sm_90a).
//
// Built by repro_torch/kernels/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the output), and returns the cudaGetLastError() of its
// launch.
//
// ---------------------------------------------------------------------
// embedding_bag
//   Replaces the Pallas kernel repro/kernels/embedding_bag/kernel.py:
//   embedding_bag_kernel (body _kernel) together with the gather before
//   it in repro/kernels/embedding_bag/ops.py:embedding_bag (jnp.take).
//   For table [V, d] f32 and ids [B, W] (int32 or int64):
//     out[b] = sum over slots s of bag b with 0 <= ids[b, s] < V of
//              table[ids[b, s]]                          (mode sum)
//     out[b] = that sum / max(#{s : ids[b, s] >= 0}, 1)  (mode mean)
//   A negative id is padding; an all-padding bag reads 0; a bag holding
//   an id >= V reads NaN in every column (jnp.take's fill mode), and
//   only that bag.
//
//   The TPU kernel contracts a one-hot [64 W, 64] selector with the
//   gathered rows on the MXU, because there a reduce is cheapest as a
//   matmul, and it reads the [B W, d] rows that jnp.take wrote to HBM.
//   Here the work is ~W adds per output element, far under the card's
//   ridge point: the kernel is bound by bytes. So it moves each byte once
//   and nothing else: the gathered rows never exist in device memory.
//
//   Bound: memory. Reads every valid row once (n_valid * d * 4 bytes),
//   the ids once (B * W * 4 or 8), writes B * d * 4 bytes.
//
//   Design: one warp per bag (grid-stride over bags). Lane l reads id
//   slot l of each group of 32 slots once; the warp counts valid and
//   out-of-range ids by ballot. Lanes own 16-byte column vectors of a
//   row (a 256-wide f32 row is 64 float4, two per lane, neighbouring
//   lanes on neighbouring addresses), so each row load is coalesced. The
//   loads of kSlotsInFlight slots are all issued before they are added,
//   so a warp keeps up to 8 row loads in flight. The sum runs in f32 in
//   slot order from zero (a padding slot adds 0); mean then divides once
//   by max(n_valid, 1) with IEEE division, as the plain version does, so
//   the two differ only by the order of f32 adds. Rows whose width is
//   not a multiple of 4 floats (or a table not 16-byte aligned) take the
//   same path with one float per lane instead of a float4.
// ---------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kSlotsInFlight = 8;   // row loads issued before their adds
constexpr int kVecPerLane = 2;      // column vectors a lane owns per pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ float4 divided(const float4& a, float n) {
  return make_float4(__fdiv_rn(a.x, n), __fdiv_rn(a.y, n),
                     __fdiv_rn(a.z, n), __fdiv_rn(a.w, n));
}
__device__ __forceinline__ float divided(float a, float n) {
  return __fdiv_rn(a, n);
}

__device__ __forceinline__ void set_nan(float4& a) {
  const float q = __int_as_float(0x7fc00000);
  a = make_float4(q, q, q, q);
}
__device__ __forceinline__ void set_nan(float& a) {
  a = __int_as_float(0x7fc00000);
}

// Vec: float4 or float (the unit a lane loads); Id: int or long long.
// dv is the row width in Vecs.
template <typename Vec, typename Id, bool kMean>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const Vec* __restrict__ table,
                     const Id* __restrict__ ids, Vec* __restrict__ out,
                     int64_t n_rows, int64_t dv, int64_t n_bags,
                     int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       bag < n_bags; bag += n_warps) {
    const Id* bag_ids = ids + bag * width;
    Vec* bag_out = out + bag * dv;

    // the ids, once: lane l holds slot l of the first group of 32
    const long long first =
        lane < width ? (long long)__ldg(bag_ids + lane) : -1;
    int n_valid = 0;
    bool oob = false;
    for (int64_t s0 = 0; s0 < width; s0 += 32) {
      const long long id =
          s0 == 0 ? first
                  : (s0 + lane < width ? (long long)__ldg(bag_ids + s0 + lane)
                                       : -1);
      n_valid += __popc(__ballot_sync(kFull, id >= 0));
      oob |= __ballot_sync(kFull, id >= n_rows) != 0u;
    }
    if (oob) {  // warp-uniform: the whole bag reads NaN
      for (int64_t c = lane; c < dv; c += 32) {
        Vec q;
        set_nan(q);
        bag_out[c] = q;
      }
      continue;
    }

    for (int64_t c0 = 0; c0 < dv; c0 += 32 * kVecPerLane) {
      Vec acc[kVecPerLane];
#pragma unroll
      for (int k = 0; k < kVecPerLane; ++k) set_zero(acc[k]);
      for (int64_t s0 = 0; s0 < width; s0 += 32) {
        // groups past the first re-read their ids (from L1)
        const long long my_id =
            s0 == 0 ? first
                    : (s0 + lane < width
                           ? (long long)__ldg(bag_ids + s0 + lane)
                           : -1);
        const int n_group = (int)(width - s0 < 32 ? width - s0 : 32);
        for (int j0 = 0; j0 < n_group; j0 += kSlotsInFlight) {
          Vec buf[kSlotsInFlight][kVecPerLane];
#pragma unroll
          for (int j = 0; j < kSlotsInFlight; ++j) {
            // j0 <= 24, so the source lane j0 + j is at most 31
            const long long id = __shfl_sync(kFull, my_id, j0 + j);
            const bool live = j0 + j < n_group && id >= 0;
            const Vec* row = table + (live ? id : 0) * dv;
#pragma unroll
            for (int k = 0; k < kVecPerLane; ++k) {
              const int64_t c = c0 + k * 32 + lane;
              if (live && c < dv) {
                buf[j][k] = __ldg(row + c);
              } else {
                set_zero(buf[j][k]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kSlotsInFlight; ++j) {
#pragma unroll
            for (int k = 0; k < kVecPerLane; ++k) add_to(acc[k], buf[j][k]);
          }
        }
      }
      const float n = (float)(n_valid > 1 ? n_valid : 1);
#pragma unroll
      for (int k = 0; k < kVecPerLane; ++k) {
        const int64_t c = c0 + k * 32 + lane;
        if (c < dv) bag_out[c] = kMean ? divided(acc[k], n) : acc[k];
      }
    }
  }
}

template <typename Vec, typename Id, bool kMean>
int launch(const void* table, const void* ids, void* out, int64_t n_rows,
           int64_t dv, int64_t n_bags, int64_t width, cudaStream_t stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // the grid-stride loop covers bags past gridDim.x's limit
  const unsigned grid = (unsigned)(blocks < 0x7fffffff ? blocks : 0x7fffffff);
  embedding_bag_kernel<Vec, Id, kMean><<<grid, kThreads, 0, stream>>>(
      static_cast<const Vec*>(table), static_cast<const Id*>(ids),
      static_cast<Vec*>(out), n_rows, dv, n_bags, width);
  return (int)cudaGetLastError();
}

template <typename Vec>
int dispatch(const void* table, const void* ids, void* out, int64_t n_rows,
             int64_t dv, int64_t n_bags, int64_t width, bool ids_are_64,
             bool mean, cudaStream_t s) {
  if (ids_are_64) {
    return mean ? launch<Vec, long long, true>(table, ids, out, n_rows, dv,
                                               n_bags, width, s)
                : launch<Vec, long long, false>(table, ids, out, n_rows, dv,
                                                n_bags, width, s);
  }
  return mean ? launch<Vec, int, true>(table, ids, out, n_rows, dv, n_bags,
                                       width, s)
              : launch<Vec, int, false>(table, ids, out, n_rows, dv, n_bags,
                                        width, s);
}

}  // namespace

// table [n_rows, dim] f32, ids [n_bags, width] int32 (ids_are_64 = 0) or
// int64 (1), out [n_bags, dim] f32, all contiguous; mean = 1 for mode
// mean, 0 for sum. Returns a cudaError_t (0 = launched).
extern "C" int d3_embedding_bag(const void* table, const void* ids,
                                void* out, int64_t n_rows, int64_t dim,
                                int64_t n_bags, int64_t width,
                                int64_t ids_are_64, int64_t mean,
                                void* stream) {
  if (n_bags == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    return dispatch<float4>(table, ids, out, n_rows, dim / 4, n_bags, width,
                            ids_are_64 != 0, mean != 0, s);
  }
  return dispatch<float>(table, ids, out, n_rows, dim, n_bags, width,
                         ids_are_64 != 0, mean != 0, s);
}
