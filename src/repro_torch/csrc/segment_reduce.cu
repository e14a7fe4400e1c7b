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
// Kernel A: segment_deliver (wrappers: ops.deliver_rows, segment_sum_rows)
//   Replaces the Pallas kernel repro/kernels/segment_reduce/kernel.py:
//   segment_sum_kernel (body _kernel), which sums destination-sorted rows
//   of an XLA-packed [vec | cnt | touch] payload into output tiles with a
//   one-hot MXU matmul, carrying each tile across sequential grid steps.
//   Here the same function is one gather-form pass over destination-sorted
//   runs, row_ptr [n + 1] (run r holds records row_ptr[r] .. row_ptr[r+1]):
//     add: out[r]  = base[r] + sum_j vec[order[j]]     (j in run r)
//          cnt_out[r] = base_cnt[r] + sum_j cnt[order[j]]
//     set: out[r]  = vec[order[row_ptr[r+1] - 1]] if the run is non-empty,
//          else base[r] (a copy of the run's last record, no sum)
//     flag[r] = the run is non-empty (dirty / touched)
//   order = null reads record j from vec row j; base = null reads zeros.
//   Every record in a run is live: the caller's stable sort puts dropped
//   records at the sentinel id n_rows, past every run, so no payload,
//   mask or fill pass exists.
//
//   Partition (add): merge-based segmented reduction. The merge path of
//   the n output rows and the live records is cut into shares of `share`
//   items; plan [2, n_shares + 1] (computed in PyTorch with one
//   searchsorted, kernels/segment_reduce/ops.py:delivery_plan) holds, at
//   each cut, the rows ended and the records consumed before it. One warp
//   takes one share: it sums its records in record order (f32) and writes
//   every row whose end lies in the share, base added, empty rows included,
//   so each output row is written once and no pass walks the table again.
//   A run cut by share boundaries leaves one partial per share in a carry
//   slot; the share holding the run's end writes its own partial to out.
//   The fixup launch visits the cut runs only (a run's first cut): the
//   CTA's 16 warps each sum a contiguous slice of the run's carries, the
//   slices are added in partition order, then the head partial, then the
//   base. No atomics anywhere: the result is deterministic and independent
//   of scheduling, which the canonical delivery order
//   (core/tick.py:canon_msg_batch) relies on, and a hub run of ~1e5
//   records spreads over ~1.6e3 warps.
//   Partition (set): a warp takes `share` consecutive rows; nothing is
//   summed, so nothing is cut and there is no fixup.
//
//   Bound: memory. Reads the live records' rows once (gathered), order,
//   counts, row_ptr and base; writes every output row once. One add per
//   element read, far below the f32 rate. What the design does about it:
//   lanes span columns with vector loads (float2 at d = 602, whose
//   2,408-byte rows are 8- but not 16-byte aligned; float4 where the row
//   stride allows, as at d = 64), so a warp moves a whole row (2.4 KB at
//   d = 602) per step instead of one 128-byte chunk, and unrolled,
//   independent loads keep U rows a warp in flight where rows are narrow
//   (U * K * VEC <= 32 floats a lane). ~20 resident warps an SM then hold
//   ~48 KB in flight, over the ~16-20 KB Little's law asks for
//   (3.35 TB/s x ~0.7 us / 132 SMs). Indices (order, row_ptr) come in
//   windows of 32, one coalesced load a lane, broadcast by shuffles.
//   Registers, not shared memory, hold the rows: each byte is read once,
//   so a shared-memory ring (cp.async) would add a round trip and no
//   reuse; cp.async.bulk and TMA need 16-byte-aligned rows, which d = 602
//   does not give.
//
// Kernel B: mean_rows_gather (wrapper: ops.mean_rows_gather)
//   Replaces repro/kernels/segment_reduce/kernel.py:mean_rows_kernel
//   (body _mean_rows_kernel) together with the agg[rows] / cnt[rows]
//   gather PallasDelivery.agg_read_rows does before it:
//     out[k] = cnt[r] > 0 ? agg[r] / max(cnt[r], 1) : 0,  r = rows[k].
//   Exact IEEE division (__fdiv_rn), not __fdividef, so it equals
//   core/aggregators.py:mean_read.
//   Bound: memory. Reads K indices and counts and the picked rows with
//   cnt > 0 (d floats each), writes K * d floats. What the design does
//   about it: a warp takes `tile` picks (the K picks spread over the
//   warps the card holds, at most 32), their indices and counts in one
//   coalesced load each, broadcast by shuffles; a row moves as K float2
//   (d = 602, rows 8-byte aligned) or float4 (d % 4 == 0 and aligned)
//   vectors a lane held in registers, and the next pick's row is loaded
//   before the current one is stored. Narrow rows share a warp: at
//   d = 64 (16 float4) a warp moves two picks a step. Rows wider than
//   32 * VEC * 10 floats run in column tiles.
// ---------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kFixWarps = 16;
constexpr int kFixThreads = kFixWarps * 32;
constexpr unsigned kAll = 0xffffffffu;

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

__device__ __forceinline__ int64_t ld_i64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int64_t bcast(int64_t v, int src) {
  return (int64_t)__shfl_sync(kAll, (long long)v, src);
}

__host__ __device__ constexpr int clamp_u(int u) {
  return u < 1 ? 1 : (u > 8 ? 8 : u);
}

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void unpack(float t, float* f) { f[0] = t; }
__device__ __forceinline__ void unpack(float2 t, float* f) {
  f[0] = t.x; f[1] = t.y;
}
__device__ __forceinline__ void unpack(float4 t, float* f) {
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void pack(const float* f, float* t) { *t = f[0]; }
__device__ __forceinline__ void pack(const float* f, float2* t) {
  *t = make_float2(f[0], f[1]);
}
__device__ __forceinline__ void pack(const float* f, float4* t) {
  *t = make_float4(f[0], f[1], f[2], f[3]);
}

// A lane's part of one row: K vectors of VEC floats at columns
// (k * 32 + lane) * VEC, k < K. d is a multiple of VEC (the wrapper picks
// VEC so), so a vector is either wholly inside the row or wholly past it.
template <int VEC, int K>
struct Frag {
  float v[K * VEC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < K * VEC; ++i) v[i] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* row, int lane,
                                       int64_t d) {
    using T = typename Vec<VEC>::T;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = ((int64_t)k * 32 + lane) * VEC;
      if (c < d) {
        unpack(__ldg(reinterpret_cast<const T*>(row + c)), v + k * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[k * VEC + e] = 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store(float* row, int lane,
                                        int64_t d) const {
    using T = typename Vec<VEC>::T;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = ((int64_t)k * 32 + lane) * VEC;
      if (c < d) pack(v + k * VEC, reinterpret_cast<T*>(row + c));
    }
  }
  __device__ __forceinline__ void add(const Frag& o) {
#pragma unroll
    for (int i = 0; i < K * VEC; ++i) v[i] += o.v[i];
  }
};

// 32 consecutive int64 values p[base .. base + 31], one a lane. get(i) for
// non-decreasing i >= base broadcasts p[i], reloading the window (one
// coalesced load) when i passes its end. Warp-uniform use only.
struct Window {
  const int64_t* p;
  int64_t base, limit, val;
  int lane;
  __device__ __forceinline__ Window(const int64_t* p_, int64_t b,
                                    int64_t lim, int l)
      : p(p_), base(b), limit(lim), val(0), lane(l) {
    fill();
  }
  __device__ __forceinline__ void fill() {
    val = (p != nullptr && base + lane < limit) ? ld_i64(p + base + lane) : 0;
  }
  __device__ __forceinline__ int64_t get(int64_t i) {
    if (i - base >= 32) {
      base = i;
      fill();
    }
    return bcast(val, (int)(i - base));
  }
};

struct DeliverArgs {
  const float* vec;
  int64_t vec_ld;
  const int64_t* order;          // null: record j is vec row j
  const float* cnt;              // null: no counts
  int64_t cnt_st;
  const int64_t* row_ptr;        // [n_rows + 1]
  const int64_t* plan;           // [2, n_shares + 1] (add only)
  const float* base;             // null: zeros
  int64_t base_ld;
  const float* base_cnt;         // null: zeros
  int64_t base_cnt_st;
  float* out;
  int64_t out_ld;
  float* cnt_out;                // null: no counts
  uint8_t* flag;                 // null: no flags
  float* carry;                  // [n_shares, carry_ld] (add only)
  float* carry_cnt;              // [n_shares]
  int64_t carry_ld;
  int64_t n_rows, d, n_shares, share;
};

// One share of the merge path, add mode.
template <int VEC, int K, int U>
__device__ __forceinline__ void add_share(const DeliverArgs& a, int64_t s,
                                          int lane) {
  using F = Frag<VEC, K>;
  const int64_t s1 = a.n_shares + 1;
  const int64_t i0 = ld_i64(a.plan + s), i1 = ld_i64(a.plan + s + 1);
  const int64_t j0 = ld_i64(a.plan + s1 + s);
  const int64_t j1 = ld_i64(a.plan + s1 + s + 1);
  if (i0 == i1 && j0 == j1) return;               // past the path's end
  Window rp(a.row_ptr, i0, a.n_rows + 1, lane);
  Window ix(a.order, j0, j1, lane);
  int64_t r = i0, j = j0;
  int64_t start = rp.get(r);                      // row_ptr[r]
  // row i0's first records lie in earlier shares: write only its partial
  const bool head_cut = j0 > start;
  F acc, bb;
  acc.zero();
  bb.zero();
  float cacc = 0.0f;
  if (r < i1 && a.base != nullptr && !head_cut)
    bb.load(a.base + r * a.base_ld, lane, a.d);
  for (;;) {
    const int64_t end = r < i1 ? rp.get(r + 1) : j1;
    for (; j + U <= end; j += U) {
      F buf[U];
      float c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t src = a.order != nullptr ? ix.get(j + u) : j + u;
        buf[u].load(a.vec + src * a.vec_ld, lane, a.d);
        c[u] = a.cnt != nullptr ? __ldg(a.cnt + src * a.cnt_st) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc.add(buf[u]);
        cacc += c[u];
      }
    }
    for (; j < end; ++j) {
      const int64_t src = a.order != nullptr ? ix.get(j) : j;
      F one;
      one.load(a.vec + src * a.vec_ld, lane, a.d);
      acc.add(one);
      if (a.cnt != nullptr) cacc += __ldg(a.cnt + src * a.cnt_st);
    }
    if (r >= i1) break;
    // row r ends in this share
    const bool cut = r == i0 && head_cut;
    if (!cut && a.base != nullptr) {
#pragma unroll
      for (int i = 0; i < K * VEC; ++i) acc.v[i] = bb.v[i] + acc.v[i];
    }
    acc.store(a.out + r * a.out_ld, lane, a.d);
    if (lane == 0) {
      if (a.cnt_out != nullptr)
        a.cnt_out[r] = (cut || a.base_cnt == nullptr)
                           ? cacc : a.base_cnt[r * a.base_cnt_st] + cacc;
      if (a.flag != nullptr) a.flag[r] = end > start ? 1 : 0;
    }
    acc.zero();
    cacc = 0.0f;
    start = end;
    ++r;
    if (r < i1 && a.base != nullptr)
      bb.load(a.base + r * a.base_ld, lane, a.d);
  }
  // records of row i1 consumed here: its partial goes to this share's slot
  if (i1 < a.n_rows && j1 > start) {
    acc.store(a.carry + s * a.carry_ld, lane, a.d);
    if (lane == 0 && a.carry_cnt != nullptr) a.carry_cnt[s] = cacc;
  }
}

// `share` consecutive rows, set mode: copy each non-empty run's last
// record, else the base row.
template <int VEC, int K, int U>
__device__ __forceinline__ void set_share(const DeliverArgs& a, int64_t s,
                                          int lane) {
  using F = Frag<VEC, K>;
  const int64_t r0 = s * a.share;
  const int64_t r1 = r0 + a.share < a.n_rows ? r0 + a.share : a.n_rows;
  if (r0 >= r1) return;
  Window rp(a.row_ptr, r0, a.n_rows + 1, lane);
  int64_t lo = rp.get(r0);
  for (int64_t r = r0; r < r1; r += U) {
    int64_t src[U];
    bool hit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {          // indices first, all in flight
      src[u] = -1;
      hit[u] = false;
      if (r + u < r1) {
        const int64_t hi = rp.get(r + u + 1);
        hit[u] = hi > lo;
        if (hit[u]) src[u] = a.order != nullptr ? ld_i64(a.order + hi - 1)
                                                : hi - 1;
        lo = hi;
      }
    }
    F buf[U];
    float c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {          // then the rows
      c[u] = 0.0f;
      if (hit[u]) {
        buf[u].load(a.vec + src[u] * a.vec_ld, lane, a.d);
        if (a.cnt != nullptr) c[u] = __ldg(a.cnt + src[u] * a.cnt_st);
      } else if (r + u < r1 && a.base != nullptr) {
        buf[u].load(a.base + (r + u) * a.base_ld, lane, a.d);
        if (a.base_cnt != nullptr)
          c[u] = __ldg(a.base_cnt + (r + u) * a.base_cnt_st);
      } else {
        buf[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < r1) {
        buf[u].store(a.out + (r + u) * a.out_ld, lane, a.d);
        if (lane == 0) {
          if (a.cnt_out != nullptr) a.cnt_out[r + u] = c[u];
          if (a.flag != nullptr) a.flag[r + u] = hit[u] ? 1 : 0;
        }
      }
    }
  }
}

template <int VEC, int K, bool SET>
__global__ void __launch_bounds__(kThreads)
    segment_deliver_kernel(const DeliverArgs a) {
  constexpr int U = SET ? clamp_u(48 / (K * VEC)) : clamp_u(32 / (K * VEC));
  const int lane = threadIdx.x & 31;
  for (int64_t s = warp_id(); s < a.n_shares; s += warps_total()) {
    if constexpr (SET)
      set_share<VEC, K, U>(a, s, lane);
    else
      add_share<VEC, K, U>(a, s, lane);
  }
}

// The cut runs of an add-mode delivery. A CTA checks 32 boundaries at once
// (one a lane of warp 0), then finishes each run whose FIRST cut is among
// them, in boundary order.
template <int VEC, int K>
__global__ void __launch_bounds__(kFixThreads)
    segment_deliver_fixup_kernel(const DeliverArgs a) {
  using F = Frag<VEC, K>;
  constexpr int KV = K * VEC;
  constexpr int U = clamp_u(64 / KV);
  extern __shared__ float part[];        // [kFixWarps][KV][32] partials
  float* part_cnt = part + kFixWarps * KV * 32;
  __shared__ unsigned first_cuts;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t s1 = a.n_shares + 1;
  const int64_t n_bounds = a.n_shares - 1;        // boundaries 1 .. S-1
  for (int64_t b0 = (int64_t)blockIdx.x * 32; b0 < n_bounds;
       b0 += (int64_t)gridDim.x * 32) {
    if (w == 0) {
      const int64_t s = 1 + b0 + lane;
      bool first = false;
      if (s < a.n_shares) {
        const int64_t r = ld_i64(a.plan + s);
        if (r < a.n_rows) {
          const int64_t lo = ld_i64(a.row_ptr + r);
          // boundary s cuts run r, and no earlier boundary does
          first = ld_i64(a.plan + s1 + s) > lo && s == (lo + r) / a.share + 1;
        }
      }
      const unsigned m = __ballot_sync(kAll, first);
      if (lane == 0) first_cuts = m;
    }
    __syncthreads();
    const unsigned cuts = first_cuts;
    __syncthreads();
    for (unsigned left = cuts; left != 0; left &= left - 1) {
      const int64_t s = 1 + b0 + (__ffs(left) - 1);
      const int64_t r = ld_i64(a.plan + s);
      const int64_t sa = s - 1;                   // share of the first record
      const int64_t sb = (ld_i64(a.row_ptr + r + 1) + r) / a.share;
      const int64_t m = sb - sa;                  // carries sa .. sb - 1
      const int64_t c0 = sa + m * w / kFixWarps;
      const int64_t c1 = sa + m * (w + 1) / kFixWarps;
      F acc;
      acc.zero();
      float cacc = 0.0f;
      for (int64_t c = c0; c < c1; c += U) {
        F buf[U];
        float cc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          cc[u] = 0.0f;
          if (c + u < c1) {
            buf[u].load(a.carry + (c + u) * a.carry_ld, lane, a.d);
            if (a.carry_cnt != nullptr) cc[u] = a.carry_cnt[c + u];
          } else {
            buf[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc.add(buf[u]);
          cacc += cc[u];
        }
      }
#pragma unroll
      for (int i = 0; i < KV; ++i) part[(w * KV + i) * 32 + lane] = acc.v[i];
      if (lane == 0) part_cnt[w] = cacc;
      __syncthreads();
      if (w == 0) {
        F tot, x;
#pragma unroll
        for (int i = 0; i < KV; ++i) tot.v[i] = part[i * 32 + lane];
        float tc = part_cnt[0];
        for (int ww = 1; ww < kFixWarps; ++ww) {
#pragma unroll
          for (int i = 0; i < KV; ++i) tot.v[i] += part[(ww * KV + i) * 32 + lane];
          tc += part_cnt[ww];
        }
        x.load(a.out + r * a.out_ld, lane, a.d);  // the head partial
        tot.add(x);
        if (a.base != nullptr) {
          x.load(a.base + r * a.base_ld, lane, a.d);
#pragma unroll
          for (int i = 0; i < KV; ++i) tot.v[i] = x.v[i] + tot.v[i];
        }
        tot.store(a.out + r * a.out_ld, lane, a.d);
        if (lane == 0 && a.cnt_out != nullptr) {
          tc += a.cnt_out[r];
          a.cnt_out[r] = a.base_cnt != nullptr
                             ? a.base_cnt[r * a.base_cnt_st] + tc : tc;
        }
      }
      __syncthreads();
    }
  }
}

template <int VEC, int K>
int launch_deliver(const DeliverArgs& a, int set_mode, cudaStream_t st) {
  if (a.n_shares <= 0) return 0;
  if (set_mode) {
    segment_deliver_kernel<VEC, K, true>
        <<<grid_for(a.n_shares), kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  segment_deliver_kernel<VEC, K, false>
      <<<grid_for(a.n_shares), kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_shares < 2) return (int)err;
  const size_t smem = sizeof(float) * (size_t)kFixWarps * (K * VEC * 32 + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(segment_deliver_fixup_kernel<VEC, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t groups = (a.n_shares - 1 + 31) / 32;
  const unsigned grid = (unsigned)(groups < 65535 ? groups : 65535);
  segment_deliver_fixup_kernel<VEC, K><<<grid, kFixThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch_k(const DeliverArgs& a, int set_mode, int k, cudaStream_t st) {
  switch (k) {
    case 1: return launch_deliver<VEC, 1>(a, set_mode, st);
    case 2: return launch_deliver<VEC, 2>(a, set_mode, st);
    case 6: return launch_deliver<VEC, 6>(a, set_mode, st);
    case 10: return launch_deliver<VEC, 10>(a, set_mode, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

struct MeanArgs {
  const float* agg;    // [R, ld] row-major
  const float* cnt;    // [R]
  const int64_t* rows;
  float* out;          // [k, ld] row-major
  int64_t ld;
  int64_t k, d;        // picks; columns of this column tile
  int lpr_shift;       // a row spans 1 << lpr_shift lanes (K > 1: 5)
  int tile;            // picks a warp takes at once, <= 32
};

// A warp takes `tile` consecutive picks: their indices and counts in one
// coalesced load each (one a lane), then 32 >> lpr_shift picks a step,
// each a lane group's Frag, the next step's rows loaded before this
// step's stores. Rows with cnt <= 0 are not read.
template <int VEC, int K>
__global__ void __launch_bounds__(kThreads)
    mean_rows_gather_kernel(const MeanArgs a) {
  using F = Frag<VEC, K>;
  const int lane = threadIdx.x & 31;
  const int sub = lane >> a.lpr_shift;               // the step's pick
  const int sl = lane & ((1 << a.lpr_shift) - 1);    // lane within the row
  const int per = 32 >> a.lpr_shift;                 // picks a step
  for (int64_t t = warp_id(); t * a.tile < a.k; t += warps_total()) {
    const int64_t i0 = t * a.tile;
    const int n = a.k - i0 < a.tile ? (int)(a.k - i0) : a.tile;
    int64_t r = 0;
    float c = 0.0f;
    if (lane < n) {
      r = ld_i64(a.rows + i0 + lane);
      c = __ldg(a.cnt + r);
    }
    F cur, nxt;
    {
      const int64_t rp = bcast(r, sub);
      const float cp = __shfl_sync(kAll, c, sub);
      if (sub < n && cp > 0.0f) cur.load(a.agg + rp * a.ld, sl, a.d);
    }
    for (int p0 = 0; p0 < n; p0 += per) {
      const int p = p0 + sub, pn = p + per;
      const int64_t rn = bcast(r, pn & 31);
      const float cn = __shfl_sync(kAll, c, pn & 31);
      if (pn < n && cn > 0.0f) nxt.load(a.agg + rn * a.ld, sl, a.d);
      const float cp = __shfl_sync(kAll, c, p & 31);
      if (p < n) {
        const float den = fmaxf(cp, 1.0f);
#pragma unroll
        for (int i = 0; i < K * VEC; ++i)
          cur.v[i] = cp > 0.0f ? __fdiv_rn(cur.v[i], den) : 0.0f;
        cur.store(a.out + (i0 + p) * a.ld, sl, a.d);
      }
      cur = nxt;
    }
  }
}

// Warps the card holds at once for one instantiation (cached: one kind
// of card a process).
template <int VEC, int K>
int64_t mean_resident_warps() {
  static int64_t warps = 0;
  if (warps == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mean_rows_gather_kernel<VEC, K>, kThreads, 0);
    warps = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) *
            kWarpsPerBlock;
  }
  return warps;
}

// The grid holds at most the resident warps; the tile spreads the picks
// over them (K = 8192 picks on 132 SMs: two a warp).
template <int VEC, int K>
int launch_mean(MeanArgs a, cudaStream_t st) {
  const int64_t warps = mean_resident_warps<VEC, K>();
  int64_t tile = (a.k + warps - 1) / warps;
  tile = tile < 1 ? 1 : (tile > 32 ? 32 : tile);
  a.tile = (int)tile;
  const int64_t need = ((a.k + tile - 1) / tile + kWarpsPerBlock - 1) /
                       kWarpsPerBlock;
  const int64_t most = warps / kWarpsPerBlock;
  mean_rows_gather_kernel<VEC, K>
      <<<(unsigned)(need < most ? need : most), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch_mean(const MeanArgs& a, int k, cudaStream_t st) {
  switch (k) {
    case 1: return launch_mean<VEC, 1>(a, st);
    case 2: return launch_mean<VEC, 2>(a, st);
    case 6: return launch_mean<VEC, 6>(a, st);
    case 10: return launch_mean<VEC, 10>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int d3_segment_deliver(
    const void* vec, int64_t vec_ld, const void* order, const void* cnt,
    int64_t cnt_st, const void* row_ptr, const void* plan, const void* base,
    int64_t base_ld, const void* base_cnt, int64_t base_cnt_st, void* out,
    int64_t out_ld, void* cnt_out, void* flag, void* carry, void* carry_cnt,
    int64_t carry_ld, int64_t n_rows, int64_t d, int64_t n_shares,
    int64_t share, int64_t set_mode, int64_t vec_width, int64_t k,
    void* stream) {
  DeliverArgs a;
  a.vec = (const float*)vec;
  a.vec_ld = vec_ld;
  a.order = (const int64_t*)order;
  a.cnt = (const float*)cnt;
  a.cnt_st = cnt_st;
  a.row_ptr = (const int64_t*)row_ptr;
  a.plan = (const int64_t*)plan;
  a.base = (const float*)base;
  a.base_ld = base_ld;
  a.base_cnt = (const float*)base_cnt;
  a.base_cnt_st = base_cnt_st;
  a.out = (float*)out;
  a.out_ld = out_ld;
  a.cnt_out = (float*)cnt_out;
  a.flag = (uint8_t*)flag;
  a.carry = (float*)carry;
  a.carry_cnt = (float*)carry_cnt;
  a.carry_ld = carry_ld;
  a.n_rows = n_rows;
  a.d = d;
  a.n_shares = n_shares;
  a.share = share;
  const cudaStream_t st = (cudaStream_t)stream;
  const int set = set_mode != 0;
  switch (vec_width) {
    case 1: return dispatch_k<1>(a, set, (int)k, st);
    case 2: return dispatch_k<2>(a, set, (int)k, st);
    case 4: return dispatch_k<4>(a, set, (int)k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int d3_mean_rows_gather(const void* agg, const void* cnt,
                                   const void* rows, void* out, int64_t ld,
                                   int64_t k, int64_t d, int64_t vec_width,
                                   int64_t kc, int64_t lpr_shift,
                                   void* stream) {
  if (k <= 0 || d <= 0) return 0;
  if (lpr_shift < 0 || lpr_shift > 5 || (kc > 1 && lpr_shift != 5))
    return (int)cudaErrorInvalidValue;
  MeanArgs a;
  a.agg = (const float*)agg;
  a.cnt = (const float*)cnt;
  a.rows = (const int64_t*)rows;
  a.out = (float*)out;
  a.ld = ld;
  a.k = k;
  a.d = d;
  a.lpr_shift = (int)lpr_shift;
  a.tile = 1;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (vec_width) {
    case 1: return dispatch_mean<1>(a, (int)kc, st);
    case 2: return dispatch_mean<2>(a, (int)kc, st);
    case 4: return dispatch_mean<4>(a, (int)kc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
