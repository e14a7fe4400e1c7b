// Flash attention for the LM prefill path (sm_90a).
//
// Built by repro_torch/kernels/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Each launching entry point runs on the caller's stream, allocates nothing
// (the wrapper passes the output), and returns 0 or the error of its launch.
//
// ---------------------------------------------------------------------
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py:73
// flash_attention_kernel (body _kernel) together with the GQA folding of
// its wrapper ops.py:flash_attention:
//
//   o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, kh] * scale) v[b, t, kh]
//   kh = h / (H / Kh),  scale = 1 / sqrt(D),
//   causal: key t is visible to query s iff t <= s (both from 0).
//
// Every kernel reads q [B,S,H,D] and k/v [B,T,Kh,D] in place from their
// strides (the last dimension contiguous): nothing is transposed and the
// KV broadcast over the G = H / Kh query heads of a group is never
// materialised. Arithmetic follows kernel.py: scores and the running max /
// sum / output accumulator are f32, masked scores are -1e30, p = exp(s - m)
// is cast to v's type before p @ v, and the output is acc / max(l, 1e-30)
// in q's type. CTAs launch heaviest causal query tile first, and the heads
// of one KV group are adjacent in launch order, so they share K/V in L2.
// Causal tiles entirely above the diagonal are never visited; only tiles
// that cross the diagonal or the ragged key edge T are masked.
//
// The wrapper picks the kernel by dtype and head dim:
//
// bf16, D in {64, 128} (the model's D = 128): flash_wgmma_kernel, built
// for Hopper. One CTA of three warpgroups per (batch, head, 128-query
// tile). Warpgroup 0 is the producer: it gives up registers (setmaxnreg
// 24) and one of its threads issues every load as a TMA copy: the Q tile
// once, then K and V tiles of 128 keys into a ring of stages (3 at
// D = 128: 192 KB of K and V beside Q's 32 KB; 4 at D = 64). Each stage's
// K and V have their own `full` mbarrier, armed with expect_tx of the
// tile's bytes; each stage is freed by an `empty` mbarrier on which every
// consumer warp arrives once the wgmma that read the stage has retired.
// Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
// each. The tensor maps (4-D: D, heads, sequence, batch, from the caller's
// strides; 128-byte swizzle; zero fill past the ragged edges, which the
// scores still mask) are encoded on the host for each call. S = Q K^T is
// wgmma m64n128k16 with Q and K read from shared memory through K-major
// descriptors. O += P V is the register-A form: S's f32 accumulator,
// rounded to bf16, is already laid out as the A fragment, and V is read
// through an MN-major descriptor with the transpose bit, so neither P nor
// V^T is ever stored. Within a warpgroup the next tile's Q K^T is issued
// before this tile's P V, so its softmax runs while the tensor cores work;
// the two consumers take turns to issue (two named barriers), so one's
// softmax also overlaps the other's products. O is rescaled only after
// the P V in flight on it has retired. The output is stored from
// registers, rows past S skipped.
//
// bf16, D in {16, 32}: flash_bf16_kernel, Ampere-style. One CTA of 4
// warps per (batch, head, 64-query tile), K/V tiles of 64 keys in a
// two-stage cp.async ring, mma.sync m16n8k16 with ldmatrix fragments and
// P kept in registers. It is also built at D = 128, reachable only
// through a private entry that chip_smoke.py times as the yardstick of the
// kernel above; nothing on the serve path reaches it.
//
// f32 (the reduced configuration): CUDA cores, one thread per query row,
// 64 rows per CTA, K/V tiles of 16 keys in shared memory (read by every
// thread at the same address: broadcasts), the row's accumulator in
// registers (D floats; the tile's 16 scores keep D = 128 under 255
// registers), one rescale per tile.
//
// Bound at the prefill shape (B = 1, S = T = 32768, H = 32, Kh = 8,
// D = 128, causal, bf16): 4 * D * H * S * (S + 1) / 2 = 8.80e12 tensor-core
// FLOPs, 8.9 ms at 989 TFLOP/s, against 671 MB of q, k, v and o, 0.20 ms at
// 3.35 TB/s: the operations bound it. Only wgmma reaches that rate
// (mma.sync about a third of it). The exponentials (S^2 H / 2 = 1.7e10 at
// 16 a clock an SM) would take about half the matmuls' time on their own,
// which is why the softmax overlaps the tensor cores' work.
// ---------------------------------------------------------------------
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// bf16 tensor-core kernel
constexpr int kBlockM = 64;        // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;        // keys per K/V tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;

// f32 CUDA-core kernel
constexpr int kF32Rows = 64;       // query rows per CTA, one per thread
constexpr int kF32Keys = 16;       // keys per K/V tile

struct Params {
  int64_t qb, qs, qh;              // strides (elements) of q [B,S,H,D]
  int64_t kb, ks, kh;              // k [B,T,Kh,D]
  int64_t vb, vs, vh;              // v [B,T,Kh,D]
  int64_t ob, os, oh;              // o [B,S,H,D]
  int B, S, T, H, Kh;
  int causal;
  float scale;
};

// CTA -> (batch, head, query tile): heads vary fastest, the heaviest
// causal query tiles come first.
struct Tile {
  int b, h, kvh, q0, kv_end;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int block_m) {
  const int n_qt = (p.S + block_m - 1) / block_m;
  int64_t bid = blockIdx.x;
  Tile t;
  t.h = (int)(bid % p.H);
  bid /= p.H;
  t.b = (int)(bid % p.B);
  bid /= p.B;
  t.q0 = (n_qt - 1 - (int)bid) * block_m;
  t.kvh = t.h / (p.H / p.Kh);
  // keys past the last visible one are never read
  t.kv_end = p.causal ? min(p.T, min(t.q0 + block_m, p.S)) : p.T;
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int smem_bytes_bf16() {
  // Q tile + two stages each of K and V, rows padded to D + 8
  return (kBlockM + 4 * kBlockN) * (D + 8) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      const Params p) {
  constexpr int kStride = D + 8;   // padded shared row, elements
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kNt = kBlockN / 8; // n8 tiles of S per warp
  constexpr int kDt = D / 8;       // n8 tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlockM * kStride;
  bf16* sV = sK + 2 * kBlockN * kStride;

  const Tile t = tile_of(p, kBlockM);
  const bf16* qg = q + t.b * p.qb + t.h * p.qh;
  const bf16* kg = k + t.b * p.kb + t.kvh * p.kh;
  const bf16* vg = v + t.b * p.vb + t.kvh * p.vh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_kt = (t.kv_end + kBlockN - 1) / kBlockN;

  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool ok = t.q0 + r < p.S;
    cp_async16(sQ + r * kStride + cc * 8,
               qg + (int64_t)(ok ? t.q0 + r : 0) * p.qs + cc * 8, ok);
  }
  auto load_kv = [&](int kt, int stage) {
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      const int pos = kt * kBlockN + r;
      const bool ok = pos < p.T;
      const int64_t row = ok ? pos : 0;
      const int off = (stage * kBlockN + r) * kStride + cc * 8;
      cp_async16(sK + off, kg + row * p.ks + cc * 8, ok);
      cp_async16(sV + off, vg + row * p.vs + cc * 8, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.0f, 0.0f};  // this thread's columns only until the end
  const int row0 = t.q0 + warp * 16 + (lane >> 2);
  const int j = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row in it

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile kt (and Q)
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (j & 1) * 8 + r8) * kStride +
                                kk * 16 + (j >> 1) * 8);
    }
    const bf16* sKs = sK + stage * kBlockN * kStride;
    const bf16* sVs = sV + stage * kBlockN * kStride;

    // S = Q K^T (f32)
    float s[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNt; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sKs + ((nt + (j >> 1)) * 8 + r8) * kStride + kk * 16 +
                           (j & 1) * 8);
        mma_bf16(s[nt], qf[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask (only tiles crossing the diagonal or the edge T)
    const int k0 = kt * kBlockN;
    const bool masked =
        k0 + kBlockN > p.T || (p.causal && k0 + kBlockN - 1 > t.q0);
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          const int kpos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= p.T || (p.causal && kpos > qpos)) x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax: the 4 lanes of a quad share a row
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m_row[i] - mx[i]) * kLog2e);
      m_row[i] = mx[i];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f((s[nt][e] - m_row[e >> 1]) * kLog2e);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * corr[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += bf16(P) V: two n8 tiles of S make one k16 A fragment
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDt; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sVs + (kk * 16 + (j & 1) * 8 + r8) * kStride +
                                 (dt + (j >> 1)) * 8);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage read here is the next iteration's target
  }

  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[i] = fmaxf(l, 1e-30f);
  }
  bf16* og = o + t.b * p.ob + t.h * p.oh;
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt) {
    const int col = dt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      if (row < p.S)
        *reinterpret_cast<uint32_t*>(og + row * p.os + col) =
            pack_bf16(acc[dt][2 * i] / denom[i], acc[dt][2 * i + 1] / denom[i]);
    }
  }
}

template <int D>
constexpr int smem_bytes_f32() {
  // Q tile (rows padded by one word: conflict-free per-thread rows) + K + V
  return (kF32Rows * (D + 1) + 2 * kF32Keys * D) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kF32Rows)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kF32Rows * (D + 1);
  float* sV = sK + kF32Keys * D;

  const Tile t = tile_of(p, kF32Rows);
  const float* qg = q + t.b * p.qb + t.h * p.qh;
  const float* kg = k + t.b * p.kb + t.kvh * p.kh;
  const float* vg = v + t.b * p.vb + t.kvh * p.vh;
  const int tid = threadIdx.x;
  const int qpos = t.q0 + tid;

  for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] = t.q0 + r < p.S ? qg[(t.q0 + r) * p.qs + c] : 0.0f;
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const float* qrow = sQ + tid * (D + 1);

  for (int k0 = 0; k0 < t.kv_end; k0 += kF32Keys) {
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    for (int i = tid; i < kF32Keys * D; i += kF32Rows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.T;
      sK[i] = ok ? kg[(k0 + r) * p.ks + c] : 0.0f;
      sV[i] = ok ? vg[(k0 + r) * p.vs + c] : 0.0f;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      float dot = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], sK[jj * D + c], dot);
      const int kpos = k0 + jj;
      const bool ok = kpos < p.T && (!p.causal || kpos <= qpos);
      s[jj] = ok ? dot * p.scale : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      s[jj] = expf(s[jj] - m);
      rs += s[jj];
    }
    l = l * corr + rs;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float a = acc[c] * corr;
#pragma unroll
      for (int jj = 0; jj < kF32Keys; ++jj) a = fmaf(s[jj], sV[jj * D + c], a);
      acc[c] = a;
    }
  }
  if (qpos < p.S) {
    float* orow = o + t.b * p.ob + t.h * p.oh + qpos * p.os;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] / denom;
  }
}


// ------------------------------------------------------------------------
// bf16 wgmma kernel (Hopper): TMA ring, warp-specialised producer, two
// consumer warpgroups
constexpr int kWgRows = 128;     // query rows per CTA, 64 per consumer
constexpr int kWgKeys = 128;     // keys per K/V tile
constexpr int kWgThreads = 384;  // producer + 2 consumer warpgroups
// one 64-column half of a 128-row tile: 128 rows of 128 bytes, the width
// of the 128-byte swizzle; a D = 128 tile is two halves side by side
constexpr int kHalfBytes = 128 * 128;
// ring stages: 64 KB of K and V a stage at D = 128 (3 stages and Q fill
// 224 KB of the 227 KB a block may have), 32 KB at D = 64
constexpr int kWgStages128 = 3;
constexpr int kWgStages64 = 4;

template <int D, int kStages>
struct WgLayout {
  static constexpr int kTile = D / 64 * kHalfBytes;  // Q, or K or V
  static constexpr int kK = kTile;                    // + 2 kTile a stage
  static constexpr int kV = 2 * kTile;                // + 2 kTile a stage
  static constexpr int kBars = (1 + 2 * kStages) * kTile;
  // full_k[kStages], full_v[kStages], empty[kStages], q; and the slack
  // that aligns the base to the 1024-byte swizzle pattern
  static constexpr int kBytes = kBars + 8 * (3 * kStages + 1) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address >> 4 (bits 0-13), leading byte offset >> 4 (16-29), stride byte
// offset >> 4 (32-45; 1024 bytes between groups of 8 rows), swizzle mode
// 1 = 128B (62-63). The tile's base is 1024-byte aligned, so the base
// offset (49-51) is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// named barriers 1 and 2: the consumer warpgroups' turns to issue
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (m64n128, f32) (+)= a (smem, K-major) * b (smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n128, f32) += a (registers) * b (smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (m64n64, f32) += a (registers) * b (smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(acc, a, db, 1);
  else
    wgmma_rs_n64(acc, a, db, 1);
}

// S = Q K^T for one consumer's 64 rows: D / 16 steps of k16, each 32
// bytes further into the 128-byte swizzled rows (the hardware swizzles
// the absolute address, so the step is a plain offset), the next 64
// columns in the next half
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
  keep(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t off = (j >> 2) * kHalfBytes + (j & 3) * 32;
    wgmma_ss_n128(s, sw128_desc(q_rows + off, 16),
                  sw128_desc(k_tile + off, 16), j);
  }
  wgmma_commit();
}

// O += P V: k16 steps of 16 keys (2048 bytes of V each); V is MN-major,
// its next 64 columns one half (kHalfBytes) further: the leading offset
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pf)[kWgKeys / 16][4],
                                         uint32_t v_tile) {
  keep(acc);
  keep(pf);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk)
    wgmma_pv<D>(acc, pf[kk], sw128_desc(v_tile + kk * 2048, kHalfBytes));
  wgmma_commit();
}

// One tile's scores: masked, the running max (log2 domain) updated, s
// becomes p = 2^(s sl2 - m) (f32, one FFMA and one ex2 an element),
// `corr` the factor by which the earlier sums shrink, `rs` this thread's
// share of the tile's row sums. Element e of n8 block j sits at row
// row0 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of the tile
// (wgmma's accumulator layout). Every row sees key 0 in its first tile,
// so m is a real score from then on and a masked -1e30 gives p = 0.
__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m_row)[2], float (&corr)[2], float (&rs)[2],
    int k0, bool masked, int T, bool causal, int row0, int lane, float sl2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int qpos = row0 + (e >> 1) * 8;
        if (kpos >= T || (causal && kpos > qpos)) s[4 * j + e] = kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_row[i], mx[i] * sl2);
    corr[i] = ex2(m_row[i] - m_new);
    m_row[i] = m_new;
    rs[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -m_row[e >> 1]));
      rs[e >> 1] += s[4 * j + e];
    }
  }
}

// p (f32, S's accumulator layout) -> bf16 A fragments of P V: the n8
// blocks 2 kk and 2 kk + 1 of S make k16 step kk of A
__device__ __forceinline__ void p_to_bf16(const float (&s)[64],
                                          uint32_t (&pf)[kWgKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, const Params p) {
  using L = WgLayout<D, kStages>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t bars = base + L::kBars;
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * kStages + st); };
  const uint32_t bar_q = bars + 8 * 3 * kStages;
  auto k_tile = [&](int st) { return base + L::kK + st * 2 * L::kTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * 2 * L::kTile; };

  const Tile t = tile_of(p, kWgRows);
  const int n_kt = (t.kv_end + kWgKeys - 1) / kWgKeys;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);  // one arrival from each consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf)
        tma_load(base + hf * kHalfBytes, &tq, bar_q, 64 * hf, t.h, t.q0,
                 t.b);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        // the consumers released this stage's previous tile
        if (kt >= kStages) mbar_wait(empty(st), phase ^ 1);
        mbar_expect_tx(full_k(st), L::kTile);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf)
          tma_load(k_tile(st) + hf * kHalfBytes, &tk, full_k(st), 64 * hf,
                   t.kvh, kt * kWgKeys, t.b);
        mbar_expect_tx(full_v(st), L::kTile);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf)
          tma_load(v_tile(st) + hf * kHalfBytes, &tv, full_v(st), 64 * hf,
                   t.kvh, kt * kWgKeys, t.b);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup, 16 per warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int first_row = t.q0 + cw * 64;
    const int row0 = first_row + warp * 16 + (lane >> 2);
    const uint32_t q_rows = base + cw * 64 * 128;
    const float sl2 = p.scale * kLog2e;
    const bool causal = p.causal != 0;
    // only tiles that cross this warpgroup's diagonal or the edge T mask
    auto masked = [&](int k0) {
      return k0 + kWgKeys > p.T || (causal && k0 + kWgKeys - 1 > first_row);
    };

    float s[64];
    uint32_t pf[kWgKeys / 16][4];
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_row[2] = {kNegInf, kNegInf};
    float l_row[2] = {0.0f, 0.0f};  // this thread's columns until the end
    float corr[2], rs[2];
    // The two consumers take turns to issue their wgmmas, so one's
    // softmax runs while the tensor cores work for the other: consumer
    // c waits on barrier 1 + c, then lets the other go (its last turn
    // has no one left to pass to). Consumer 0 goes first.
    const int n_turns = n_kt + 1;
    int turn = 0;
    auto take_turn = [&] { bar_sync(1 + cw, 256); };
    auto pass_turn = [&] {
      if (++turn < n_turns || cw == 0) bar_arrive(2 - cw, 256);
    };
    if (cw == 1) bar_arrive(1, 256);

    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    take_turn();
    issue_qk<D>(s, q_rows, k_tile(0));
    pass_turn();
    wgmma_wait<0>();
    keep(s);
    online_softmax(s, m_row, corr, rs, 0, masked(0), p.T, causal, row0,
                   lane, sl2);
    l_row[0] = rs[0];
    l_row[1] = rs[1];
    p_to_bf16(s, pf);

    int st = 0;
    uint32_t phase = 0;
    for (int kt = 1; kt < n_kt; ++kt) {
      const int prev = st;
      const uint32_t prev_phase = phase;
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
      // the next scores, then the previous tile's P V, both in flight
      mbar_wait(full_k(st), phase);
      take_turn();
      issue_qk<D>(s, q_rows, k_tile(st));
      mbar_wait(full_v(prev), prev_phase);
      issue_pv<D>(acc, pf, v_tile(prev));
      pass_turn();
      wgmma_wait<1>();  // the scores are in
      keep(s);
      const int k0 = kt * kWgKeys;
      online_softmax(s, m_row, corr, rs, k0, masked(k0), p.T, causal, row0,
                     lane, sl2);
      wgmma_wait<0>();  // P V is in: its stage is free, O may be rescaled
      keep(acc);
      if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      l_row[0] = l_row[0] * corr[0] + rs[0];
      l_row[1] = l_row[1] * corr[1] + rs[1];
      p_to_bf16(s, pf);
    }
    mbar_wait(full_v(st), phase);
    take_turn();
    issue_pv<D>(acc, pf, v_tile(st));
    pass_turn();
    wgmma_wait<0>();
    keep(acc);

    float denom[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_row[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[i] = fmaxf(l, 1e-30f);
    }
    bf16* og = o + t.b * p.ob + t.h * p.oh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + i * 8;
        if (row < p.S)
          *reinterpret_cast<uint32_t*>(og + row * p.os + col) =
              pack_bf16(acc[4 * j + 2 * i] / denom[i],
                        acc[4 * j + 2 * i + 1] / denom[i]);
      }
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((p.S + kBlockM - 1) / kBlockM) * p.B * p.H;
  flash_bf16_kernel<D><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((p.S + kF32Rows - 1) / kF32Rows) * p.B * p.H;
  flash_f32_kernel<D><<<(unsigned int)blocks, kF32Rows, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}


// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library links against nothing but the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// 0, or the cudaError of the lookup (cudaErrorSymbolNotFound when the
// driver has no such entry point)
int encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *fn = cached;
  return 0;
}

// [B, len, heads, D] bf16 from its strides (elements) as a 4-D map
// (D, heads, len, B); boxes of 64 columns x 1 head x 128 rows x 1 batch
CUresult make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                  int64_t B, int64_t len, int64_t heads, int64_t D,
                  int64_t sb, int64_t sl, int64_t sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, kWgRows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 0; a cudaError (> 0) of the lookup or the launch; or -CUresult of a
// tensor map the driver refused
template <int D, int kStages>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Params& p, cudaStream_t stream) {
  EncodeTiledFn encode;
  const int looked_up = encode_tiled(&encode);
  if (looked_up != 0) return looked_up;
  CUtensorMap tq, tk, tv;
  CUresult res = make_map(encode, &tq, q, p.B, p.S, p.H, D, p.qb, p.qs, p.qh);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tk, k, p.B, p.T, p.Kh, D, p.kb, p.ks, p.kh);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tv, v, p.B, p.T, p.Kh, D, p.vb, p.vs, p.vh);
  if (res != CUDA_SUCCESS) return -(int)res;
  constexpr int smem = WgLayout<D, kStages>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((p.S + kWgRows - 1) / kWgRows) * p.B * p.H;
  flash_wgmma_kernel<D, kStages>
      <<<(unsigned int)blocks, kWgThreads, smem, stream>>>(tq, tk, tv,
                                                           (bf16*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, [b, s|t, h] for each of q, k, v, o.

// The mma.sync (bf16: D 16, 32 and the yardstick's 128) and CUDA-core
// (f32) kernels. dtype: 0 = bf16, 1 = f32. Returns cudaErrorInvalidValue
// for a dtype or head dim the kernels do not take (the wrapper rejects
// those first).
extern "C" int d3_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t S, int64_t T, int64_t H, int64_t Kh, int64_t D, int64_t qb,
    int64_t qs, int64_t qh, int64_t kb, int64_t ks, int64_t kh, int64_t vb,
    int64_t vs, int64_t vh, int64_t ob, int64_t os, int64_t oh,
    int64_t causal, float scale, int64_t dtype, void* stream) {
  const Params p = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh,
                    (int)B, (int)S, (int)T, (int)H, (int)Kh, (int)causal,
                    scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_bf16<16>(q, k, v, o, p, s);
      case 32: return launch_bf16<32>(q, k, v, o, p, s);
      case 128: return launch_bf16<128>(q, k, v, o, p, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_f32<16>(q, k, v, o, p, s);
      case 32: return launch_f32<32>(q, k, v, o, p, s);
      case 64: return launch_f32<64>(q, k, v, o, p, s);
      case 128: return launch_f32<128>(q, k, v, o, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The wgmma kernel, bf16 at D = 64 or 128. Returns 0, a cudaError (> 0),
// or -CUresult when the driver refuses a tensor map.
extern "C" int d3_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t S, int64_t T, int64_t H, int64_t Kh, int64_t D, int64_t qb,
    int64_t qs, int64_t qh, int64_t kb, int64_t ks, int64_t kh, int64_t vb,
    int64_t vs, int64_t vh, int64_t ob, int64_t os, int64_t oh,
    int64_t causal, float scale, void* stream) {
  const Params p = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh,
                    (int)B, (int)S, (int)T, (int)H, (int)Kh, (int)causal,
                    scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_wgmma<64, kWgStages64>(q, k, v, o, p, s);
    case 128: return launch_wgmma<128, kWgStages128>(q, k, v, o, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The wgmma kernel's dynamic shared memory at head dim D (0 if none).
extern "C" int d3_flash_attention_wgmma_smem(int64_t D) {
  switch (D) {
    case 64: return WgLayout<64, kWgStages64>::kBytes;
    case 128: return WgLayout<128, kWgStages128>::kBytes;
  }
  return 0;
}
