// Flash attention for the LM prefill path (sm_90a).
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
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py:73
// flash_attention_kernel (body _kernel) together with the GQA folding of
// its wrapper ops.py:flash_attention:
//
//   o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, kh] * scale) v[b, t, kh]
//   kh = h / (H / Kh),  scale = 1 / sqrt(D),
//   causal: key t is visible to query s iff t <= s (both from 0).
//
// It reads q [B,S,H,D] and k/v [B,T,Kh,D] in place from their strides (the
// last dimension contiguous): nothing is transposed and the KV broadcast
// over the G = H / Kh query heads of a group is never materialised.
// Arithmetic follows kernel.py: scores and the running max / sum / output
// accumulator are f32, masked scores are -1e30, p = exp(s - m) is cast to
// v's type before p @ v, and the output is acc / max(l, 1e-30) in q's type.
//
// bf16 (the model's type): one CTA of 4 warps per (batch, head, 64-query
// tile); each warp owns 16 query rows. The Q tile is loaded once; K and V
// tiles of 64 keys go through shared memory in a two-stage cp.async ring,
// so the next tile's load overlaps this tile's math. S = Q K^T and O += P V
// run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate),
// with fragments read by ldmatrix (V transposed on the fly). S's
// accumulator layout is reused as P's A-operand layout, so P never touches
// shared memory. Shared rows are padded by 16 bytes, which makes every
// ldmatrix phase conflict-free. Causal tiles entirely above the diagonal
// are never visited; only tiles that cross the diagonal or the ragged key
// edge T are masked. Rows past the ragged query edge S read zeros and are
// not stored. CTAs launch heaviest causal tile first, and the heads of
// one KV group are adjacent in launch order, so they share K/V in L2.
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
// 3.35 TB/s: the operations bound it. The exponentials (S^2 H / 2 = 1.7e10
// on the SFUs) stay below the matmuls. wgmma, TMA and warp specialisation,
// which the full tensor-core rate needs, are later work.
// ---------------------------------------------------------------------
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

}  // namespace

// dtype: 0 = bf16, 1 = f32. Strides are in elements, [b, s|t, h] for each
// of q, k, v, o. Returns cudaErrorInvalidValue for a dtype or head dim the
// kernels do not take (the wrapper rejects those first).
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
      case 64: return launch_bf16<64>(q, k, v, o, p, s);
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
