// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The gradient of csrc/flash_attention.cu's prefill: what autodiff through
// the JAX package's src/repro/models/attention.py:132 chunked_attention
// computes (the JAX package has no backward Pallas kernel: XLA
// differentiates its XLA loop, and the Pallas kernel of
// src/repro/kernels/flash_attention.py:81 has no gradient).  With
// qf = round(q * scale) (scale rounded to q's dtype, as the forward), the
// scores S = qf K^T in float32, P = exp(S - lse) from the forward's per-row
// log-sum-exp, O the forward's output and dO the output's gradient:
//
//   Delta = rowsum(dO * O)                        (float32)
//   dP    = dO V^T,  dS = P * (dP - Delta)        (float32)
//   dq    = round(scale * dS K)                   (float32 sums, one rounding)
//   dk    = round(dS^T qf),  dv = round(round_kv(P)^T dO)
//
// P is rounded to the kv dtype before its product with dO, as the forward
// rounds it before P V; dS is rounded to bf16 as the operand of the bf16
// products.  The causal mask is aligned top-left (q_offset = 0, the training
// forward) and applied before the exp; keys past T and rows past R = S * Gl
// contribute nothing.  GQA: the Gl q heads of kv head kr are the rows
// r = s * Gl + g of one (b, kr), so dk and dv sum over the group inside one
// block, with no atomics.
//
// Two launches per call, deterministic:
// 1. flash_bwd_dq: one block per (64-row q tile, kr, b).  It computes Delta
//    for its rows (written to a float32 buffer for launch 2) and walks the
//    visible kv tiles, recomputing S and P, accumulating dq in registers.
// 2. flash_bwd_dkdv: one block per (64-key kv tile, kr, b).  It walks every
//    q row of the group that can see its keys (from t0 * Gl on when causal)
//    and accumulates dk and dv in registers.
//
// What bounds it on an H100: operations.  Per visible (row, key) pair the
// backward recomputes S (2D flops), forms dP (2D) and three products (dq,
// dk, dv: 6D): 10D, two and a half times the forward's 4D; at B4 S2048 H16
// D64 causal that is 85.9 GFLOP, 0.087 ms at 989 TFLOP/s bf16 (134 MB read
// and written once: 0.040 ms at 3.35 TB/s).  bf16 runs every product on the
// tensor cores with mma.sync m16n8k16 (float32 accumulation; P and dS go
// from the accumulator to the A operand in registers, the layout FA2 uses);
// float32 runs on the CUDA cores, as prefill_f32 does.  Loads are plain
// synchronous tile loads, with no pipelining: wgmma, TMA and a pipelined
// ring are for a later speed PR.
//
// Layouts are contiguous: q, o, do, dq (B,S,KR,Gl,D); k, v, dk, dv
// (B,T,KR,D); lse and delta (B,KR,R) float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, KR, Gl, T, R;
  int causal;
  float scale;  // 1/sqrt(D), already rounded to q's dtype
};

__device__ __forceinline__ long long q_off(const Bwd& p, int b, int kr, int r, int D) {
  return ((((long long)b * p.S + r / p.Gl) * p.KR + kr) * p.Gl + r % p.Gl) * D;
}

__device__ __forceinline__ long long kv_off(const Bwd& p, int b, int kr, int t, int D) {
  return (((long long)b * p.T + t) * p.KR + kr) * D;
}

__device__ __forceinline__ long long row_off(const Bwd& p, int b, int kr, int r) {
  return ((long long)b * p.KR + kr) * p.R + r;
}

// row r (position r / Gl) sees key t
__device__ __forceinline__ bool visible(const Bwd& p, int r, int t) {
  return r < p.R && t < p.T && (!p.causal || t <= r / p.Gl);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Fragments (g = lane / 4, t = lane % 4).  A (16 x 16, row-major): a0 (g,
// 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..).  B (16 x 8):
// b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).  C (16 x 8): c0, c1 (g, 2t..),
// c2, c3 (g+8, 2t..).

// A from a row-major tile X (k contiguous): rows m0.., k-step kk
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* X, int m0, int kk,
                                       int g, int t) {
  const __nv_bfloat16* base = X + (m0 + g) * LD + 16 * kk + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LD);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LD + 8);
}

// B[k][n] = Y[n][k] for a row-major Y (k contiguous): n-tile nn, k-step kk
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* Y,
                                          int nn, int kk, int g, int t) {
  const __nv_bfloat16* base = Y + (8 * nn + g) * LD + 16 * kk + 2 * t;
  b0 = ld32(base);
  b1 = ld32(base + 8);
}

// B[k][n] = Y[k][n] for a row-major Y (n contiguous): n-tile nn, k-step kk
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* Y,
                                          int nn, int kk, int g, int t) {
  const __nv_bfloat16* base = Y + (16 * kk + 2 * t) * LD + 8 * nn + g;
  b0 = pack_raw(base[0], base[LD]);
  b1 = pack_raw(base[8 * LD], base[9 * LD]);
}

// A from two accumulator n-tiles (keys or rows 16kk..16kk+15), rounded to bf16
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows [r0, r0 + ROWS) of q (scaled and rounded to bf16) and of dO into
// shared tiles of pitch LD; rows past R are zeros
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_q_rows(const Bwd& p, int b, int kr, int r0,
                                            __nv_bfloat16* sQ, __nv_bfloat16* sDO) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kThreads) {
    const int row = idx / CPR, c = idx % CPR, r = r0 + row;
    uint4 qraw = make_uint4(0u, 0u, 0u, 0u), draw = qraw;
    if (r < p.R) {
      const long long off = q_off(p, b, kr, r, D) + 8 * c;
      qraw = *reinterpret_cast<const uint4*>(q + off);
      draw = *reinterpret_cast<const uint4*>(dout + off);
    }
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&qraw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      h2[i] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
    }
    *reinterpret_cast<uint4*>(sQ + row * LD + 8 * c) = qraw;
    *reinterpret_cast<uint4*>(sDO + row * LD + 8 * c) = draw;
  }
}

// keys [t0, t0 + 64) of k and v into shared tiles of pitch LD; keys past T
// are zeros
template <int D, int LD>
__device__ __forceinline__ void load_kv_rows(const Bwd& p, int b, int kr, int t0,
                                             __nv_bfloat16* sK, __nv_bfloat16* sV) {
  constexpr int CPR = D / 8;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += kThreads) {
    const int row = idx / CPR, c = idx % CPR, t = t0 + row;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
    if (t < p.T) {
      const long long off = kv_off(p, b, kr, t, D) + 8 * c;
      kraw = *reinterpret_cast<const uint4*>(k + off);
      vraw = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(sK + row * LD + 8 * c) = kraw;
    *reinterpret_cast<uint4*>(sV + row * LD + 8 * c) = vraw;
  }
}

template <int D>
struct TcCfg {
  static constexpr int LD = D + 8;              // pitch in bf16: conflict-free fragments
  static constexpr int BQ = D <= 64 ? 64 : 32;  // q rows per step of flash_bwd_dkdv
  static constexpr size_t DQ_SMEM = 4 * 64 * LD * 2 + 2 * 64 * 4;
  static constexpr size_t DKDV_SMEM = 2 * 64 * LD * 2 + 2 * BQ * LD * 2 + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(const Bwd p) {
  using C = TcCfg<D>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = sQ + 64 * LD;
  __nv_bfloat16* sK = sDO + 64 * LD;
  __nv_bfloat16* sV = sK + 64 * LD;
  float* sLse = reinterpret_cast<float*>(sV + 64 * LD);
  float* sDelta = sLse + 64;

  const int r0 = blockIdx.x * 64, kr = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  load_q_rows<D, LD, 64>(p, b, kr, r0, sQ, sDO);
  {  // Delta = rowsum(dO * O): two threads per row, each half of D
    const int row = threadIdx.x / 2, half = threadIdx.x % 2, r = r0 + row;
    float acc = 0.f;
    if (r < p.R) {
      const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + q_off(p, b, kr, r, D);
      const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + q_off(p, b, kr, r, D);
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); d += 2) {
        const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + d));
        const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + d));
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDelta[row] = acc;
      sLse[row] = r < p.R ? p.lse[row_off(p, b, kr, r)] : 0.f;
      if (r < p.R) p.delta[row_off(p, b, kr, r)] = acc;
    }
  }

  const int m0 = warp * 16;
  const int ra = r0 + m0 + g, rb = ra + 8;  // this thread's two rows
  const int r_last = min(r0 + 64, p.R) - 1;
  const int kv_stop = p.causal ? min(p.T, r_last / p.Gl + 1) : p.T;
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t0 = 0; t0 < kv_stop; t0 += 64) {
    __syncthreads();  // q tiles, Delta and lse are in; the last tile's reads are done
    load_kv_rows<D, LD>(p, b, kr, t0, sK, sV);
    __syncthreads();
    const float lse_a = sLse[m0 + g], lse_b = sLse[m0 + g + 8];
    const float dl_a = sDelta[m0 + g], dl_b = sDelta[m0 + g + 8];
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a<LD>(aq, sQ, m0, kk, g, t);
      frag_a<LD>(ado, sDO, m0, kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sK, n, kk, g, t);
        mma_bf16(s[n], aq, b0, b1);
        frag_b_nk<LD>(b0, b1, sV, n, kk, g, t);
        mma_bf16(dp[n], ado, b0, b1);
      }
    }
    // dS = P * (dP - Delta), P = exp(S - lse), masked before the exp
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * n + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const float pr = visible(p, hi ? rb : ra, key)
                             ? exp2f((s[n][e] - (hi ? lse_b : lse_a)) * kLog2e) : 0.f;
        s[n][e] = pr * (dp[n][e] - (hi ? dl_b : dl_a));
      }
    // dq += dS K: K as B with keys along k (strided pairs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sK, n, kk, g, t);
        mma_bf16(dq[n], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i == 0 ? ra : rb;
    if (r >= p.R) continue;
    __nv_bfloat16* row = dqp + q_off(p, b, kr, r, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) = __floats2bfloat162_rn(
          dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_bf16(const Bwd p) {
  using C = TcCfg<D>;
  constexpr int LD = C::LD, BQ = C::BQ;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + 64 * LD;
  __nv_bfloat16* sQ = sV + 64 * LD;
  __nv_bfloat16* sDO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sDO + BQ * LD);
  float* sDelta = sLse + BQ;

  const int t0 = blockIdx.x * 64, kr = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  load_kv_rows<D, LD>(p, b, kr, t0, sK, sV);
  const int m0 = warp * 16;
  const int ka = t0 + m0 + g, kb = ka + 8;  // this thread's two keys
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the rows that see key t0 and later: r / Gl >= t0 when causal
  const int r_begin = p.causal ? (int)((long long)t0 * p.Gl / BQ * BQ) : 0;
  for (int r0 = r_begin; r0 < p.R; r0 += BQ) {
    __syncthreads();  // the last step's reads are done (and K, V are in)
    load_q_rows<D, LD, BQ>(p, b, kr, r0, sQ, sDO);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int r = r0 + i;
      sLse[i] = r < p.R ? p.lse[row_off(p, b, kr, r)] : 0.f;
      sDelta[i] = r < p.R ? p.delta[row_off(p, b, kr, r)] : 0.f;
    }
    __syncthreads();
    // S^T = K qf^T and dP^T = V dO^T: keys along m, rows along n
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, sK, m0, kk, g, t);
      frag_a<LD>(av, sV, m0, kk, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sQ, n, kk, g, t);
        mma_bf16(s[n], ak, b0, b1);
        frag_b_nk<LD>(b0, b1, sDO, n, kk, g, t);
        mma_bf16(dp[n], av, b0, b1);
      }
    }
    // P^T in s, dS^T in dp
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t + (e & 1);
        const float pr = visible(p, r0 + i, e >= 2 ? kb : ka)
                             ? exp2f((s[n][e] - sLse[i]) * kLog2e) : 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - sDelta[i]);
      }
    // dv += round(P^T) dO and dk += dS^T qf: rows along k (strided pairs)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      frag_a_acc(ap, s[2 * kk], s[2 * kk + 1]);
      frag_a_acc(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sDO, n, kk, g, t);
        mma_bf16(dv[n], ap, b0, b1);
        frag_b_kn<LD>(b0, b1, sQ, n, kk, g, t);
        mma_bf16(dk[n], ads, b0, b1);
      }
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i == 0 ? ka : kb;
    if (key >= p.T) continue;
    const long long off = kv_off(p, b, kr, key, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------------
// float32: CUDA cores.  NP = D / 32 threads share a row (or key), 32
// columns each; each thread walks its columns rotated by its part, so the
// parts of one row read different banks.
// ---------------------------------------------------------------------------------

constexpr int kF32Tile = 32;  // keys (dq) or q rows (dkdv) staged per step

template <int NP>
__device__ __forceinline__ float part_sum(float x) {
#pragma unroll
  for (int m = 1; m < NP; m *= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(const Bwd p) {
  constexpr int NP = D / 32, RB = kThreads / NP;  // rows per block
  extern __shared__ float fsm[];
  float* sK = fsm;                  // kF32Tile x D
  float* sV = sK + kF32Tile * D;
  const int part = threadIdx.x % NP, r = blockIdx.x * RB + threadIdx.x / NP;
  const int kr = blockIdx.y, b = blockIdx.z;
  const bool live = r < p.R;
  const float* q = static_cast<const float*>(p.q);
  const float* o = static_cast<const float*>(p.o);
  const float* dout = static_cast<const float*>(p.dout);
  const long long qo = live ? q_off(p, b, kr, r, D) : 0;

  float qf[32], dor[32], acc[32];
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = part * 32 + ((c + part) & 31);
    qf[c] = live ? q[qo + col] * p.scale : 0.f;
    dor[c] = live ? dout[qo + col] : 0.f;
    delta = fmaf(dor[c], live ? o[qo + col] : 0.f, delta);
    acc[c] = 0.f;
  }
  delta = part_sum<NP>(delta);
  const float lse = live ? p.lse[row_off(p, b, kr, r)] : 0.f;
  if (live && part == 0) p.delta[row_off(p, b, kr, r)] = delta;

  const int r_last = min((int)(blockIdx.x + 1) * RB, p.R) - 1;
  const int kv_stop = p.causal ? min(p.T, r_last / p.Gl + 1) : p.T;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  for (int t0 = 0; t0 < kv_stop; t0 += kF32Tile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Tile * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, key = t0 + j;
      sK[idx] = key < p.T ? k[kv_off(p, b, kr, key, D) + d] : 0.f;
      sV[idx] = key < p.T ? v[kv_off(p, b, kr, key, D) + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile && t0 + j < kv_stop; ++j) {
      const float* kj = sK + j * D + part * 32;
      const float* vj = sV + j * D + part * 32;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        s = fmaf(qf[c], kj[(c + part) & 31], s);
        dp = fmaf(dor[c], vj[(c + part) & 31], dp);
      }
      s = part_sum<NP>(s);
      dp = part_sum<NP>(dp);
      const float ds = visible(p, r, t0 + j) ? expf(s - lse) * (dp - delta) : 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(ds, kj[(c + part) & 31], acc[c]);
    }
  }
  if (!live) return;
  float* dq = static_cast<float*>(p.dq) + qo;
#pragma unroll
  for (int c = 0; c < 32; ++c) dq[part * 32 + ((c + part) & 31)] = acc[c] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32(const Bwd p) {
  constexpr int NP = D / 32, KB = kThreads / NP;  // keys per block
  extern __shared__ float fsm[];
  float* sQ = fsm;                  // kF32Tile x D, scaled
  float* sDO = sQ + kF32Tile * D;
  float* sLse = sDO + kF32Tile * D;
  float* sDelta = sLse + kF32Tile;
  const int part = threadIdx.x % NP, t0 = blockIdx.x * KB, key = t0 + threadIdx.x / NP;
  const int kr = blockIdx.y, b = blockIdx.z;
  const bool live = key < p.T;
  const long long ko = live ? kv_off(p, b, kr, key, D) : 0;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float kk[32], vv[32], dk[32], dv[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = part * 32 + ((c + part) & 31);
    kk[c] = live ? k[ko + col] : 0.f;
    vv[c] = live ? v[ko + col] : 0.f;
    dk[c] = dv[c] = 0.f;
  }
  const float* q = static_cast<const float*>(p.q);
  const float* dout = static_cast<const float*>(p.dout);
  const int r_begin = p.causal ? (int)((long long)t0 * p.Gl / kF32Tile * kF32Tile) : 0;
  for (int r0 = r_begin; r0 < p.R; r0 += kF32Tile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Tile * D; idx += kThreads) {
      const int i = idx / D, d = idx % D, r = r0 + i;
      sQ[idx] = r < p.R ? q[q_off(p, b, kr, r, D) + d] * p.scale : 0.f;
      sDO[idx] = r < p.R ? dout[q_off(p, b, kr, r, D) + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32Tile; i += kThreads) {
      const int r = r0 + i;
      sLse[i] = r < p.R ? p.lse[row_off(p, b, kr, r)] : 0.f;
      sDelta[i] = r < p.R ? p.delta[row_off(p, b, kr, r)] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kF32Tile && r0 + i < p.R; ++i) {
      const float* qi = sQ + i * D + part * 32;
      const float* di = sDO + i * D + part * 32;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        s = fmaf(kk[c], qi[(c + part) & 31], s);
        dp = fmaf(vv[c], di[(c + part) & 31], dp);
      }
      s = part_sum<NP>(s);
      dp = part_sum<NP>(dp);
      const float pr = visible(p, r0 + i, key) ? expf(s - sLse[i]) : 0.f;
      const float ds = pr * (dp - sDelta[i]);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        dv[c] = fmaf(pr, di[(c + part) & 31], dv[c]);
        dk[c] = fmaf(ds, qi[(c + part) & 31], dk[c]);
      }
    }
  }
  if (!live) return;
  float* dkp = static_cast<float*>(p.dk) + ko;
  float* dvp = static_cast<float*>(p.dv) + ko;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = part * 32 + ((c + part) & 31);
    dkp[col] = dk[c];
    dvp[col] = dv[c];
  }
}

// ---------------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------------

template <int D>
cudaError_t run_bf16(const Bwd& p, cudaStream_t stream) {
  using C = TcCfg<D>;
  static bool ready_dq[kMaxDevices], ready_dkdv[kMaxDevices];
  cudaError_t err = allow_smem(flash_bwd_dq_bf16<D>, C::DQ_SMEM, ready_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_bf16<D>, C::DKDV_SMEM, ready_dkdv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16<D><<<dim3((p.R + 63) / 64, p.KR, p.B), kThreads, C::DQ_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_bf16<D><<<dim3((p.T + 63) / 64, p.KR, p.B), kThreads, C::DKDV_SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const Bwd& p, cudaStream_t stream) {
  constexpr int NP = D / 32;
  constexpr size_t dq_smem = 2 * kF32Tile * D * sizeof(float);
  constexpr size_t dkdv_smem = (2 * kF32Tile * D + 2 * kF32Tile) * sizeof(float);
  static_assert(dq_smem <= 48 * 1024 && dkdv_smem <= 48 * 1024, "static shared memory limit");
  const int rows = kThreads / NP;
  flash_bwd_dq_f32<D><<<dim3((p.R + rows - 1) / rows, p.KR, p.B), kThreads, dq_smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32<D><<<dim3((p.T + rows - 1) / rows, p.KR, p.B), kThreads, dkdv_smem,
                          stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv all of it).
// Contiguous q, o, do, dq (B,S,KR,Gl,D); k, v, dk, dv (B,T,KR,D); lse from
// the forward and ``delta`` (scratch, written by the first launch) float32
// (B,KR,S*Gl).  Causal masks are aligned top-left (q_offset = 0), every key
// below T is valid.  Two launches on ``stream``; returns a cudaError_t value
// (0 on success), cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int S, int KR, int Gl, int T, int D, int causal, float scale,
    void* stream) {
  Bwd p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.S = S; p.KR = KR; p.Gl = Gl; p.T = T; p.R = S * Gl;
  p.causal = causal;
  p.scale = scale;
  if (B < 1 || S < 1 || KR < 1 || Gl < 1 || T < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return run_bf16<32>(p, st);
      case 64: return run_bf16<64>(p, st);
      case 128: return run_bf16<128>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return run_f32<32>(p, st);
      case 64: return run_f32<64>(p, st);
      case 128: return run_f32<128>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
