// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention.py:81 flash_attention (body _attn_kernel
// at :29) and, on the model path, the XLA online-softmax loop it stands in
// for, src/repro/models/attention.py:132 chunked_attention.  It computes what
// chunked_attention computes: q is scaled and rounded to its dtype, scores
// and the running max/denominator are float32, p is rounded to the kv dtype
// before the PV product while l sums the unrounded p, and the output is
// acc / max(l, 1e-20) rounded once.  The causal mask is aligned by q_offset
// (row r sees keys <= q_offset + r / Gl), keys at or past kv_len are masked,
// and masked scores are -1e9, as in the reference.
//
// For training, the two prefill variants also write each q row's
// log-sum-exp m + log(l) (float32, in the units of the scaled scores) when
// given a pointer for it; flash_attention_bwd.cu's backward reads it.  A
// null pointer costs one branch per row at the end.
//
// Layouts are strided, so one kernel serves the model layout
// q (B,S,KR,Gl,D), k/v (B,T,KR,D) and the reference layout q (B,Hq,S,D),
// k/v (B,Hkv,T,D) viewed as (B,S,Hkv,group,D): GQA reads kv head kr once for
// all Gl q heads of its group (rows r = s * Gl + g), with no copy of kv.
//
// Three variants; the wrapper's plan() picks one from shapes and dtypes
// before the launch (R = S * Gl q rows per (batch row, kv head)):
//
// 1. flash_wgmma (bf16 q and kv, R > 16): prefill on the tensor cores.  Bound
//    by operations (4 * D per visible (row, key) pair; causal halves them).
//    A block of three warpgroups owns 128 q rows (BQ): warpgroup 0 is the
//    producer, whose one thread keeps a ring of 3 K/V stages full with TMA
//    loads (full/empty mbarriers), so loads overlap the products; warpgroups
//    1 and 2 each own 64 q rows, and setmaxnreg moves registers to them
//    (24 for the producer, 240 for each consumer).  Consumers load their q
//    tile once with 16-byte loads, scale and round it to bf16 and store it in
//    the swizzled layout wgmma reads (not by TMA: rows s * Gl + g straddle
//    (s, g), and Gl = 3 does not divide 64).  S = Q K^T is an smem x smem
//    wgmma (K is K-major as stored); the online softmax runs in registers;
//    P is rounded to bf16 in registers, where the accumulator layout of the
//    first product is the A-fragment layout of the second, so O += P V is a
//    register-A wgmma with V as B under the transpose flag (V is stored
//    (t, d), d contiguous).  Where the next K/V tile has already arrived,
//    S_{j+1} is issued before P_j V_j and its softmax (bound by the exp
//    unit) runs while P_j V_j is on the tensor cores; where it has not,
//    P_j V_j goes first and frees its stage before the wait.  The mask is
//    applied only on a tile that holds the causal diagonal or the kv_len
//    edge.  BK = 128 keys per tile for every D: the Q tile plus three K/V
//    stages take 112 KB at D = 64 and 224 KB at D = 128, inside the 227 KB a
//    block may use.  K and V arrive as rank-4 TMA boxes (D-columns, 1, BK, 1)
//    of maps over (D, KR, T, B): one 128-byte swizzled box per 64 columns
//    (two at D = 128), a 64-byte swizzled box at D = 32.  Tiles past the
//    causal diagonal or past kv_len are never loaded, TMA zero-fills a
//    ragged last tile, and q tiles are launched heaviest first (the causal
//    tiles with the most keys lead the grid).
// 2. flash_decode (R <= 16, every dtype pair): split-kv on the CUDA cores.
//    Bound by bytes: the visible kv prefix is read once.  The grid is
//    (splits, KR, B); plan() picks splits so that there are about 2 x 132
//    blocks, each split has at least 64 keys, and there are at most 32.  A
//    block streams its key range once through cp.async 16-byte copies,
//    double-buffered, and all R rows share those loads.  It writes its
//    partial (m, l, acc) in float32 to the wrapper's scratch; the last block
//    of its (b, kr) to finish, found by an atomic ticket after
//    __threadfence(), combines the splits, o = sum e^(m_i - M) acc_i /
//    max(sum e^(m_i - M) l_i, 1e-20), and resets the ticket to 0, so a call
//    stays one launch.
// 3. flash_fwd (float32 q, R > 16): the first CUDA-core kernel, kept for
//    float32 prefill, which no registered config runs (tensor cores would
//    need TF32, which the float32 tolerance does not admit).  One block of
//    128 threads per 64 q rows; kv tiles of 64 rows staged in shared memory
//    in float32; CUDA-core FMAs.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, descriptors, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e9f;
// the variants, as kernels/flash_attention.py's plan() names them by code
constexpr int kVariantPrefillF32 = 0, kVariantWgmma = 1, kVariantDecode = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[4];  // element strides of q over (b, s, kr, g); d is unit
  long long ks[3];  // k over (b, t, kr)
  long long vs[3];  // v over (b, t, kr)
  long long os[4];  // o over (b, s, kr, g)
  int B, S, KR, Gl, T, R;  // R = S * Gl q rows per (b, kr)
  int causal, q_offset, kv_end;  // kv_end = min(kv_len, T)
  float scale;  // 1/sqrt(D), already rounded to q's dtype
  float* lse;   // (B, KR, R) float32 m + log(l) per q row, or null (prefill only)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// round a float32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the keys a block of q rows [r_first, r_last] can see: below kv_len and,
// when causal, up to the last row's position
__device__ __forceinline__ int kv_stop_for(const Params& p, int r_last) {
  return p.causal ? min(p.kv_end, p.q_offset + r_last / p.Gl + 1) : p.kv_end;
}

__device__ __forceinline__ const char* row_ptr(const void* base, const long long* st,
                                               long long b, long long s, long long kr,
                                               long long g, int esz) {
  return static_cast<const char*>(base) + (b * st[0] + s * st[1] + kr * st[2] + g * st[3]) * esz;
}

// ---------------------------------------------------------------------------------
// 3. flash_fwd: float32 q with R > 16, CUDA cores
// ---------------------------------------------------------------------------------

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kBK = 64;        // kv rows per tile = 8 column groups x 8
constexpr int kRPT = 4;        // q rows per thread: 64-row q tiles

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(16 * kRPT * (D + 1) + 2 * kBK * (D + 1) + 16 * kRPT * (kBK + 1));
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int BQ = 16 * kRPT;
  constexpr int LD = D + 1;       // padded row stride: no bank conflicts
  constexpr int LP = kBK + 1;
  constexpr int DPT = D / 8;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // BQ x LD
  float* sK = sQ + BQ * LD;       // kBK x LD
  float* sV = sK + kBK * LD;      // kBK x LD
  float* sP = sV + kBK * LD;      // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid & 7;         // column group: lanes of one row share a warp
  const int ty = tid >> 3;        // row group
  const int r0 = blockIdx.x * BQ;
  const int kr = blockIdx.y;
  const long long b = blockIdx.z;
  const TQ* q = static_cast<const TQ*>(p.q);
  const TKV* k = static_cast<const TKV*>(p.k);
  const TKV* v = static_cast<const TKV*>(p.v);
  TQ* o = static_cast<TQ*>(p.o);

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D, r = r0 + rr;
    float val = 0.f;
    if (r < p.R) {
      const int s = r / p.Gl, g = r % p.Gl;
      val = to_f32(q[b * p.qs[0] + s * p.qs[1] + kr * p.qs[2] + g * p.qs[3] + d]);
      val = round_to<TQ>(val * p.scale);
    }
    sQ[rr * LD + d] = val;
  }

  const int kv_stop = kv_stop_for(p, min(r0 + BQ, p.R) - 1);

  int qpos[kRPT];
  float m[kRPT], l[kRPT], acc[kRPT][DPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    qpos[i] = p.q_offset + (r0 + ty * kRPT + i) / p.Gl;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int t0 = 0; t0 < kv_stop; t0 += kBK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, t = t0 + c;
      float kval = 0.f, vval = 0.f;
      if (t < kv_stop) {
        kval = to_f32(k[b * p.ks[0] + t * p.ks[1] + kr * p.ks[2] + d]);
        vval = to_f32(v[b * p.vs[0] + t * p.vs[1] + kr * p.vs[2] + d]);
      }
      sK[c * LD + d] = kval;
      sV[c * LD + d] = vval;
    }
    __syncthreads();

    float s[kRPT][8];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRPT], kk[8];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) a[i] = sQ[(ty * kRPT + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = sK[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + tx + 8 * j;
        const bool ok = t < p.kv_end && (!p.causal || t <= qpos[i]);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pij = expf(s[i][j] - m_new);
        rowsum += pij;
        sP[(ty * kRPT + i) * LP + tx + 8 * j] = round_to<TKV>(pij);
      }
      l[i] = l[i] * alpha + group8_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) pv[i] = sP[(ty * kRPT + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = r0 + ty * kRPT + i;
    if (r >= p.R) continue;
    const int s = r / p.Gl, g = r % p.Gl;
    TQ* orow = o + b * p.os[0] + s * p.os[1] + kr * p.os[2] + g * p.os[3];
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 8 * j] = from_f32<TQ>(acc[i][j] / den);
    if (p.lse != nullptr && tx == 0) p.lse[(b * p.KR + kr) * p.R + r] = m[i] + logf(den);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kern = flash_fwd<TQ, TKV, D>;
  static bool ready[kMaxDevices];
  cudaError_t err = allow_smem(kern, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + 16 * kRPT - 1) / (16 * kRPT), p.KR, B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// 1. flash_wgmma: bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

template <int D>
struct WgCfg {
  static constexpr int BQ = 128;                   // q rows: two consumer warpgroups of 64
  static constexpr int BK = 128;                   // keys per tile (S = Q K^T is m64n128)
  static constexpr int STAGES = 3;                 // K/V ring
  static constexpr int BOX = D < 64 ? D : 64;      // columns per TMA box: one swizzle row
  static constexpr int NBOX = D / BOX;
  static constexpr int ROW = BOX * 2;              // bytes per swizzled row, 128 or 64
  static constexpr uint64_t SWZ = ROW == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int THREADS = 384;              // producer + two consumer warpgroups
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 2 * STAGES * 8;
};

template <int D>
__device__ __forceinline__ void wgmma_consumer(const Params& p, uint8_t* sQ,
                                               const uint8_t* sK, const uint8_t* sV,
                                               uint64_t* full, uint64_t* empty,
                                               int b, int kr, int r0, int n_tiles) {
  using C = WgCfg<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  const int tid = threadIdx.x - 128;     // 0..255 over both consumers
  const int cw = tid / 128;              // this warpgroup's 64 q rows
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  // q tile: 16-byte loads, scaled and rounded to bf16, stored swizzled
  constexpr int CPR = D / 8;             // 16-byte chunks per q row
  for (int idx = tid; idx < C::BQ * CPR; idx += 256) {
    const int row = idx / CPR, c = idx % CPR, r = r0 + row;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.R)
      raw = *reinterpret_cast<const uint4*>(
          row_ptr(p.q, p.qs, b, r / p.Gl, kr, r % p.Gl, 2) + c * 16);
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      h2[i] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
    }
    const int box = c / (C::BOX / 8), cc = c % (C::BOX / 8);
    *reinterpret_cast<uint4*>(sQ + box * C::BQ * C::ROW + row * C::ROW +
                              swizzle_chunk<C::ROW>(row, cc) * 16) = raw;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, 256;\n" ::: "memory");                // both consumers

  const uint8_t* qbase = sQ + cw * 64 * C::ROW;
  const int rw = r0 + cw * 64 + warp * 16 + g;   // this thread's rows: rw and rw + 8
  const int qpos0 = p.q_offset + rw / p.Gl, qpos1 = p.q_offset + (rw + 8) / p.Gl;
  const int qpos_first = p.q_offset + (r0 + cw * 64) / p.Gl;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  // S = Q K_j^T into s (asynchronous: one commit group)
  auto issue_qk = [&](int j, float (&s)[C::BK / 2]) {
    const int st = j % C::STAGES;
    const uint8_t* kt = sK + st * C::KV_BYTES;
    mbar_wait(&full[st], (j / C::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk / (C::BOX / 16), w = kk % (C::BOX / 16);
      const uint64_t da = smem_desc(qbase + h * C::BQ * C::ROW + w * 32, 16, 8 * C::ROW, C::SWZ);
      const uint64_t db = smem_desc(kt + h * C::BK * C::ROW + w * 32, 16, 8 * C::ROW, C::SWZ);
      wgmma_ss_n128(s, da, db, kk > 0);
    }
    wgmma_commit();
  };

  // O += P V_j (asynchronous: one commit group); P is the register A operand
  auto issue_pv = [&](int j, const uint32_t (&pa)[C::BK / 4]) {
    const uint8_t* vt = sV + (j % C::STAGES) * C::KV_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      // V as B, N-major: 16 keys per k-step, 8-key groups SBO apart, the
      // second 64-column box LBO away
      const uint64_t db = smem_desc(vt + kk * 16 * C::ROW, C::BK * C::ROW, 8 * C::ROW, C::SWZ);
      wgmma_pv<D>(o, a, db);
    }
    wgmma_commit();
  };

  // tile j's mask, the online-softmax update of (m, l), and P rounded to
  // bf16 as the A fragment of P V (registers 4kk..4kk+3 of ``pa`` are k-step
  // kk); alpha0/alpha1 are what the output rows must be rescaled by
  auto softmax = [&](int j, float (&s)[C::BK / 2], uint32_t (&pa)[C::BK / 4],
                     float& alpha0, float& alpha1) {
    // accumulator layout: s[4n + e] is row rw + 8 * (e / 2), key 8n + 2 tig + e % 2
    const int t0 = j * C::BK;
    if (t0 + C::BK > p.kv_end || (p.causal && t0 + C::BK - 1 > qpos_first)) {
#pragma unroll
      for (int n = 0; n < C::BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + 8 * n + 2 * tig + (e & 1);
          const bool ok = t < p.kv_end && (!p.causal || t <= (e < 2 ? qpos0 : qpos1));
          if (!ok) s[4 * n + e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    // the four threads of a quad hold one row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = expf(m0 - mn0);
    alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;  // l sums p unrounded
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
      const float p0 = exp2f((s[4 * n] - mn0) * kLog2e);
      const float p1 = exp2f((s[4 * n + 1] - mn0) * kLog2e);
      const float p2 = exp2f((s[4 * n + 2] - mn1) * kLog2e);
      const float p3 = exp2f((s[4 * n + 3] - mn1) * kLog2e);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[2 * n] = pack_bf16(p0, p1);
      pa[2 * n + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
  };

  // Pipelined where the next tile has arrived: S_{j+1} is issued before
  // P_j V_j, and its softmax runs while P_j V_j is still on the tensor cores.
  // Where it has not, P_j V_j goes first and its stage is released before
  // the wait for the next tile, so the producer's loads stay in flight.
  float s[C::BK / 2];
  uint32_t pa[C::BK / 4], pb[C::BK / 4];
  float alpha0, alpha1;
  issue_qk(0, s);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, s, pa, alpha0, alpha1);
  for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }
    const bool more = j + 1 < n_tiles;
    const int next = (j + 1) % C::STAGES;
    if (more && mbar_ready(&full[next], ((j + 1) / C::STAGES) & 1)) {
      issue_qk(j + 1, s);
      issue_pv(j, pa);
      wgmma_wait<1>();  // S_{j+1} is done; P_j V_j may still run
      fence_regs(s);
      softmax(j + 1, s, pb, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);  // P_j stays in its registers until P_j V_j is done
      mbar_arrive(&empty[j % C::STAGES]);  // this stage may be refilled
    } else {
      issue_pv(j, pa);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&empty[j % C::STAGES]);
      if (more) {
        issue_qk(j + 1, s);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(j + 1, s, pb, alpha0, alpha1);
      }
    }
#pragma unroll
    for (int i = 0; i < C::BK / 4; ++i) pa[i] = pb[i];
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rw + 8 * i;
    if (r >= p.R) continue;
    const float den = fmaxf(i == 0 ? l0 : l1, 1e-20f);
    // the backward's log-sum-exp, in the units of the scaled scores (the
    // softmax's exp2 takes them times log2 e, so m is in natural units)
    if (p.lse != nullptr && tig == 0)
      p.lse[((long long)b * p.KR + kr) * p.R + r] = (i == 0 ? m0 : m1) + logf(den);
    __nv_bfloat16* orow = reinterpret_cast<__nv_bfloat16*>(
        const_cast<char*>(row_ptr(p.o, p.os, b, r / p.Gl, kr, r % p.Gl, 2)));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] / den, o[4 * n + 2 * i + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::THREADS, 1)
flash_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap) {
  using C = WgCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sK = sQ + C::Q_BYTES;
  uint8_t* sV = sK + C::STAGES * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + C::STAGES * C::KV_BYTES);
  uint64_t* empty = full + C::STAGES;

  // q tiles heaviest first: the tiles with the most visible keys lead the grid
  const int nq = (p.R + C::BQ - 1) / C::BQ;
  const int pairs = p.KR * p.B;
  const int qt = nq - 1 - (int)(blockIdx.x / pairs);
  const int kr = blockIdx.x % p.KR;
  const int b = (blockIdx.x / p.KR) % p.B;
  const int r0 = qt * C::BQ;
  const int n_tiles = (kv_stop_for(p, min(r0 + C::BQ, p.R) - 1) + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::STAGES;
        mbar_wait(&empty[st], ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
        for (int h = 0; h < C::NBOX; ++h) {
          const int off = st * C::KV_BYTES + h * C::BK * C::ROW;
          tma_load(sK + off, &kmap, &full[st], h * C::BOX, kr, j * C::BK, b);
          tma_load(sV + off, &vmap, &full[st], h * C::BOX, kr, j * C::BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    wgmma_consumer<D>(p, sQ, sK, sV, full, empty, b, kr, r0, n_tiles);
  }
}

template <int D>
cudaError_t launch_wgmma(const Params& p, const CUtensorMap& kmap, const CUtensorMap& vmap,
                         cudaStream_t stream) {
  using C = WgCfg<D>;
  auto kern = flash_wgmma<D>;
  static bool ready[kMaxDevices];
  cudaError_t err = allow_smem(kern, C::SMEM, ready);
  if (err != cudaSuccess) return err;
  const int nq = (p.R + C::BQ - 1) / C::BQ;
  kern<<<nq * p.KR * p.B, C::THREADS, C::SMEM, stream>>>(p, kmap, vmap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// 2. flash_decode: R <= 16 q rows, split-kv on the CUDA cores
// ---------------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kMaxRows = 16;
constexpr int kMaxSplits = 32;

template <typename TKV, int D>
struct DecCfg {
  static constexpr int ROW = D * (int)sizeof(TKV);  // bytes of one k or v row
  static constexpr int BK = ROW <= 128 ? 64 : 32;   // keys per tile
  static constexpr int PITCH = ROW + 16;            // odd in 16-byte units: no bank conflicts
  static constexpr int CHUNKS = ROW / 16;
  static constexpr int TILE = BK * PITCH;
  static constexpr size_t SMEM = 4 * TILE + sizeof(float) * (kMaxRows * D + kMaxRows * BK);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  // copies src_bytes (16 or 0) and zero-fills the rest of the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// dot product of one 16-byte chunk of a k row with float32 q values
__device__ __forceinline__ float dot_chunk(const uint4& raw, const float* qv, float acc,
                                           __nv_bfloat16) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    acc = fmaf(qv[2 * i], f.x, acc);
    acc = fmaf(qv[2 * i + 1], f.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_chunk(const uint4& raw, const float* qv, float acc, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(qv[i], f[i], acc);
  return acc;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode(const Params p, int splits, float* __restrict__ ws, int* __restrict__ tickets) {
  using C = DecCfg<TKV, D>;
  constexpr int EPC = 16 / (int)sizeof(TKV);         // kv elements per 16-byte chunk
  constexpr int NJ = kMaxRows * D / kDecThreads;     // output values per thread
  extern __shared__ __align__(16) uint8_t dsmem[];
  uint8_t* sK = dsmem;                               // 2 stages of BK rows
  uint8_t* sV = sK + 2 * C::TILE;
  float* sQ = reinterpret_cast<float*>(sV + 2 * C::TILE);  // R x D, scaled and rounded
  float* sP = sQ + kMaxRows * D;                     // R x BK: scores, then p
  __shared__ float sAlpha[kMaxRows], sM[kMaxRows], sL[kMaxRows], sDen[kMaxRows];
  __shared__ float sW[kMaxSplits][kMaxRows];
  __shared__ int sLast;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kr = blockIdx.y, b = blockIdx.z;
  const int R = p.R;
  // this split's keys: an even share of the visible prefix
  const int kv_stop = kv_stop_for(p, R - 1);
  const int t_begin = (int)((long long)split * kv_stop / splits);
  const int t_end = (int)((long long)(split + 1) * kv_stop / splits);
  const int n_tiles = (t_end - t_begin + C::BK - 1) / C::BK;
  const char* kbase = static_cast<const char*>(p.k) + (b * p.ks[0] + kr * p.ks[2]) * sizeof(TKV);
  const char* vbase = static_cast<const char*>(p.v) + (b * p.vs[0] + kr * p.vs[2]) * sizeof(TKV);

  auto load_tile = [&](int i) {
    const int tb = t_begin + i * C::BK, stage = i & 1;
    for (int idx = tid; idx < C::BK * C::CHUNKS; idx += kDecThreads) {
      const int c = idx / C::CHUNKS, ch = idx % C::CHUNKS, t = tb + c;
      const int bytes = t < t_end ? 16 : 0;
      const long long tt = t < t_end ? t : t_begin;  // a valid address for the zero fill
      const int off = stage * C::TILE + c * C::PITCH + ch * 16;
      cp_async16(sK + off, kbase + tt * p.ks[1] * (long long)sizeof(TKV) + ch * 16, bytes);
      cp_async16(sV + off, vbase + tt * p.vs[1] * (long long)sizeof(TKV) + ch * 16, bytes);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0);
  for (int idx = tid; idx < R * D; idx += kDecThreads) {
    const int r = idx / D, d = idx % D;
    const TQ* qrow = reinterpret_cast<const TQ*>(row_ptr(p.q, p.qs, b, r / p.Gl, kr, r % p.Gl,
                                                         sizeof(TQ)));
    sQ[idx] = round_to<TQ>(to_f32(qrow[d]) * p.scale);
  }

  float mrow[kMaxRows / 4], lrow[kMaxRows / 4], acc[NJ];  // rows warp + 4i
#pragma unroll
  for (int i = 0; i < kMaxRows / 4; ++i) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_tile(i + 1);  // double buffering: the next tile streams in meanwhile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* kt = sK + (i & 1) * C::TILE;
    const uint8_t* vt = sV + (i & 1) * C::TILE;
    const int tb = t_begin + i * C::BK;

    for (int idx = tid; idx < R * C::BK; idx += kDecThreads) {
      const int r = idx / C::BK, c = idx % C::BK, t = tb + c;
      const float* qv = sQ + r * D;
      float s = 0.f;
#pragma unroll
      for (int ch = 0; ch < C::CHUNKS; ++ch)
        s = dot_chunk(*reinterpret_cast<const uint4*>(kt + c * C::PITCH + ch * 16),
                      qv + ch * EPC, s, TKV());
      const bool ok = t < t_end && (!p.causal || t <= p.q_offset + r / p.Gl);
      sP[idx] = ok ? s : kNegInf;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxRows / 4; ++k) {
      const int r = warp + 4 * k;
      if (r >= R) continue;  // (not break: the loop stays unrolled, mrow in registers)
      float sv[C::BK / 32], mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < C::BK / 32; ++jj) {
        sv[jj] = sP[r * C::BK + lane + 32 * jj];
        mx = fmaxf(mx, sv[jj]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[k], mx);
      const float alpha = expf(mrow[k] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < C::BK / 32; ++jj) {
        const float pj = expf(sv[jj] - m_new);
        sum += pj;
        sP[r * C::BK + lane + 32 * jj] = round_to<TKV>(pj);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lrow[k] = lrow[k] * alpha + sum;
      mrow[k] = m_new;
      if (lane == 0) sAlpha[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = tid + kDecThreads * j;
      if (idx < R * D) {
        const int r = idx / D, d = idx % D;
        const float* prow = sP + r * C::BK;
        float a = acc[j] * sAlpha[r];
#pragma unroll 8
        for (int c = 0; c < C::BK; ++c)
          a = fmaf(prow[c], to_f32(*reinterpret_cast<const TKV*>(vt + c * C::PITCH + d * sizeof(TKV))), a);
        acc[j] = a;
      }
    }
    __syncthreads();  // this stage is refilled next
  }

#pragma unroll
  for (int k = 0; k < kMaxRows / 4; ++k) {
    const int r = warp + 4 * k;
    if (r < R && lane == 0) {
      sM[r] = mrow[k];
      sL[r] = lrow[k];
    }
  }
  __syncthreads();

  auto out_at = [&](int r, int d) {
    return reinterpret_cast<TQ*>(const_cast<char*>(
        row_ptr(p.o, p.os, b, r / p.Gl, kr, r % p.Gl, sizeof(TQ)))) + d;
  };
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = tid + kDecThreads * j;
      if (idx < R * D) *out_at(idx / D, idx % D) = from_f32<TQ>(acc[j] / fmaxf(sL[idx / D], 1e-20f));
    }
    return;
  }

  // partials (acc, m, l) of this split; the last split of (b, kr) to finish
  // combines them
  const long long part_len = (long long)R * (D + 2);
  float* parts = ws + (long long)(b * p.KR + kr) * splits * part_len;
  float* mine = parts + split * part_len;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int idx = tid + kDecThreads * j;
    if (idx < R * D) mine[idx] = acc[j];
  }
  if (tid < R) {
    mine[R * D + tid] = sM[tid];
    mine[R * D + R + tid] = sL[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(&tickets[b * p.KR + kr], 1) == splits - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();

  if (tid < R) {
    float M = kNegInf;
    for (int i = 0; i < splits; ++i) M = fmaxf(M, __ldcg(parts + i * part_len + R * D + tid));
    float den = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float w = expf(__ldcg(parts + i * part_len + R * D + tid) - M);
      sW[i][tid] = w;
      den += w * __ldcg(parts + i * part_len + R * D + R + tid);
    }
    sDen[tid] = fmaxf(den, 1e-20f);
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kDecThreads) {
    const int r = idx / D;
    float num = 0.f;
    for (int i = 0; i < splits; ++i) num += sW[i][r] * __ldcg(parts + i * part_len + idx);
    *out_at(r, idx % D) = from_f32<TQ>(num / sDen[r]);
  }
  if (tid == 0) tickets[b * p.KR + kr] = 0;  // ready for the next call
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_decode(const Params& p, int splits, float* ws, int* tickets,
                          cudaStream_t stream) {
  constexpr size_t smem = DecCfg<TKV, D>::SMEM;
  auto kern = flash_decode<TQ, TKV, D>;
  static bool ready[kMaxDevices];
  cudaError_t err = allow_smem(kern, smem, ready);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, p.KR, p.B), kDecThreads, smem, stream>>>(p, splits, ws, tickets);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------------

// a rank-4 bf16 map over (D, KR, T, B) of k or v with boxes (BOX, 1, BK, 1)
template <int D>
bool kv_tensor_map(CUtensorMap* map, const void* base, const long long* st, int KR, int T, int B) {
  using C = WgCfg<D>;
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KR, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};  // bytes, of kr, t and b
  const cuuint32_t box[4] = {(cuuint32_t)C::BOX, 1, (cuuint32_t)C::BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!kv_tensor_map<D>(&kmap, p.k, p.ks, p.KR, p.T, p.B) ||
      !kv_tensor_map<D>(&vmap, p.v, p.vs, p.KR, p.T, p.B))
    return cudaErrorInvalidValue;
  return launch_wgmma<D>(p, kmap, vmap, stream);
}

template <typename TQ, typename TKV>
cudaError_t run(const Params& p, int variant, int splits, float* ws, int* tickets,
                cudaStream_t stream, int D) {
#define FLASH_BY_D(CALL)                          \
  switch (D) {                                    \
    case 32: { constexpr int kD = 32; return CALL; }   \
    case 64: { constexpr int kD = 64; return CALL; }   \
    case 128: { constexpr int kD = 128; return CALL; } \
    default: return cudaErrorInvalidValue;        \
  }
  if (variant == kVariantDecode) {
    if (p.R > kMaxRows || splits < 1 || splits > kMaxSplits || (splits > 1 && !(ws && tickets)))
      return cudaErrorInvalidValue;
    FLASH_BY_D((launch_decode<TQ, TKV, kD>(p, splits, ws, tickets, stream)))
  }
  if (variant == kVariantPrefillF32) {
    if (sizeof(TQ) != 4) return cudaErrorInvalidValue;
    FLASH_BY_D((launch_fwd<float, TKV, kD>(p, p.B, stream)))
  }
  if (variant == kVariantWgmma) {
    if (sizeof(TQ) != 2 || sizeof(TKV) != 2) return cudaErrorInvalidValue;
    FLASH_BY_D((run_wgmma<kD>(p, stream)))
  }
#undef FLASH_BY_D
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Supported (q, kv): (0,0), (1,1),
// (0,1) — the last is an f32 model decoding from the bf16 cache.  variant:
// 0 = flash_fwd (float32 q), 1 = flash_wgmma (bf16 q and kv), 2 =
// flash_decode (R <= 16) with ``splits`` kv splits, float32 scratch
// ``workspace`` of B * KR * splits * R * (D + 2) values and ``tickets``, B * KR
// int32 zeros (left at zero), both unused when splits == 1.  ``lse``, when
// not null, receives m + log(l) per q row as float32 (B, KR, S * Gl), row
// r = s * Gl + g, for the backward (prefill variants only; the decode
// refuses it).
// Returns a cudaError_t value (0 on success); cudaErrorInvalidValue for a
// combination the kernel does not take.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int q_dtype, int kv_dtype, int B, int S, int KR, int Gl, int T, int D,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides,
    int causal, int q_offset, int kv_len, float scale,
    int variant, int splits, void* workspace, void* tickets, void* lse, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int i = 0; i < 4; ++i) { p.qs[i] = q_strides[i]; p.os[i] = o_strides[i]; }
  for (int i = 0; i < 3; ++i) { p.ks[i] = k_strides[i]; p.vs[i] = v_strides[i]; }
  p.B = B; p.S = S; p.KR = KR; p.Gl = Gl; p.T = T; p.R = S * Gl;
  p.causal = causal; p.q_offset = q_offset;
  p.kv_end = kv_len < T ? kv_len : T;
  p.scale = scale;
  p.lse = static_cast<float*>(lse);
  if (lse != nullptr && variant == kVariantDecode) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  if (q_dtype == 0 && kv_dtype == 0) return run<float, float>(p, variant, splits, ws, tk, st, D);
  if (q_dtype == 1 && kv_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(p, variant, splits, ws, tk, st, D);
  if (q_dtype == 0 && kv_dtype == 1) return run<float, __nv_bfloat16>(p, variant, splits, ws, tk, st, D);
  return cudaErrorInvalidValue;
}
