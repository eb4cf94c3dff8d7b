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
// What bounds it on an H100: operations.  Per visible (row, key) pair the
// backward forms S (2D flops), dP (2D) and three products (dq, dk, dv: 6D):
// 10D, two and a half times the forward's 4D; at B4 S2048 H16 D64 causal
// that is 85.9 GFLOP, 0.087 ms at 989 TFLOP/s bf16 (134 MB read and written
// once: 0.040 ms at 3.35 TB/s).
//
// bf16: three launches per call, every product on wgmma.
// 1. flash_bwd_prep (elementwise and a row reduction; 256 threads, D / 8 per
//    row): Delta; qf and a copy of dO in a row-contiguous (B*KR, Rp, D)
//    layout, Rp = R rounded up to 64 with zero rows past R, so that any
//    64-row tile of one (b, kr) is one TMA box whatever Gl is (rows
//    s * Gl + g straddle (s, g) in q's own layout); lse beside Delta in
//    (B*KR, Rp) float32 (+inf past R, so those rows' P is 0 with no mask);
//    and zeros into the float32 dq accumulator (B*KR, Rp, D).
// 2. flash_bwd_main: one block per (128-key kv tile, kr, b), kv tiles
//    heaviest first (causal: the first keys are seen by the most rows).
//    Warpgroup 0 is the producer: one thread loads K and V once by TMA
//    (rank-4 maps over k and v as the forward reads them; TMA zero-fills
//    keys past T, whose dk and dv are never stored and whose zero K rows add
//    nothing to dq) and keeps a ring of qf, dO, lse and Delta tiles of 64
//    rows full (TMA boxes and bulk copies, full/empty mbarriers).  Causal
//    blocks start at the row tile that holds row t0 * Gl.  Warpgroups 1 and
//    2 own 64 keys each (setmaxnreg 24 / 240) and, for every row tile:
//      S^T = K qf^T and dP^T = V dO^T   smem x smem wgmma, both K-major;
//      P^T = exp(S^T - lse), masked before the exp on tiles that cross the
//      diagonal; dS^T = P^T (dP^T - Delta), computed once;
//      dv += round(P^T) dO, dk += dS^T qf   register-A wgmma (the accumulator
//      layout of S^T is the A-fragment layout), B under the transpose flag;
//      dq_w = dS_w K_w   dS^T stored swizzled to shared memory, A M-major
//      and B N-major under both transpose flags.
//    The second warpgroup writes its dq partial into a float32 tile in
//    shared memory; the first adds its own and one thread adds the tile to
//    the accumulator with one cp.reduce.async.bulk (an atomic float32 add
//    per element in L2), double-buffered behind named barriers.  The tile's
//    16-byte chunks are stored XOR-swizzled by row (conflict-free writes
//    from the accumulator layout); launch 3 reads them back the same way.
//    dk and dv are written once at the end, from registers.
// 3. flash_bwd_dq_out: dq = round(scale * accumulator), into (B,S,KR,Gl,D).
// Choices: 64-row tiles (one TMA box; S^T and dP^T are m64n64) and 128 keys
// per block (two consumer warpgroups) at every D; a ring of 3 stages at D
// 32 and 64, 2 at D = 128 (shared memory: 75, 131 and 210 KiB).  At D = 128
// dk and dv take 128 of a consumer's 240 registers, so S^T and dP^T are
// formed in four parts of 16 rows (m64n16), each part's dv and dk products
// finish before the next part starts, and dS K is formed in two pieces of
// 64 columns.
// Numerics: dq's float32 sums are added by atomics in an order that changes
// from run to run (one bf16 rounding of sums taken in varying order); dk and
// dv are summed in registers in a fixed order and are deterministic.
//
// float32 (off the training path: no registered config trains in it): two
// launches on the CUDA cores, flash_bwd_dq_f32 (Delta and dq) then
// flash_bwd_dkdv_f32, each recomputing S and P.
//
// Layouts are contiguous: q, o, do, dq (B,S,KR,Gl,D); k, v, dk, dv
// (B,T,KR,D); lse (B,KR,R) float32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA and bulk copies, wgmma, the tensor-map encoder

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;  // bf16: (B*KR, Rp); float32: (B, KR, R)
  void* dq;
  void* dk;
  void* dv;
  // bf16 scratch, written by flash_bwd_prep (rows past R padded)
  __nv_bfloat16* qf;   // (B*KR, Rp, D) round(q * scale)
  __nv_bfloat16* dob;  // (B*KR, Rp, D) dO
  float* lse_p;        // (B*KR, Rp) lse
  float* dq_acc;       // (B*KR, Rp, D) scale-less dq, 16-byte chunks swizzled by row
  int B, S, KR, Gl, T, R, Rp;
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

// ---------------------------------------------------------------------------------
// bf16: bwd_prep, bwd_main (wgmma fed by TMA), bwd_dq_out
// ---------------------------------------------------------------------------------

constexpr int kBr = 64;            // q rows per tile
constexpr int kBc = 128;           // keys per bwd_main block: two consumer warpgroups
constexpr int kPrepThreads = 256;
constexpr int kOutThreads = 256;
constexpr int kMainThreads = 384;  // producer + two consumer warpgroups
// bwd_main's named barriers (0 is __syncthreads)
constexpr int kBarDqFilled = 1;    // the second warpgroup's dq partial is in shared memory
constexpr int kBarDqFree = 2;      // a dq tile's bulk reduction has read it
constexpr int kBarWg0 = 3;         // the first warpgroup's sum is in
constexpr int kBarDs = 4;          // + w: warpgroup w's dS^T is in

template <int D>
struct MainCfg {
  static constexpr int BOX = D < 64 ? D : 64;    // columns per TMA box: one swizzle row
  static constexpr int NBOX = D / BOX;
  static constexpr int ROW = BOX * 2;            // bytes per swizzled row, 128 or 64
  static constexpr uint64_t SWZ = ROW == 128 ? 1 : 2;
  static constexpr int PARTS = D == 128 ? 4 : 1;  // S^T and dP^T in parts of RH rows
  static constexpr int RH = kBr / PARTS;
  static constexpr int DQ_SPLIT = D == 128 ? 2 : 1;  // dS K in pieces of NQ columns
  static constexpr int NQ = D / DQ_SPLIT;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int KV_BYTES = kBc * D * 2;   // the K or the V tile
  static constexpr int ROWS_BYTES = kBr * D * 2; // one qf or dO tile
  static constexpr int DS_BYTES = 64 * kBr * 2;  // one warpgroup's dS^T: 64 keys x 64 rows
  static constexpr int DQ_BYTES = kBr * D * 4;   // one float32 dq tile
  static constexpr int STAT_BYTES = 2 * kBr * 4; // lse and Delta of one tile
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * ROWS_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * ROWS_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
  static constexpr int OFF_STAT = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_BAR = OFF_STAT + STAGES * STAT_BYTES;
  static constexpr size_t SMEM = 1024 + OFF_BAR + (1 + 2 * STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory a block may use");
};

template <int D>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep(const Bwd p) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row: CPR neighbouring lanes
  const long long idx = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  const int c = (int)(idx % CPR);
  const long long row = idx / CPR;  // (b * KR + kr) * Rp + r
  const int r = (int)(row % p.Rp);
  const int bk = (int)(row / p.Rp);
  const int b = bk / p.KR, kr = bk % p.KR;
  uint4 qraw = make_uint4(0u, 0u, 0u, 0u), draw = qraw;
  float acc = 0.f;
  if (r < p.R) {
    const long long off = q_off(p, b, kr, r, D) + 8 * c;
    qraw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) + off);
    draw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) + off);
    const uint4 oraw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.o) + off);
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(&qraw);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&draw);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&oraw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 df = __bfloat1622float2(d2[i]), of = __bfloat1622float2(o2[i]);
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
      const float2 qv = __bfloat1622float2(q2[i]);
      q2[i] = __floats2bfloat162_rn(qv.x * p.scale, qv.y * p.scale);
    }
  }
#pragma unroll
  for (int m = 1; m < CPR; m *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  *reinterpret_cast<uint4*>(p.qf + row * D + 8 * c) = qraw;
  *reinterpret_cast<uint4*>(p.dob + row * D + 8 * c) = draw;
  float4* acc_row = reinterpret_cast<float4*>(p.dq_acc + row * D + 8 * c);
  acc_row[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  acc_row[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c == 0) {
    p.delta[row] = acc;
    p.lse_p[row] = r < p.R ? p.lse[row_off(p, b, kr, r)] : INFINITY;
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_tt_n32(d, da, db, scale_d);
  else wgmma_ss_tt_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

// wgmma descriptors of swizzled tiles (ROW bytes per row, 128 or 64) from
// a shared address: K-major (k-steps 32 bytes apart in a row, 8-row groups
// 8 ROW apart) and M- or N-major (k-steps of 16 rows; 8-row groups 8 ROW
// apart, 64-column boxes LBO apart).  Only the address varies: the high
// word is a constant
template <int ROW>
__device__ __forceinline__ uint64_t kmaj_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(8 * ROW / 16) << 32 | (uint64_t)(ROW == 128 ? 1 : 2) << 62;
}

template <int ROW, int LBO>
__device__ __forceinline__ uint64_t mnmaj_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((LBO >> 4) & 0x3FFF) << 16 |
         (uint64_t)(8 * ROW / 16) << 32 | (uint64_t)(ROW == 128 ? 1 : 2) << 62;
}

template <int D>
__device__ __forceinline__ void bwd_consumer(const Bwd& p, uint8_t* base, uint64_t* kv_full,
                                             uint64_t* full, uint64_t* empty, int b, int kr,
                                             int t0, int rt0, int n_tiles) {
  using C = MainCfg<D>;
  constexpr int RH = C::RH;
  const int tid = threadIdx.x - 128;  // 0..255 over both consumers
  const int w = tid / 128;            // this warpgroup's 64 keys: t0 + 64 w ..
  const int wt = tid % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, tig = lane % 4;
  const uint8_t* sK = base;
  const uint8_t* sV = base + C::OFF_V;
  const uint8_t* kw = sK + 64 * w * C::ROW;   // this warpgroup's keys, in every box
  const uint8_t* vw = sV + 64 * w * C::ROW;
  uint8_t* dsw = base + C::OFF_DS + w * C::DS_BYTES;
  // accumulator layout: element 4n + e is row (key) 16 warp + g + 8 (e / 2)
  // of the warpgroup's 64, column 8n + 2 tig + e % 2
  const int key0 = t0 + 64 * w + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const bool causal = p.causal != 0;
  const int gl = p.Gl;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % C::STAGES;
    const int r0 = (rt0 + i) * kBr;
    const uint8_t* qt = base + C::OFF_Q + st * C::ROWS_BYTES;
    const uint8_t* dot = base + C::OFF_DO + st * C::ROWS_BYTES;
    const float* lse = reinterpret_cast<const float*>(base + C::OFF_STAT + st * C::STAT_BYTES);
    const float* dlt = lse + kBr;
    // keys past some row's position: the tile crosses the causal diagonal
    const bool edge = causal && (t0 + 64 * w + 63) * gl > r0;
    const uint32_t ka = smem_u32(kw), va = smem_u32(vw), dsa = smem_u32(dsw);
    const uint32_t qa = smem_u32(qt), doa = smem_u32(dot);
    mbar_wait(&full[st], (i / C::STAGES) & 1);

    uint32_t pa[kBr / 4], da[kBr / 4];  // round(P^T), round(dS^T): A fragments, k-step kk at 4 kk
#pragma unroll
    for (int hf = 0; hf < C::PARTS; ++hf) {
      float s[RH / 2], dp[RH / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int h = kk / (C::BOX / 16), wk = kk % (C::BOX / 16);
        const int koff = h * kBc * C::ROW + wk * 32, qoff = h * kBr * C::ROW + hf * RH * C::ROW + wk * 32;
        wgmma_ss_kk<RH>(s, kmaj_desc<C::ROW>(ka + koff), kmaj_desc<C::ROW>(qa + qoff), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int h = kk / (C::BOX / 16), wk = kk % (C::BOX / 16);
        const int koff = h * kBc * C::ROW + wk * 32, qoff = h * kBr * C::ROW + hf * RH * C::ROW + wk * 32;
        wgmma_ss_kk<RH>(dp, kmaj_desc<C::ROW>(va + koff), kmaj_desc<C::ROW>(doa + qoff), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp(S^T - lse), masked before the exp; dS^T = P^T (dP^T - Delta)
#pragma unroll
      for (int n = 0; n < RH / 8; ++n) {
        const int c = hf * RH + 8 * n + 2 * tig;  // this thread's rows r0 + c, r0 + c + 1
        const float2 l = *reinterpret_cast<const float2*>(lse + c);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), r = r0 + c + (e & 1);
          const float x = edge && key * gl > r ? -INFINITY
                                               : (s[4 * n + e] - ((e & 1) ? l.y : l.x)) * kLog2e;
          const float pr = exp2f(x);
          s[4 * n + e] = pr;
          dp[4 * n + e] = pr * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x));
        }
        const int a = hf * (RH / 4) + 2 * n;
        pa[a] = pack_bf16(s[4 * n], s[4 * n + 1]);
        pa[a + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
        da[a] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
        da[a + 1] = pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
        // dS^T into shared memory: key row 16 warp + g (+ 8), 128 bytes of
        // 64 row columns each, 16-byte chunks swizzled as TMA's 128-byte mode
        const int chunk = (hf * (RH / 8) + n) ^ g;
        uint8_t* at = dsw + (16 * warp + g) * 128 + chunk * 16 + 4 * tig;
        *reinterpret_cast<uint32_t*>(at) = da[a];
        *reinterpret_cast<uint32_t*>(at + 8 * 128) = da[a + 1];
      }

      // dv += round(P^T) dO and dk += dS^T qf over this part's rows
      wgmma_fence();
#pragma unroll
      for (int kk = hf * (RH / 16); kk < (hf + 1) * (RH / 16); ++kk) {
        const uint32_t ap[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_rs<D>(dv, ap, mnmaj_desc<C::ROW, kBr * C::ROW>(doa + kk * 16 * C::ROW));
      }
#pragma unroll
      for (int kk = hf * (RH / 16); kk < (hf + 1) * (RH / 16); ++kk) {
        const uint32_t ad[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_rs<D>(dk, ad, mnmaj_desc<C::ROW, kBr * C::ROW>(qa + kk * 16 * C::ROW));
      }
      wgmma_commit();
      if constexpr (C::PARTS > 1) {  // registers: finish before the next part's S^T
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int a = hf * (RH / 4); a < (hf + 1) * (RH / 4); ++a)  // this part's fragments only
          asm volatile("" : "+r"(pa[a]), "+r"(da[a]) :: "memory");
      }
    }

    // dq_w = dS_w K_w: A = dS^T as stored (M-major), B = K (N-major), in
    // DQ_SPLIT pieces of NQ columns.  The two partials are summed in a
    // float32 tile, then added into the accumulator by one bulk reduction;
    // element (row, col) sits at row * D + 4 ((col / 4) ^ (row % 8)) + col % 4
    fence_proxy_async();
    bar_sync(kBarDs + w, 128);
    float* sdq = reinterpret_cast<float*>(base + C::OFF_DQ + (i & 1) * C::DQ_BYTES);
    if (w == 1 && i >= 2) bar_sync(kBarDqFree, 256);  // this buffer's last reduction has read it
#pragma unroll
    for (int pc = 0; pc < C::DQ_SPLIT; ++pc) {
      constexpr int NQ = C::NQ;
      float dq[NQ / 2];
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) dq[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tt<NQ>(dq, mnmaj_desc<128, C::DS_BYTES>(dsa + kk * 16 * 128),
                        mnmaj_desc<C::ROW, kBc * C::ROW>(ka + pc * kBc * C::ROW + kk * 16 * C::ROW),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      if constexpr (C::PARTS == 1) {  // else each part's products were waited for
        fence_regs(pa);
        fence_regs(da);
      }
      if (pc == 0) mbar_arrive(&empty[st]);  // this stage's tiles are read

      // this thread's float2 slots: rows 16 warp + g (+ 8), columns pc NQ + 8n + 2 tig
      auto slot = [&](int n, int hi) {
        const int chunk = (pc * NQ / 4 + 2 * n + (tig >> 1)) ^ g;  // (16 warp + g + 8 hi) % 8 == g
        return reinterpret_cast<float2*>(sdq + (16 * warp + g + 8 * hi) * D + 4 * chunk +
                                         2 * (tig & 1));
      };
      if (w == 1) {
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n) {
          *slot(n, 0) = make_float2(dq[4 * n], dq[4 * n + 1]);
          *slot(n, 1) = make_float2(dq[4 * n + 2], dq[4 * n + 3]);
        }
      } else {
        if (pc == 0) bar_sync(kBarDqFilled, 256);
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n) {
          float2* lo = slot(n, 0);
          float2* hi = slot(n, 1);
          const float2 a = *lo, c = *hi;
          *lo = make_float2(a.x + dq[4 * n], a.y + dq[4 * n + 1]);
          *hi = make_float2(c.x + dq[4 * n + 2], c.y + dq[4 * n + 3]);
        }
      }
    }
    if (w == 1) {
      bar_arrive(kBarDqFilled, 256);
    } else {
      fence_proxy_async();
      bar_sync(kBarWg0, 128);
      if (wt == 0) {
        bulk_reduce_add_f32(p.dq_acc + ((long long)(b * p.KR + kr) * p.Rp + r0) * D, sdq,
                            C::DQ_BYTES);
        bulk_commit();
        bulk_wait_read<1>();  // the reduction of tile i - 1 has read its buffer
      }
      __syncwarp();
      if (i >= 1 && i + 1 < n_tiles) bar_arrive(kBarDqFree, 256);  // for tile i + 1
    }
  }
  if (w == 0 && wt == 0) bulk_wait<0>();

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= p.T) continue;
    const long long off = kv_off(p, b, kr, key, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(dk[4 * n + 2 * i], dk[4 * n + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMainThreads, 1)
flash_bwd_main(const __grid_constant__ Bwd p, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap domap) {
  using C = MainCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  // kv tiles heaviest first: with a causal mask the first keys have the most rows
  const int j = blockIdx.x / (p.KR * p.B);
  const int kr = blockIdx.x % p.KR;
  const int b = (blockIdx.x / p.KR) % p.B;
  const int t0 = j * kBc;
  const int rt0 = p.causal ? (int)((long long)t0 * p.Gl / kBr) : 0;  // the tile of row t0 * Gl
  const int n_tiles = max(0, p.Rp / kBr - rt0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      uint8_t* sK = base;
      uint8_t* sV = base + C::OFF_V;
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int h = 0; h < C::NBOX; ++h) {
        tma_load(sK + h * kBc * C::ROW, &kmap, kv_full, h * C::BOX, kr, t0, b);
        tma_load(sV + h * kBc * C::ROW, &vmap, kv_full, h * C::BOX, kr, t0, b);
      }
      const int bk = b * p.KR + kr;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES;
        const int r0 = (rt0 + i) * kBr;
        mbar_wait(&empty[st], ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::ROWS_BYTES + C::STAT_BYTES);
#pragma unroll
        for (int h = 0; h < C::NBOX; ++h) {
          const int off = st * C::ROWS_BYTES + h * kBr * C::ROW;
          tma_load_3d(base + C::OFF_Q + off, &qmap, &full[st], h * C::BOX, r0, bk);
          tma_load_3d(base + C::OFF_DO + off, &domap, &full[st], h * C::BOX, r0, bk);
        }
        float* stat = reinterpret_cast<float*>(base + C::OFF_STAT + st * C::STAT_BYTES);
        const long long row = (long long)bk * p.Rp + r0;
        bulk_load(stat, p.lse_p + row, kBr * 4, &full[st]);
        bulk_load(stat + kBr, p.delta + row, kBr * 4, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    bwd_consumer<D>(p, base, kv_full, full, empty, b, kr, t0, rt0, n_tiles);
  }
}

template <int D>
__global__ void __launch_bounds__(kOutThreads) flash_bwd_dq_out(const Bwd p) {
  constexpr int CPR = D / 8;  // eight columns per thread
  const long long idx = (long long)blockIdx.x * kOutThreads + threadIdx.x;
  if (idx >= (long long)p.B * p.KR * p.R * CPR) return;
  const int j = (int)(idx % CPR);
  const long long row = idx / CPR;  // (b * KR + kr) * R + r
  const int r = (int)(row % p.R);
  const int bk = (int)(row / p.R);
  const float* acc = p.dq_acc + ((long long)bk * p.Rp + r) * D;
  const int sw = r & 7;  // rows of a tile start at multiples of 64
  const float4 lo = *reinterpret_cast<const float4*>(acc + 4 * ((2 * j) ^ sw));
  const float4 hi = *reinterpret_cast<const float4*>(acc + 4 * ((2 * j + 1) ^ sw));
  uint4 out;
  out.x = pack_bf16(lo.x * p.scale, lo.y * p.scale);
  out.y = pack_bf16(lo.z * p.scale, lo.w * p.scale);
  out.z = pack_bf16(hi.x * p.scale, hi.y * p.scale);
  out.w = pack_bf16(hi.z * p.scale, hi.w * p.scale);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.dq) +
                            q_off(p, bk / p.KR, bk % p.KR, r, D) + 8 * j) = out;
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

// a bf16 tensor map with the swizzle of ``row_bytes`` (128 or 64) per box row
bool bf16_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
              const cuuint64_t* byte_strides, const cuuint32_t* box, int row_bytes) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                byte_strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the three launches' grids (kernels/flash_attention_bwd.py::plan gives them)
struct Grids {
  long long prep, main, out;
};

template <int D>
Grids bf16_grids(const Bwd& p) {
  const long long pairs = (long long)p.B * p.KR;
  return {pairs * p.Rp * (D / 8) / kPrepThreads, (long long)((p.T + kBc - 1) / kBc) * pairs,
          (pairs * p.R * (D / 8) + kOutThreads - 1) / kOutThreads};
}

template <int D>
cudaError_t run_bf16(const Bwd& p, const Grids& given, cudaStream_t stream) {
  using C = MainCfg<D>;
  const Grids want = bf16_grids<D>(p);
  if (p.Rp != (p.R + kBr - 1) / kBr * kBr || given.prep != want.prep ||
      given.main != want.main || given.out != want.out || want.main > 0x7fffffffLL ||
      want.prep > 0x7fffffffLL || want.out > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // k and v as the forward reads them: rank 4 over (D, KR, T, B), boxes of kBc keys
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)p.KR, (cuuint64_t)p.T,
                                 (cuuint64_t)p.B};
  const cuuint64_t kv_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)p.KR * D * 2,
                                    (cuuint64_t)p.T * p.KR * D * 2};
  const cuuint32_t kv_box[4] = {(cuuint32_t)C::BOX, 1, (cuuint32_t)kBc, 1};
  // qf and the dO copy: rank 3 over (D, Rp, B * KR), boxes of kBr rows
  const cuuint64_t row_dims[3] = {(cuuint64_t)D, (cuuint64_t)p.Rp, (cuuint64_t)p.B * p.KR};
  const cuuint64_t row_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.Rp * D * 2};
  const cuuint32_t row_box[3] = {(cuuint32_t)C::BOX, (cuuint32_t)kBr, 1};
  CUtensorMap kmap, vmap, qmap, domap;
  if (!bf16_map(&kmap, p.k, 4, kv_dims, kv_strides, kv_box, C::ROW) ||
      !bf16_map(&vmap, p.v, 4, kv_dims, kv_strides, kv_box, C::ROW) ||
      !bf16_map(&qmap, p.qf, 3, row_dims, row_strides, row_box, C::ROW) ||
      !bf16_map(&domap, p.dob, 3, row_dims, row_strides, row_box, C::ROW))
    return cudaErrorInvalidValue;
  static bool ready[kMaxDevices];
  cudaError_t err = allow_smem(flash_bwd_main<D>, C::SMEM, ready);
  if (err != cudaSuccess) return err;
  flash_bwd_prep<D><<<(unsigned)want.prep, kPrepThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_main<D><<<(unsigned)want.main, kMainThreads, C::SMEM, stream>>>(p, kmap, vmap, qmap,
                                                                            domap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_out<D><<<(unsigned)want.out, kOutThreads, 0, stream>>>(p);
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
// the forward, float32 (B,KR,S*Gl).  Causal masks are aligned top-left
// (q_offset = 0), every key below T is valid.
// bf16: three launches (bwd_prep, bwd_main, bwd_dq_out) on scratch the
// caller allocates, all (B*KR, rows_padded) rows with rows_padded = R
// rounded up to 64: qf and dob bf16 (.., D), lse_p and delta float32, dq_acc
// float32 (.., D); prep_grid, main_grid and out_grid must be the grids the
// launch computes (kernels/flash_attention_bwd.py::plan), else
// cudaErrorInvalidConfiguration.  float32: two launches; ``delta`` is
// (B,KR,S*Gl) float32 scratch, and the other scratch and the grids are not
// read.  Returns a cudaError_t value (0 on success), cudaErrorInvalidValue
// for what the kernel does not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* qf, void* dob, void* lse_p, void* dq_acc,
    int dtype, int B, int S, int KR, int Gl, int T, int D, int causal, float scale,
    int rows_padded, long long prep_grid, long long main_grid, long long out_grid,
    void* stream) {
  Bwd p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.qf = static_cast<__nv_bfloat16*>(qf);
  p.dob = static_cast<__nv_bfloat16*>(dob);
  p.lse_p = static_cast<float*>(lse_p);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.B = B; p.S = S; p.KR = KR; p.Gl = Gl; p.T = T; p.R = S * Gl; p.Rp = rows_padded;
  p.causal = causal;
  p.scale = scale;
  if (B < 1 || S < 1 || KR < 1 || Gl < 1 || T < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!(qf && dob && lse_p && dq_acc && delta)) return cudaErrorInvalidValue;
    const Grids grids = {prep_grid, main_grid, out_grid};
    switch (D) {
      case 32: return run_bf16<32>(p, grids, st);
      case 64: return run_bf16<64>(p, grids, st);
      case 128: return run_bf16<128>(p, grids, st);
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
