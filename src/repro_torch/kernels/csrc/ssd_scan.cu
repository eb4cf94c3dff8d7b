// Mamba2 SSD (state space duality) scan for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan.py:70 ssd_scan (body _ssd_kernel) and, on the
// model path, the pure-jnp oracle it stands in for,
// src/repro/models/ssm.py::ssd_scan_ref.  Inputs x (Bb,S,H,hd), dt (Bb,S,H),
// B and C (Bb,S,ds) shared by all heads, A (H,) negative, or one per batch
// row where rows hold different heads (a partitioned call folds each
// device's heads into the batch); output y in x's layout.  Everything is
// float32.  For each chunk c of Q rows, with l the within-chunk cumulative
// sum of dt*A:
//
//   S_c  = (exp(l_Q - l) * dt * x)^T B               (hd x ds, chunk-local)
//   S_in[0] = 0,  S_in[c] = exp(l_Q[c-1]) S_in[c-1] + S_{c-1}
//   G    = C B^T                                      (Q x Q, causal half)
//   W    = where(t >= s, exp(l_t - l_s), 0) * G * dt_s
//   y    = W x + exp(l) * (C S_in^T)                  (Q x hd)
//
// The mask is a select before the product: for t < s, l_t - l_s is a sum of
// up to Q - 1 terms dt*|A| and exp overflows to inf, which a multiply by 0
// would turn into NaN.
//
// Three passes, launched back to back on one stream by one wrapper call with
// the grids of its plan (kernels/ssd_scan.py::plan; the launch checks that
// they cover the work), in the plain version's own order
// (kernels/ref.py::ssd_scan_ref), so chunks run in parallel instead of in
// order inside one block:
//
// 1. ssd_chunk_state, one block per (chunk, head, batch row): l by a
//    compensated warp scan, rounded once and written in base 2 (l log2(e))
//    to the l scratch (Bb, nc, H, Q);
//    then S_c on the tensor cores into the state scratch (Bb, nc, H, hd,
//    ds).  The last chunk's state is never read and is not computed.
// 2. ssd_state_pass, one block per (slice of hd*ds, head, batch row): walks
//    the chunks in order and turns the local states, in place, into the
//    states entering each chunk (16-byte loads and stores).
// 3. ssd_chunk_out, one block per (chunk, group of heads, batch row; the
//    wrapper's plan picks the group, up to 8 heads): G =
//    C B^T once for the group, kept in registers in the accumulator layout
//    (each warp its 16 rows t and the columns s <= t), then per head W x and
//    C S_in^T on the tensor cores.  W goes from G's accumulator registers to
//    an A fragment with no shuffle: the k slots of each 8-column step are
//    permuted (slot tig <- column 2 tig, slot tig + 4 <- column 2 tig + 1) and
//    x's rows are read in the same order, which leaves the sum unchanged.
//    The next head's x, S_in, l and dt arrive by cp.async during this head's
//    products, into B's place once G is done.
//
// Tensor cores at float32 accuracy (3xTF32).  Every product runs as
// mma.sync m16n8k8 TF32 with float32 accumulation on operands split as
// hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi) (rounded by integer adds,
// see split): each k step of 8 sums lo b_hi + hi b_lo + hi b_hi in a fresh
// accumulator, and a float32 add takes it into acc (see mma3).  One TF32
// product alone keeps about three decimal digits, 64x over the f32_chain
// class the port holds the kernel to; the split keeps float32's, and so
// does l, a compensated sum rounded once (see chunk_cumsum).
//
// What bounds it on an H100.  At the Mamba2 forward's shape (Bb 8, S 2048,
// H 24, hd 64, ds 128, Q 128) the function needs about 15.6 GFLOP (the
// causal half of G once per batch row and chunk, the causal half of W x,
// and C S^T and the state update in all chunks but one) against about
// 220 MB moved (x and y once, dt, B and C once).  In 3xTF32 that is three
// tensor-core products per product: 0.0945 ms at 495 TFLOP/s, against
// 0.066 ms for the bytes at 3.35 TB/s.  Beyond the bound the design pays
// for the state scratch: 100.7 MB at that shape, written once (pass 1), read
// and written once (pass 2) and read once (pass 3), about 0.4 GB or 0.12 ms
// at 3.35 TB/s where none of it stays in L2; for G once per head group
// rather than once per (batch row, chunk); and for mma.sync, which runs
// well below the 495 TFLOP/s that wgmma reaches (tools/ssd_ablation.py
// measures each pass and the share of its tensor-core products).
//
// Shared memory, in floats, for Q = 128 (rows are padded to conflict-free
// strides: 8 mod 32 where fragments walk rows by k, 4 mod 32 where they
// walk rows by g):
//   pass 1: x Kp x (hd+8), B Kp x (ds+8), dt, l, decay 128 each
//           (hd 64, ds 128: 27,008 floats = 105.5 KB, two blocks per SM);
//   pass 3: C Qp x (ds+4); then two head buffers of x Qp x (hd+4), S_in
//           hd x (ds+4), l and dt 128 each, the second in B's place
//           (B Qp x (ds+4)), whichever is larger
//           (hd 64, ds 128: 51,712 floats = 202 KB, one block per SM);
//   pass 2: none.
// Kp is Q rounded up to 8, Qp to 16; padded rows are zeros and are never
// stored, and padded columns stay out of the cumsum and the mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;
// l is kept in base 2 (l log2(e)), so that each exp is one exp2f; log2(e)
// is kLog2e + kLog2eLo, the first its float32 rounding
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2eLo = 1.925963033500011e-08f;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

struct Params {
  const float* x;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;
  float* y;
  float* lsum;       // (Bb, nc, H, Q): l log2(e) within each chunk
  float* state;      // (Bb, nc, H, hd, ds): S_c, then S_in
  const float* dy;   // the backward's: the output gradient, in x's strides
  float* dstate;     // the backward's (Bb, nc, H, hd, ds): local[c], then dS_next
  long long xs[3];   // element strides of x over (b, s, h); the last dim is unit
  long long dts[2];  // dt over (b, s)
  long long bs[2];   // B over (b, s)
  long long cs[2];   // C over (b, s)
  long long ys[3];   // y over (b, s, h)
  long long as;      // A over b (0: every row reads the same A over h)
  int Q, H, nc, head_group;
  int vec;           // x, B and C rows move as 16-byte chunks (else 4-byte)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, R) x columns [0, C) of a shared tile, rows `ld` floats apart:
// element (r, c) = src[r * stride + c] by cp.async for r < nr and c < ncol,
// else 0.  C is a multiple of 4; `vec` moves 16 bytes at a time where the
// four columns are all in (src and stride then 16-byte aligned).
__device__ __forceinline__ void load_block(float* dst, int ld, const float* src,
                                           long long stride, int nr, int R, int ncol, int C,
                                           bool vec) {
  const int C4 = C / 4;
  for (int i = threadIdx.x; i < R * C4; i += blockDim.x) {
    const int r = i / C4, c = (i % C4) * 4;
    float* d = dst + r * ld + c;
    const float* s = src + r * stride + c;
    if (vec && r < nr && c + 4 <= ncol) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (r < nr && c + e < ncol) cp_async4(d + e, s + e);
        else d[e] = 0.f;
      }
    }
  }
}

// rows [0, n) of an (n x COLS) tile, global rows `stride` floats apart, into
// shared rows `ld` floats apart by cp.async; rows [n, n_pad) are zeroed
template <int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long stride, int n, int n_pad, bool vec) {
  load_block(dst, ld, src, stride, n, n_pad, COLS, COLS, vec);
}

// hi = a rounded to TF32, lo = the rest a - hi rounded to TF32: what
// cvt.rna.tf32.f32 gives for a finite value (round half away from zero by
// adding half a TF32 ulp to the magnitude bits), without its inf/NaN guard,
// which costs two more instructions each and which finite operands never
// need.  hi's low 13 bits are cleared, since a - hi must be exact; lo's
// need not be, since the tensor core reads only a TF32 operand's upper 19
// bits (ptxas emits cvt.rna for an mma operand the same way).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a b to float32 accuracy, the small cross terms first.  The
// three products go into a fresh accumulator that one float32 add rounds
// into d: the tensor core aligns its addends to the largest and truncates,
// so adding into a running d that has grown larger than this step's
// products would cost units of d's last place per instruction, all in one
// direction, and on sums that cancel the output would err several times
// more than float32's (tests/test_torch_cuda.py's cancelling-sums test).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// A fragment (16 x 8, row): rows r0 and r0 + 8, columns k0 + tig and
// k0 + tig + 4 of a row-major shared tile
__device__ __forceinline__ void load_a(const float* s, int ld, int r0, int k0, int g, int tig,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = s + (r0 + g) * ld + k0 + tig;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// B fragment (8 x 8, col) of an operand stored n-major: element (k, n) at
// s[(n0 + n) * ld + k0 + k]
__device__ __forceinline__ void load_b_nmajor(const float* s, int ld, int n0, int k0, int g,
                                              int tig, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = s + (n0 + g) * ld + k0 + tig;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// s + e = a + b exactly (two-sum); the _rn intrinsics keep the compiler from
// contracting or reordering it
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// l[t] = sum_{u <= t} dt[u] A log2(e) over the chunk's Q rows, by one warp:
// four rows per lane, then a warp scan.  Each term keeps the rounding errors
// of its two products (by fma), and every partial sum is a pair hi + lo
// (two-sum), so that l is rounded once, at the end.  A float32 cumsum errs
// by a few units in the last place of l at Q = 128, and the exps of
// differences of l are only as good as l: on sums that cancel, the output
// inherits that error in full.
__device__ void chunk_cumsum(const float* sdt, float A, int Q, float* sl) {
  const int lane = threadIdx.x & 31;
  constexpr int PER = kMaxQ / 32;
  float vh[PER], vl[PER], rh = 0.f, rl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int t = lane * PER + k;
    if (t < Q) {
      const float p = __fmul_rn(sdt[t], A), pe = fmaf(sdt[t], A, -p);  // p + pe = dt A
      const float h = __fmul_rn(p, kLog2e);
      const float e = fmaf(p, kLog2e, -h) + fmaf(p, kLog2eLo, pe * kLog2e);
      float s, r;
      two_sum(rh, h, s, r);
      rh = s;
      rl += r + e;
    }
    vh[k] = rh;
    vl[k] = rl;
  }
  float ih = rh, il = rl;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nh = __shfl_up_sync(0xffffffffu, ih, off);
    const float nl = __shfl_up_sync(0xffffffffu, il, off);
    if (lane >= off) {
      float s, r;
      two_sum(nh, ih, s, r);
      ih = s;
      il += nl + r;
    }
  }
  float eh = __shfl_up_sync(0xffffffffu, ih, 1), el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) eh = el = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int t = lane * PER + k;
    if (t < Q) {
      float s, r;
      two_sum(eh, vh[k], s, r);
      sl[t] = s + (r + (el + vl[k]));
    }
  }
  __syncwarp();
}

__host__ __device__ constexpr int pad8(int q) { return (q + 7) & ~7; }
__host__ __device__ constexpr int pad16(int q) { return (q + 15) & ~15; }

template <int HD, int DS>
__host__ __device__ constexpr size_t state_smem_floats(int Q) {
  return (size_t)pad8(Q) * (HD + 8 + DS + 8) + 3 * kMaxQ;
}

// pass 1: l, and S_c = (exp(l_Q - l) dt x)^T B, an (hd x ds) product over
// the chunk's rows.  Warps tile it as (hd / 16) x (the rest) m16 x n8 tiles.
// LOCAL (the backward's ssd_bwd_chunk_local) takes the same product to
// local[c] = (exp(l) dy)^T C, the gradient of S_in[c] from chunk c's own
// outputs, for c >= 1, into the dstate scratch, and does not write l.
template <int HD, int DS, bool LOCAL>
__device__ __forceinline__ void chunk_state(const Params& p, int c, int h, int b) {
  constexpr int LDX = HD + 8, LDB = DS + 8;  // 8 mod 32: fragments walk rows by k
  constexpr int MT = HD / 16;                // m tiles (state rows p)
  constexpr int WN = kWarps / MT;            // warps along n
  constexpr int NT = DS / 8;                 // n tiles (state columns d)
  constexpr int NPW = NT / WN > 0 ? NT / WN : 1;
  const int Q = p.Q, Kp = pad8(Q);
  const int tid = threadIdx.x;
  if (LOCAL && c == 0) return;  // S_in[0] is zero: its gradient is never read

  extern __shared__ __align__(16) float smem[];
  float* sx = smem;             // x[s][p] (LOCAL: dy[t][p])
  float* sB = sx + Kp * LDX;    // B[s][d] (LOCAL: C[t][d])
  float* sdt = sB + Kp * LDB;
  float* sl = sdt + kMaxQ;
  float* sdec = sl + kMaxQ;     // exp(l_Q - l_s) dt_s (LOCAL: exp(l_t)), 0 past Q

  const bool last = !LOCAL && c == p.nc - 1;  // its state is never read
  const long long t0 = (long long)c * Q;
  if (!last) {
    load_tile<HD>(sx, LDX, (LOCAL ? p.dy : p.x) + b * p.xs[0] + t0 * p.xs[1] + h * p.xs[2],
                  p.xs[1], Q, Kp, p.vec);
    if (LOCAL)
      load_tile<DS>(sB, LDB, p.C + b * p.cs[0] + t0 * p.cs[1], p.cs[1], Q, Kp, p.vec);
    else
      load_tile<DS>(sB, LDB, p.B + b * p.bs[0] + t0 * p.bs[1], p.bs[1], Q, Kp, p.vec);
    cp_async_commit();
  }
  for (int t = tid; t < Q; t += kThreads) sdt[t] = p.dt[b * p.dts[0] + (t0 + t) * p.dts[1] + h];
  __syncthreads();
  if (tid < 32) {
    chunk_cumsum(sdt, p.A[b * p.as + h], Q, sl);
    float* lg = p.lsum + (((long long)b * p.nc + c) * p.H + h) * Q;
    const float lQ = sl[Q - 1];
    for (int t = tid; t < Kp; t += 32) {
      if (t < Q) {
        if (!LOCAL) lg[t] = sl[t];
        sdec[t] = LOCAL ? exp2f(sl[t]) : exp2f(lQ - sl[t]) * sdt[t];
      } else {
        sdec[t] = 0.f;
      }
    }
  }
  if (last) return;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int mt = warp % MT, n0 = (warp / MT) * NPW;
  if (n0 >= NT) return;  // hd 32, ds 16: four warps hold no tile
  float acc[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float* xa = sx + 16 * mt + g;  // A(p, s) = x[s][p] decay[s]
  for (int k = 0; k < Kp; k += 8) {
    const float d0 = sdec[k + tig], d1 = sdec[k + tig + 4];
    uint32_t ah[4], al[4];
    split(xa[(k + tig) * LDX] * d0, ah[0], al[0]);
    split(xa[(k + tig) * LDX + 8] * d0, ah[1], al[1]);
    split(xa[(k + tig + 4) * LDX] * d1, ah[2], al[2]);
    split(xa[(k + tig + 4) * LDX + 8] * d1, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const float* bp = sB + (k + tig) * LDB + 8 * (n0 + j) + g;  // B(s, d)
      uint32_t bh[2], bl[2];
      split(bp[0], bh[0], bl[0]);
      split(bp[4 * LDB], bh[1], bl[1]);
      mma3(acc[j], ah, al, bh, bl);
    }
  }
  float* sg = (LOCAL ? p.dstate : p.state) + (((long long)b * p.nc + c) * p.H + h) * (HD * DS);
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int d = 8 * (n0 + j) + 2 * tig;
    *reinterpret_cast<float2*>(sg + (16 * mt + g) * DS + d) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(sg + (16 * mt + g + 8) * DS + d) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_state(const Params p) {
  chunk_state<HD, DS, false>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

// pass 2: in place, S_in[c] = exp(l_Q[c-1]) S_in[c-1] + S_{c-1} for c >= 1
// (S_in[0] = 0 is never read and not written).  One thread per four
// consecutive state values of one (batch row, head).  It reads kStateBatch
// chunks' local states at once, so that many loads are in flight, and
// writes each slot only after reading it.
constexpr int kStateBatch = 8;

// The walk of one thread's four state values over the chunks, in place:
// step r reads the slot of chunk c(r) and adds it to the running sum scaled
// by exp(l_Q[c(r)]); the slot of c(r + 1) then takes the sum.  Forwards c(r)
// = r and the slots become S_in; in reverse (the backward's dS_next[c] =
// local[c+1] + exp(l_Q[c+1]) dS_next[c+1]) c(r) = nc - 1 - r.  s and lq
// point at chunk 0 of the slots and of l_Q, step and lstep apart.
__device__ __forceinline__ void scan_chunks(float4* s, const float* lq, long long step,
                                            long long lstep, int nc, bool rev) {
  const int last = nc - 1;  // chunks whose slot is read
  auto at = [&](int r) { return (long long)(rev ? last - r : r); };
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < last; r0 += kStateBatch) {
    float4 v[kStateBatch];
    float lQ[kStateBatch];
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (r0 + k < last) {
        v[k] = s[at(r0 + k) * step];
        lQ[k] = lq[at(r0 + k) * lstep];
      }
    }
    if (r0 > 0) s[at(r0) * step] = run;  // its slot read just above
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (r0 + k < last) {
        const float e = exp2f(lQ[k]);
        run.x = fmaf(e, run.x, v[k].x);
        run.y = fmaf(e, run.y, v[k].y);
        run.z = fmaf(e, run.z, v[k].z);
        run.w = fmaf(e, run.w, v[k].w);
        if (k + 1 < kStateBatch && r0 + k + 1 < last) s[at(r0 + k + 1) * step] = run;
      }
    }
  }
  s[at(last) * step] = run;
}

__global__ void __launch_bounds__(kThreads, 4) ssd_state_pass(const Params p, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // float4 within hd * ds
  if (i >= n4 || p.nc == 1) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float4* s = reinterpret_cast<float4*>(p.state) + ((long long)b * p.nc * p.H + h) * n4 + i;
  const float* lq = p.lsum + ((long long)b * p.nc * p.H + h) * p.Q + p.Q - 1;
  scan_chunks(s, lq, (long long)p.H * n4, (long long)p.H * p.Q, p.nc, false);
}

template <int HD, int DS>
__host__ __device__ constexpr size_t head_buf_floats(int Q) {
  return (size_t)pad16(Q) * (HD + 4) + (size_t)HD * (DS + 4) + 2 * kMaxQ;
}

template <int HD, int DS>
__host__ __device__ constexpr size_t out_smem_floats(int Q) {
  return (size_t)pad16(Q) * (DS + 4)
         + (head_buf_floats<HD, DS>(Q) > (size_t)pad16(Q) * (DS + 4)
                ? head_buf_floats<HD, DS>(Q) : (size_t)pad16(Q) * (DS + 4))
         + head_buf_floats<HD, DS>(Q);
}

// pass 3: G = C B^T once for the head group, then per head
// y = W x + exp(l) (C S_in^T).  Warp w owns the 16 rows t of m tile
// mt(w) and, for G and W, the columns s < 16 (mt + 1); warps w and w + 4
// share a sub-partition of the SM and take m tiles mt and 7 - mt, so the
// causal work is even across sub-partitions.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_out(const Params p) {
  constexpr int LDC = DS + 4, LDX = HD + 4, LDS = DS + 4;  // 4 mod 32: rows walked by g
  constexpr int NTY = HD / 8;     // y n tiles (columns p)
  constexpr int NTG = kMaxQ / 8;  // G n tiles (columns s)
  const int Q = p.Q, Qp = pad16(Q);
  const int c = blockIdx.x, h0 = blockIdx.y * p.head_group, b = blockIdx.z;
  const int nh = min(p.head_group, p.H - h0);
  const int tid = threadIdx.x;
  const long long t0 = (long long)c * Q;

  extern __shared__ __align__(16) float smem[];
  const int hbuf = (int)head_buf_floats<HD, DS>(Q);
  float* sC = smem;             // C[t][d]
  float* sB = sC + Qp * LDC;    // B[s][d], then head buffer 1
  // offsets of head buffers 0 and 1 (offsets, not an array of pointers,
  // which would turn the shared loads into generic ones)
  const int buf0 = Qp * LDC + max(Qp * LDC, hbuf), buf1 = Qp * LDC;

  // x[s][p], S_in[p][d], l and dt of head h0 + i into buffer i % 2; padded
  // rows of x are zeros, padded l and dt are 0
  auto load_head = [&](int i) {
    const int h = h0 + i;
    float* sx = smem + ((i & 1) ? buf1 : buf0);
    float* sS = sx + Qp * LDX;
    float* sl = sS + HD * LDS;
    float* sdt = sl + kMaxQ;
    load_tile<HD>(sx, LDX, p.x + b * p.xs[0] + t0 * p.xs[1] + h * p.xs[2], p.xs[1], Q, Qp,
                  p.vec);
    if (c > 0)
      load_tile<DS>(sS, LDS, p.state + (((long long)b * p.nc + c) * p.H + h) * (HD * DS), DS,
                    HD, HD, true);
    const float* lg = p.lsum + (((long long)b * p.nc + c) * p.H + h) * Q;
    for (int t = tid; t < Qp; t += kThreads) {
      if (t < Q) {
        cp_async4(sl + t, lg + t);
        cp_async4(sdt + t, p.dt + b * p.dts[0] + (t0 + t) * p.dts[1] + h);
      } else {
        sl[t] = 0.f;
        sdt[t] = 0.f;
      }
    }
    cp_async_commit();
  };

  load_tile<DS>(sC, LDC, p.C + b * p.cs[0] + t0 * p.cs[1], p.cs[1], Q, Qp, p.vec);
  load_tile<DS>(sB, LDC, p.B + b * p.bs[0] + t0 * p.bs[1], p.bs[1], Q, Qp, p.vec);
  cp_async_commit();
  load_head(0);
  cp_async_wait<1>();  // C and B; head 0 may still be in flight
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int mt = warp < 4 ? warp : 11 - warp;
  const bool active = 16 * mt < Qp;
  const int r0 = 16 * mt;                      // this warp's rows t: r0 + g, r0 + g + 8
  const int ns = min(2 * mt + 2, pad8(Q) / 8);  // n tiles of columns s it needs

  // G (rows r0.., columns s < 8 ns) in the accumulator layout
  float gacc[NTG][4];
#pragma unroll
  for (int j = 0; j < NTG; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  if (active) {
#pragma unroll 2
    for (int k = 0; k < DS; k += 8) {
      uint32_t ah[4], al[4];
      load_a(sC, LDC, r0, k, g, tig, ah, al);
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        if (j < ns) {
          uint32_t bh[2], bl[2];
          load_b_nmajor(sB, LDC, 8 * j, k, g, tig, bh, bl);  // B(d, s) = B[s][d]
          mma3(gacc[j], ah, al, bh, bl);
        }
      }
    }
  }
  __syncthreads();  // B is read: its place takes head buffer 1

  for (int i = 0; i < nh; ++i) {
    if (i + 1 < nh) {
      load_head(i + 1);  // in flight during this head's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = smem + ((i & 1) ? buf1 : buf0);
    const float* sS = sx + Qp * LDX;
    const float* sl = sS + HD * LDS;
    const float* sdt = sl + kMaxQ;
    if (active) {
      float acc[NTY][4];
#pragma unroll
      for (int n = 0; n < NTY; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      const int ta = r0 + g, tb = ta + 8;
      const float la = sl[ta], lb = sl[tb];
      if (c > 0) {  // exp(l) (C S_in^T); S_in is 0 entering the first chunk
#pragma unroll 2
        for (int k = 0; k < DS; k += 8) {
          uint32_t ah[4], al[4];
          load_a(sC, LDC, r0, k, g, tig, ah, al);
#pragma unroll
          for (int n = 0; n < NTY; ++n) {
            uint32_t bh[2], bl[2];
            load_b_nmajor(sS, LDS, 8 * n, k, g, tig, bh, bl);  // S_in^T(d, p) = S_in[p][d]
            mma3(acc[n], ah, al, bh, bl);
          }
        }
        const float ea = exp2f(la), eb = exp2f(lb);
#pragma unroll
        for (int n = 0; n < NTY; ++n) {
          acc[n][0] *= ea;
          acc[n][1] *= ea;
          acc[n][2] *= eb;
          acc[n][3] *= eb;
        }
      }
      // W x: k step j covers columns s0 = 8 j + 2 tig and s1 = s0 + 1, which
      // this thread holds in gacc[j]; W(t, s) is its A fragment with slots
      // tig <- s0 and tig + 4 <- s1, and x's rows s0, s1 its B fragment
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        if (j < ns) {
          const int s0 = 8 * j + 2 * tig, s1 = s0 + 1;
          const float l0 = sl[s0], l1 = sl[s1], d0 = sdt[s0], d1 = sdt[s1];
          const float waa = ta >= s0 ? exp2f(la - l0) * gacc[j][0] * d0 : 0.f;
          const float wab = ta >= s1 ? exp2f(la - l1) * gacc[j][1] * d1 : 0.f;
          const float wba = tb >= s0 ? exp2f(lb - l0) * gacc[j][2] * d0 : 0.f;
          const float wbb = tb >= s1 ? exp2f(lb - l1) * gacc[j][3] * d1 : 0.f;
          uint32_t ah[4], al[4];
          split(waa, ah[0], al[0]);
          split(wba, ah[1], al[1]);
          split(wab, ah[2], al[2]);
          split(wbb, ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NTY; ++n) {
            uint32_t bh[2], bl[2];
            split(sx[s0 * LDX + 8 * n + g], bh[0], bl[0]);
            split(sx[s1 * LDX + 8 * n + g], bh[1], bl[1]);
            mma3(acc[n], ah, al, bh, bl);
          }
        }
      }
      float* yg = p.y + b * p.ys[0] + t0 * p.ys[1] + (h0 + i) * p.ys[2];
#pragma unroll
      for (int n = 0; n < NTY; ++n) {
        const int q = 8 * n + 2 * tig;
        if (ta < Q) *reinterpret_cast<float2*>(yg + ta * p.ys[1] + q) = make_float2(acc[n][0], acc[n][1]);
        if (tb < Q) *reinterpret_cast<float2*>(yg + tb * p.ys[1] + q) = make_float2(acc[n][2], acc[n][3]);
      }
    }
    __syncthreads();  // this buffer takes the head after next
  }
}

// The caller's grids (its plan), launched as given once they are checked to
// cover the work: pass 1 and pass 3 one block per (chunk, head or head
// group, batch row), pass 2 `scan_threads` threads of four state values each
// over hd * ds, per (head, batch row).
template <int HD, int DS>
cudaError_t launch(const Params& p, int Bb, const int* grid, int scan_threads,
                   cudaStream_t stream) {
  const dim3 g1(grid[0], grid[1], grid[2]), g2(grid[3], grid[4], grid[5]),
      g3(grid[6], grid[7], grid[8]);
  const int groups = (p.H + p.head_group - 1) / p.head_group;
  const int n4 = HD * DS / 4;
  if ((int)g1.x != p.nc || (int)g1.y != p.H || (int)g1.z != Bb || (int)g3.x != p.nc
      || (int)g3.y != groups || (int)g3.z != Bb || (int)g2.y != p.H || (int)g2.z != Bb
      || scan_threads < 32 || scan_threads > kThreads || scan_threads % 32
      || (long long)g2.x * scan_threads < n4 || ((int)g2.x - 1) * scan_threads >= n4)
    return cudaErrorInvalidConfiguration;
  const size_t smem1 = state_smem_floats<HD, DS>(p.Q) * sizeof(float);
  const size_t smem3 = out_smem_floats<HD, DS>(p.Q) * sizeof(float);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ssd_chunk_out<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<HD, DS><<<g1, kThreads, smem1, stream>>>(p);
  ssd_state_pass<<<g2, scan_threads, 0, stream>>>(p, n4);
  ssd_chunk_out<HD, DS><<<g3, kThreads, smem3, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_ds(const Params& p, int Bb, int ds, const int* grid, int scan_threads,
                      cudaStream_t stream) {
  switch (ds) {
    case 16: return launch<HD, 16>(p, Bb, grid, scan_threads, stream);
    case 128: return launch<HD, 128>(p, Bb, grid, scan_threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, const long long* strides, int n) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 4) return false;
  return true;
}

}  // namespace

// float32 only.  hd in {32, 64}, ds in {16, 128}, 1 <= Q <= 128 and
// S % Q == 0.  A is read at A[b * a_stride + h]: a_stride 0 for one A (H,)
// shared by every row, H or more for an A (Bb, H) of one row each.  lsum
// (Bb, S/Q, H, Q) and state (Bb, S/Q, H, hd, ds) are contiguous float32
// scratch from the caller; heads are taken head_group at
// a time in pass 3.  grid holds the three passes' grids, three numbers each
// (kernels/ssd_scan.py::plan), and scan_threads pass 2's block size.
// Launches three kernels on `stream`.  Returns a cudaError_t value (0 on
// success); cudaErrorInvalidValue for a shape the kernel does not take,
// cudaErrorInvalidConfiguration for grids that do not cover it.
extern "C" int ssd_scan_fwd(
    const float* x, const float* dt, const float* B, const float* C, const float* A,
    float* y, float* lsum, float* state, int Bb, int S, int H, int hd, int ds, int Q,
    int head_group, const int* grid, int scan_threads, const long long* x_strides,
    const long long* dt_strides, const long long* b_strides, const long long* c_strides,
    const long long* y_strides, long long a_stride, void* stream) {
  if (Q < 1 || Q > kMaxQ || S % Q != 0 || Bb < 1 || H < 1 || Bb > 65535 || H > 65535
      || head_group < 1)
    return cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.dt = dt; p.B = B; p.C = C; p.A = A; p.y = y;
  p.lsum = lsum; p.state = state; p.as = a_stride;
  for (int i = 0; i < 3; ++i) { p.xs[i] = x_strides[i]; p.ys[i] = y_strides[i]; }
  for (int i = 0; i < 2; ++i) {
    p.dts[i] = dt_strides[i]; p.bs[i] = b_strides[i]; p.cs[i] = c_strides[i];
  }
  p.Q = Q; p.H = H; p.nc = S / Q; p.head_group = head_group;
  p.vec = aligned16(x, x_strides, 3) && aligned16(B, b_strides, 2) && aligned16(C, c_strides, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_ds<32>(p, Bb, ds, grid, scan_threads, st);
    case 64: return launch_ds<64>(p, Bb, ds, grid, scan_threads, st);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------------
// The backward: dx, ddt, dB, dC and dA of the scan at the output gradient dy
// ---------------------------------------------------------------------------------
//
// The JAX package differentiates its oracle (src/repro/models/ssm.py:76
// ssd_scan_ref) with XLA's autodiff; its Pallas kernel has no gradient.  This
// is the port's gradient.  With M = where(t >= s, exp(l_t - l_s), 0) (the
// exponent masked before the exp), decay = exp(l_Q - l), S_in the state
// entering a chunk and dS_next the gradient of the one leaving it, one call
// is six launches, each a block per (chunk, head or head group, batch row)
// unless it says otherwise:
//
// 1. ssd_bwd_chunk_local: the forward's pass 1 (l into the l scratch, S_c
//    into the state scratch) in blocks [0, nc), and in blocks [nc, 2 nc)
//    local[c] = (exp(l) dy)^T C, the gradient of S_in[c] from chunk c's own
//    outputs, into the dstate scratch (Bb, nc, H, hd, ds): the same
//    hd x ds product on the tensor cores, l computed again the same way;
// 2. ssd_bwd_scans, four state values per thread: the forward's pass 2
//    (S_in) and, in its second half of blocks, the reverse walk
//    dS_next[c] = local[c+1] + exp(l_Q[c+1]) dS_next[c+1], both reading
//    kStateBatch chunks at once (scan_chunks);
// 3. ssd_bwd_inter, per head group: B and C loaded once, then per head
//    C S_in^T and B dS_next^T (Q x hd), giving q_t = exp(l_t) dy_t .
//    (C S_in^T)_t, u_s = decay_s x_s . (B dS_next^T)_s, dx = decay dt
//    (B dS_next^T), and kappa = exp(l_Q) <dS_next, S_in>;
// 4. ssd_bwd_intra, per head group: G^T = B C^T once for the group, then
//    per head, on the causal tiles only, dW^T = x dy^T, W = M G dt,
//    dG = dW M dt summed over the group's heads, R = dW W by rows and
//    columns, sum_t dW M G, and dx += W^T dy; then
//      ddt = sum_t dW M G + u + A da,
//    with da_u = sum_{t >= u} dl_t: a compensated reverse scan of
//    q + rowsum(R) - colsum(R), plus a compensated prefix scan of v = dt u
//    (exclusive), plus kappa; sum_u dt_u da_u into dA_part; and the group's
//    dG^T into the dG scratch (Bb, nc, groups, Q, Q);
// 5. ssd_bwd_dbc, per (chunk, batch row, which of dC and dB, 64 columns of
//    ds): one GEMM each with K = H hd + Q,
//      dC = [exp(l) dy for every head | dG] [S_in ; B],
//      dB = [decay dt x for every head | dG^T] [dS_next ; C],
//    K walked in order through a three-stage cp.async ring, dG summed over
//    the groups as its tiles arrive (in group order), and the k steps that
//    the causal mask leaves zero skipped;
// 6. ssd_bwd_da, per head (per (row, head) where A is per row): dA, a sum of
//    dA_part in a fixed order.
// No float atomics: every sum over heads, rows and chunks runs in a fixed
// order, so a second call repeats the first bit for bit.  Every product is
// 3xTF32 on mma.sync (mma3, a fresh accumulator per k step), l a compensated
// sum rounded once (chunk_cumsum), and the two scans of da compensated
// (warp_scan).
//
// What bounds it on an H100.  At the Mamba2 training call (Bb 8, S 2048,
// H 24, hd 64, ds 128, Q 128) the function needs about 37.5 GFLOP (the
// causal halves of G, dG B and dG^T C per (row, chunk); per (row, head) the
// causal halves of dW and W^T dy in every chunk, and five Q x hd x ds
// products in all chunks but one: the chunk state, local, C S_in^T and the
// two dS_next products), against about 339 MB moved (x, dy, dx, and dt, B,
// C with their gradients): 0.227 ms at 3xTF32 (three TF32 products each, at
// 495 TFLOP/s) against 0.10 ms for the bytes.  Beyond the bound it pays for
// the state and dstate scratches (100.7 MB each at that shape: written by
// pass 1, read and written by the scans, read by ssd_bwd_inter and
// ssd_bwd_dbc, about 1 GB in all), for mma.sync, which runs well below
// wgmma's rate, and for the splits of 3xTF32 on the CUDA cores.  So every
// product runs on the tensor cores, the Q x Q products run on their causal
// 16 x 8 tiles only, G is formed once per head group, and dG is summed over
// the group inside the block: 25 MB of dG scratch at that shape, where one
// per head would be 201 MB.  Measured there on an H100 80GB HBM3 at 700 W
// (tools/bwd_compare.py --ssd): 1.75 ms on the device, ssd_bwd_inter,
// ssd_bwd_intra and ssd_bwd_dbc about 0.41 ms each, ssd_bwd_chunk_local
// 0.36 and ssd_bwd_scans 0.14 (near the bytes' rate).  The product passes run
// at about 30 TFLOP/s of 3xTF32 work, as the forward's do: mma.sync and the
// splits bound them.  ssd_bwd_intra loses more to the causal shape: warp 0
// owns 16 of the 72 causal tiles and its sub-partition partner 2, so most of
// a head runs one warp per sub-partition.
//
// Shared memory, in floats, at hd 64, ds 128 (rows padded to conflict-free
// strides, 4 mod 32 where fragments walk rows by g, 8 mod 32 where they walk
// them by k):
//   ssd_bwd_chunk_local: as pass 1 (105.5 KB, two blocks per SM);
//   ssd_bwd_inter: C and B kMaxQ x (ds+4), S_in and dS_next hd x (ds+4)
//     (198 KB, one block per SM);
//   ssd_bwd_intra: the warps' accumulator fragments of G^T and of the
//     group's dG^T sums (72 causal tiles of 128 each; C at the start), two
//     head buffers of x and dy kMaxQ x (hd+4) each with l, dt, u and q (B
//     in the second at the start), and the per-position vectors (219 KB,
//     one block per SM);
//   ssd_bwd_dbc: three stages of an A tile (kMaxQ x 36 or 32 x 136), a B
//     tile 32 x 72, and l and dt, then the groups' dG sum in an A tile's
//     place (102 KB, two blocks per SM).

namespace {

struct BwdParams {
  const float* x;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;
  const float* dy;
  float* dx;
  float* ddt;
  float* dB;
  float* dC;
  float* dA;
  const float* lsum;   // (Bb, nc, H, Q): l log2(e), from pass 1
  const float* state;  // (Bb, nc, H, hd, ds): S_in for c >= 1
  const float* dstate; // (Bb, nc, H, hd, ds): dS_next for c < nc - 1
  float* dG;           // (Bb, nc, groups, Q, Q): dG^T[s][t] summed over a group's heads
  float* u;            // (Bb, nc, H, Q)
  float* q;            // (Bb, nc, H, Q)
  float* kappa;        // (Bb, nc, H)
  float* dA_part;      // (Bb, nc, H): sum_u dt_u da_u per chunk
  long long as;        // A over b (0: every row reads the same A over h)
  int S, H, Q, nc, head_group, groups;
};

// the sum over the block's threads in a fixed order (a shuffle tree in each
// warp, then the warps' sums in order); every thread gets it
__device__ float block_sum(float v, float* sred) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += sred[w];
  __syncthreads();
  return r;
}

// the sum over the four lanes of a fragment row (tig = 0..3); every lane gets it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// out[j] = sum_{k <= j} in[j'] over the scan order (j' = j, or n - 1 - j
// when rev), for j < n <= kMaxQ, by one warp: each partial sum a pair hi +
// lo (two-sum), rounded once, as chunk_cumsum
__device__ void warp_scan(const float* in, float* out, int n, bool rev) {
  const int lane = threadIdx.x & 31;
  constexpr int PER = kMaxQ / 32;
  float vh[PER], vl[PER], rh = 0.f, rl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    if (j < n) {
      float s, r;
      two_sum(rh, in[rev ? n - 1 - j : j], s, r);
      rh = s;
      rl += r;
    }
    vh[k] = rh;
    vl[k] = rl;
  }
  float ih = rh, il = rl;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nh = __shfl_up_sync(0xffffffffu, ih, off);
    const float nl = __shfl_up_sync(0xffffffffu, il, off);
    if (lane >= off) {
      float s, r;
      two_sum(nh, ih, s, r);
      ih = s;
      il += nl + r;
    }
  }
  float eh = __shfl_up_sync(0xffffffffu, ih, 1), el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) eh = el = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    if (j < n) {
      float s, r;
      two_sum(eh, vh[k], s, r);
      out[rev ? n - 1 - j : j] = s + (r + (el + vl[k]));
    }
  }
  __syncwarp();
}

// 1: the forward's pass 1 in blocks [0, nc), local[c] in blocks [nc, 2 nc)
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk_local(const Params p) {
  if ((int)blockIdx.x < p.nc) chunk_state<HD, DS, false>(p, blockIdx.x, blockIdx.y, blockIdx.z);
  else chunk_state<HD, DS, true>(p, blockIdx.x - p.nc, blockIdx.y, blockIdx.z);
}

// 2: S_in forwards in blocks [0, gridDim.x / 2), dS_next in reverse in the rest
__global__ void __launch_bounds__(kThreads, 4) ssd_bwd_scans(const Params p, int n4) {
  const int half = gridDim.x / 2;
  const bool rev = (int)blockIdx.x >= half;
  const int i = ((int)blockIdx.x - (rev ? half : 0)) * blockDim.x + threadIdx.x;
  if (i >= n4 || p.nc == 1) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float4* s = reinterpret_cast<float4*>(rev ? p.dstate : p.state)
              + ((long long)b * p.nc * p.H + h) * n4 + i;
  const float* lq = p.lsum + ((long long)b * p.nc * p.H + h) * p.Q + p.Q - 1;
  scan_chunks(s, lq, (long long)p.H * n4, (long long)p.H * p.Q, p.nc, rev);
}

// 3: per head group.  Warp w owns rows 16 w.. of C S_in^T and B dS_next^T.
template <int HD, int DS>
struct InterSmem {
  static constexpr int LD = DS + 4;  // 4 mod 32: rows walked by g
  static constexpr size_t C = 0, B = (size_t)kMaxQ * LD, Sin = 2 * (size_t)kMaxQ * LD,
                          dSn = Sin + (size_t)HD * LD, red = dSn + (size_t)HD * LD,
                          total = red + kWarps;
};

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_inter(const BwdParams p) {
  using L = InterSmem<HD, DS>;
  constexpr int LD = L::LD, NTP = HD / 8;
  const int c = blockIdx.x, h0 = blockIdx.y * p.head_group, b = blockIdx.z;
  const int nh = min(p.head_group, p.H - h0);
  const int Q = p.Q, Qp = pad16(Q), tid = threadIdx.x;
  const bool first = c == 0, last = c == p.nc - 1;  // S_in = 0; dS_next = 0
  const long long row0 = (long long)b * p.S + (long long)c * Q;

  extern __shared__ __align__(16) float smem[];
  float* sC = smem + L::C;
  float* sB = smem + L::B;
  float* sS = smem + L::Sin;
  float* sD = smem + L::dSn;
  float* sred = smem + L::red;

  auto load_states = [&](int h) {
    const long long hq = ((long long)b * p.nc + c) * p.H + h;
    if (!first) load_tile<DS>(sS, LD, p.state + hq * (HD * DS), DS, HD, HD, true);
    if (!last) load_tile<DS>(sD, LD, p.dstate + hq * (HD * DS), DS, HD, HD, true);
    cp_async_commit();
  };
  if (!first) load_tile<DS>(sC, LD, p.C + row0 * DS, DS, Q, Qp, true);
  if (!last) load_tile<DS>(sB, LD, p.B + row0 * DS, DS, Q, Qp, true);
  load_states(h0);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp, ta = r0 + g, tb = ta + 8;
  const bool active = r0 < Q;
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const long long hq = ((long long)b * p.nc + c) * p.H + h;
    const float* lg = p.lsum + hq * Q;
    const float lQ = lg[Q - 1];
    const float la = ta < Q ? lg[ta] : 0.f, lb = tb < Q ? lg[tb] : 0.f;
    const float dta = ta < Q ? p.dt[(row0 + ta) * p.H + h] : 0.f;
    const float dtb = tb < Q ? p.dt[(row0 + tb) * p.H + h] : 0.f;
    // dy and x at this thread's accumulator positions, read ahead of the products
    float2 ya[NTP], yb[NTP], xa[NTP], xb[NTP];
    const float2 z2 = make_float2(0.f, 0.f);
#pragma unroll
    for (int n = 0; n < NTP; ++n) {
      const long long oa = ((row0 + ta) * p.H + h) * HD + 8 * n + 2 * tig;
      const long long ob = ((row0 + tb) * p.H + h) * HD + 8 * n + 2 * tig;
      ya[n] = !first && ta < Q ? *reinterpret_cast<const float2*>(p.dy + oa) : z2;
      yb[n] = !first && tb < Q ? *reinterpret_cast<const float2*>(p.dy + ob) : z2;
      xa[n] = !last && ta < Q ? *reinterpret_cast<const float2*>(p.x + oa) : z2;
      xb[n] = !last && tb < Q ? *reinterpret_cast<const float2*>(p.x + ob) : z2;
    }
    cp_async_wait<0>();
    __syncthreads();
    float kap = 0.f;
    if (!first && !last) {
      float part = 0.f;
      for (int e = tid; e < HD * DS; e += kThreads)
        part = fmaf(sS[(e / DS) * LD + e % DS], sD[(e / DS) * LD + e % DS], part);
      kap = exp2f(lQ) * block_sum(part, sred);
    }
    float qa = 0.f, qb = 0.f;
    float bd[NTP][4];
#pragma unroll
    for (int n = 0; n < NTP; ++n) bd[n][0] = bd[n][1] = bd[n][2] = bd[n][3] = 0.f;
    if (active && !first) {  // C S_in^T, then q
      float cs[NTP][4];
#pragma unroll
      for (int n = 0; n < NTP; ++n) cs[n][0] = cs[n][1] = cs[n][2] = cs[n][3] = 0.f;
#pragma unroll 2
      for (int k = 0; k < DS; k += 8) {
        uint32_t ah[4], al[4];
        load_a(sC, LD, r0, k, g, tig, ah, al);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t bh[2], bl[2];
          load_b_nmajor(sS, LD, 8 * n, k, g, tig, bh, bl);  // S_in^T(d, p) = S_in[p][d]
          mma3(cs[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        qa = fmaf(ya[n].y, cs[n][1], fmaf(ya[n].x, cs[n][0], qa));
        qb = fmaf(yb[n].y, cs[n][3], fmaf(yb[n].x, cs[n][2], qb));
      }
    }
    if (active && !last) {  // B dS_next^T
#pragma unroll 2
      for (int k = 0; k < DS; k += 8) {
        uint32_t ah[4], al[4];
        load_a(sB, LD, r0, k, g, tig, ah, al);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t bh[2], bl[2];
          load_b_nmajor(sD, LD, 8 * n, k, g, tig, bh, bl);
          mma3(bd[n], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // the states are read: the next head's take their place
    if (i + 1 < nh) load_states(h + 1);
    if (tid == 0) p.kappa[hq] = kap;
    if (active) {
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        ua = fmaf(xa[n].y, bd[n][1], fmaf(xa[n].x, bd[n][0], ua));
        ub = fmaf(xb[n].y, bd[n][3], fmaf(xb[n].x, bd[n][2], ub));
      }
      qa = quad_sum(qa);
      qb = quad_sum(qb);
      ua = quad_sum(ua);
      ub = quad_sum(ub);
      const float deca = exp2f(lQ - la), decb = exp2f(lQ - lb);
      if (tig == 0) {
        if (ta < Q) {
          p.q[hq * Q + ta] = exp2f(la) * qa;
          p.u[hq * Q + ta] = deca * ua;
        }
        if (tb < Q) {
          p.q[hq * Q + tb] = exp2f(lb) * qb;
          p.u[hq * Q + tb] = decb * ub;
        }
      }
      // dx = decay dt (B dS_next^T); ssd_bwd_intra adds W^T dy
      const float sa = deca * dta, sb = decb * dtb;
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        const long long oa = ((row0 + ta) * p.H + h) * HD + 8 * n + 2 * tig;
        const long long ob = ((row0 + tb) * p.H + h) * HD + 8 * n + 2 * tig;
        if (ta < Q)
          *reinterpret_cast<float2*>(p.dx + oa) = make_float2(sa * bd[n][0], sa * bd[n][1]);
        if (tb < Q)
          *reinterpret_cast<float2*>(p.dx + ob) = make_float2(sb * bd[n][2], sb * bd[n][3]);
      }
    }
  }
}

// 4: per head group.  Warp w owns the 16 rows s of m tile mt(w) and the
// causal columns t >= 16 mt; warps w and w + 4 share a sub-partition of the
// SM and take m tiles mt and 7 - mt, so the causal work is even across
// sub-partitions.  Tiles are 16 rows s by 8 columns t in the accumulator
// layout: a warp's tile jj covers columns 8 (2 mt + jj)...
template <int HD, int DS>
struct IntraSmem {
  static constexpr int LDX = HD + 4, LDC = DS + 4;  // 4 mod 32: rows walked by g
  // the causal tiles of a 128-row chunk, sum over mt of 16 - 2 mt, 128
  // floats each (32 lanes x 4): dG^T summed over the group's heads, then G^T
  static constexpr size_t frag = 72 * 128;
  static constexpr size_t cs = (size_t)kMaxQ * LDC;
  static constexpr size_t D = 2 * frag > cs ? 2 * frag : cs;  // C in its place at the start
  // a head buffer: x, dy, then l, dt, u and q
  static constexpr size_t head = 2 * (size_t)kMaxQ * LDX + 4 * kMaxQ;
  static constexpr size_t buf0 = D, buf1 = D + head;  // B in buffer 1 at the start
  static constexpr size_t vec = buf1 + (head > cs ? head : cs);
  // row sums of R by m tile, column sums of R and of dW M G, e, its scan,
  // ddt's part and v, then the block sum's
  static constexpr size_t total = vec + kWarps * kMaxQ + 6 * kMaxQ + kWarps;
};

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_intra(const BwdParams p) {
  using L = IntraSmem<HD, DS>;
  constexpr int LDX = L::LDX, LDC = L::LDC, NTP = HD / 8, NTT = kMaxQ / 8;
  const int c = blockIdx.x, grp = blockIdx.y, h0 = grp * p.head_group, b = blockIdx.z;
  const int nh = min(p.head_group, p.H - h0);
  const int Q = p.Q, Qp = pad16(Q), NTq = pad8(Q) / 8, tid = threadIdx.x;
  const long long row0 = (long long)b * p.S + (long long)c * Q;

  extern __shared__ __align__(16) float smem[];
  float* srowR = smem + L::vec;  // [mt][t]: sum over the m tile's rows s of R[t][s]
  float* scolR = srowR + kWarps * kMaxQ;
  float* scolD = scolR + kMaxQ;
  float* se = scolD + kMaxQ;
  float* sscan = se + kMaxQ;
  float* sdd = sscan + kMaxQ;
  float* sv = sdd + kMaxQ;
  float* sred = sv + kMaxQ;

  // x[s][p], dy[t][p], l, dt, u and q of head h0 + i into buffer i % 2;
  // padded rows are zeros
  auto load_head = [&](int i) {
    const int h = h0 + i;
    float* sx = smem + ((i & 1) ? L::buf1 : L::buf0);
    float* sdy = sx + kMaxQ * LDX;
    float* sl = sdy + kMaxQ * LDX;
    float* sdt = sl + kMaxQ;
    float* su = sdt + kMaxQ;
    float* sq = su + kMaxQ;
    const long long xo = (row0 * p.H + h) * HD;
    load_tile<HD>(sx, LDX, p.x + xo, (long long)p.H * HD, Q, Qp, true);
    load_tile<HD>(sdy, LDX, p.dy + xo, (long long)p.H * HD, Q, Qp, true);
    const long long hq = ((long long)b * p.nc + c) * p.H + h;
    for (int t = tid; t < Qp; t += kThreads) {
      if (t < Q) {
        cp_async4(sl + t, p.lsum + hq * Q + t);
        cp_async4(sdt + t, p.dt + (row0 + t) * p.H + h);
        cp_async4(su + t, p.u + hq * Q + t);
        cp_async4(sq + t, p.q + hq * Q + t);
      } else {
        sl[t] = sdt[t] = su[t] = sq[t] = 0.f;
      }
    }
    cp_async_commit();
  };

  load_tile<DS>(smem, LDC, p.C + row0 * DS, DS, Q, Qp, true);
  load_tile<DS>(smem + L::buf1, LDC, p.B + row0 * DS, DS, Q, Qp, true);
  cp_async_commit();
  load_head(0);
  cp_async_wait<1>();  // C and B; head 0 may still be in flight
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int mt = warp < 4 ? warp : 11 - warp;
  const int r0 = 16 * mt, j0 = 2 * mt;  // rows s r0.., first column tile
  const bool active = r0 < Q;
  const int sa = r0 + g, sb = sa + 8;
  // this lane's accumulator fragments of the warp's tiles, tile jj at
  // + 128 jj: the dG^T sums, and G^T
  float* frag = smem + (size_t)(mt * (17 - mt)) * 128 + lane * 4;
  float* gfrag = frag + L::frag;

  // G^T (rows s, columns t >= r0) in the accumulator layout
  float gacc[NTT][4];
#pragma unroll
  for (int j = 0; j < NTT; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  if (active) {
    const float* sB = smem + L::buf1;
#pragma unroll 2
    for (int k = 0; k < DS; k += 8) {
      uint32_t ah[4], al[4];
      load_a(sB, LDC, r0, k, g, tig, ah, al);  // B[s][d]
#pragma unroll
      for (int jj = 0; jj < NTT; ++jj) {
        if (j0 + jj < NTq) {
          uint32_t bh[2], bl[2];
          load_b_nmajor(smem, LDC, 8 * (j0 + jj), k, g, tig, bh, bl);  // C^T(d, t) = C[t][d]
          mma3(gacc[jj], ah, al, bh, bl);
        }
      }
    }
  }
  __syncthreads();  // B and C are read: C's place takes G^T and the dG^T sums, B's head buffer 1
  if (active) {
#pragma unroll
    for (int jj = 0; jj < NTT; ++jj) {
      if (j0 + jj < NTq) {
        *reinterpret_cast<float4*>(gfrag + 128 * jj) =
            make_float4(gacc[jj][0], gacc[jj][1], gacc[jj][2], gacc[jj][3]);
        *reinterpret_cast<float4*>(frag + 128 * jj) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  for (int i = 0; i < nh; ++i) {
    if (i + 1 < nh) {
      load_head(i + 1);  // in flight during this head's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = h0 + i;
    const long long hq = ((long long)b * p.nc + c) * p.H + h;
    const float* sx = smem + ((i & 1) ? L::buf1 : L::buf0);
    const float* sdy = sx + kMaxQ * LDX;
    const float* sl = sdy + kMaxQ * LDX;
    const float* sdt = sl + kMaxQ;
    const float* su = sdt + kMaxQ;
    const float* sq = su + kMaxQ;
    // read ahead of the products: kappa and A for da, and dx as
    // ssd_bwd_inter wrote it, decay dt (B dS_next^T)
    const float kappa = p.kappa[hq], Ah = p.A[b * p.as + h];
    float* dxg = p.dx + (row0 * p.H + h) * HD + 2 * tig;  // + t H HD + 8 n
    const long long xrow = (long long)p.H * HD;
    float2 dxi[NTP][2];
#pragma unroll
    for (int n = 0; n < NTP; ++n) {
      dxi[n][0] = active && sa < Q ? *reinterpret_cast<const float2*>(dxg + sa * xrow + 8 * n)
                                   : make_float2(0.f, 0.f);
      dxi[n][1] = active && sb < Q ? *reinterpret_cast<const float2*>(dxg + sb * xrow + 8 * n)
                                   : make_float2(0.f, 0.f);
    }
    if (active) {
      float dxa[NTP][4];
#pragma unroll
      for (int n = 0; n < NTP; ++n) dxa[n][0] = dxa[n][1] = dxa[n][2] = dxa[n][3] = 0.f;
      float cra = 0.f, crb = 0.f, cda = 0.f, cdb = 0.f;  // column sums of R, dW M G at sa, sb
      const float lsa = sl[sa], lsb = sl[sb], dsa = sdt[sa], dsb = sdt[sb];
      // two tiles at a time, ja and jb: one split of x's A fragment per k
      // step serves both product chains.  No branch inside: where a warp's
      // tiles are odd in number (Q not a multiple of 16) the pair's second
      // tile repeats its first with every contribution selected to zero,
      // so ptxas can interleave the two tiles' chains.  G^T is in shared
      // memory, so the loop needs no register array of constant index.
#pragma unroll 1
      for (int ja = j0; ja < NTq; ja += 2) {
        const bool live_b = ja + 1 < NTq;
        const int jb = live_b ? ja + 1 : ja;
        float dw[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // dW^T[s][t] = x_s . dy_t
#pragma unroll
        for (int k = 0; k < HD; k += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          load_a(sx, LDX, r0, k, g, tig, ah, al);
          load_b_nmajor(sdy, LDX, 8 * ja, k, g, tig, bh, bl);  // dy^T(p, t) = dy[t][p]
          mma3(dw[0], ah, al, bh, bl);
          load_b_nmajor(sdy, LDX, 8 * jb, k, g, tig, bh, bl);
          mma3(dw[1], ah, al, bh, bl);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = u ? jb : ja, jj = j - j0;
          const bool live = u == 0 || live_b;
          const int t0 = 8 * j + 2 * tig, t1 = t0 + 1;
          const float l0 = sl[t0], l1 = sl[t1];
          const float m0 = live && t0 >= sa && t0 < Q ? exp2f(l0 - lsa) : 0.f;
          const float m1 = live && t1 >= sa && t1 < Q ? exp2f(l1 - lsa) : 0.f;
          const float m2 = live && t0 >= sb && t0 < Q ? exp2f(l0 - lsb) : 0.f;
          const float m3 = live && t1 >= sb && t1 < Q ? exp2f(l1 - lsb) : 0.f;
          const float4 gv = *reinterpret_cast<const float4*>(gfrag + 128 * jj);
          const float mg0 = m0 * gv.x, mg1 = m1 * gv.y, mg2 = m2 * gv.z, mg3 = m3 * gv.w;
          const float w0 = mg0 * dsa, w1 = mg1 * dsa, w2 = mg2 * dsb, w3 = mg3 * dsb;
          const float q0 = dw[u][0] * w0, q1 = dw[u][1] * w1;
          const float q2 = dw[u][2] * w2, q3 = dw[u][3] * w3;
          cra += q0 + q1;
          crb += q2 + q3;
          cda = fmaf(dw[u][1], mg1, fmaf(dw[u][0], mg0, cda));
          cdb = fmaf(dw[u][3], mg3, fmaf(dw[u][2], mg2, cdb));
          // R's sums over this warp's 16 rows s, for columns t0 and t1
          float c0 = q0 + q2, c1 = q1 + q3;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, off);
            c1 += __shfl_xor_sync(0xffffffffu, c1, off);
          }
          if (g == 0 && live) {
            srowR[mt * kMaxQ + t0] = c0;
            srowR[mt * kMaxQ + t1] = c1;
          }
          // dG^T, summed over the group's heads in head order
          float4* f = reinterpret_cast<float4*>(frag + 128 * jj);
          float4 acc = *f;
          acc.x += dw[u][0] * m0 * dsa;
          acc.y += dw[u][1] * m1 * dsa;
          acc.z += dw[u][2] * m2 * dsb;
          acc.w += dw[u][3] * m3 * dsb;
          *f = acc;
          // dx += W^T dy: this tile is the A fragment of k step j, slots
          // tig <- column t0 and tig + 4 <- t1, and dy's rows t0, t1 its B
          // fragment, which leaves the sum over t unchanged
          uint32_t wh[4], wl[4];
          split(w0, wh[0], wl[0]);
          split(w2, wh[1], wl[1]);
          split(w1, wh[2], wl[2]);
          split(w3, wh[3], wl[3]);
#pragma unroll
          for (int n = 0; n < NTP; ++n) {
            uint32_t bh[2], bl[2];
            split(sdy[t0 * LDX + 8 * n + g], bh[0], bl[0]);
            split(sdy[t1 * LDX + 8 * n + g], bh[1], bl[1]);
            mma3(dxa[n], wh, wl, bh, bl);
          }
        }
      }
      cra = quad_sum(cra);
      crb = quad_sum(crb);
      cda = quad_sum(cda);
      cdb = quad_sum(cdb);
      if (tig == 0) {
        scolR[sa] = cra;
        scolR[sb] = crb;
        scolD[sa] = cda;
        scolD[sb] = cdb;
      }
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        if (sa < Q)
          *reinterpret_cast<float2*>(dxg + sa * xrow + 8 * n) =
              make_float2(dxi[n][0].x + dxa[n][0], dxi[n][0].y + dxa[n][1]);
        if (sb < Q)
          *reinterpret_cast<float2*>(dxg + sb * xrow + 8 * n) =
              make_float2(dxi[n][1].x + dxa[n][2], dxi[n][1].y + dxa[n][3]);
      }
    }
    __syncthreads();
    // e = q + rowsum(R) - colsum(R), and sum_t dW M G + u
    if (tid < Q) {
      float rr = 0.f;
      for (int m = 0; m <= tid / 16; ++m) rr += srowR[m * kMaxQ + tid];
      se[tid] = sq[tid] + rr - scolR[tid];
      sdd[tid] = scolD[tid] + su[tid];
      sv[tid] = sdt[tid] * su[tid];  // v, scanned in place below
    }
    __syncthreads();
    // da_u = sum_{t >= u} e_t + sum_{s < u} v_s + kappa, the two scans by
    // two warps at once
    if (warp == 0) warp_scan(se, sscan, Q, true);
    else if (warp == 1) warp_scan(sv, sv, Q, false);
    __syncthreads();
    float contrib = 0.f;
    if (tid < Q) {
      const float da = sscan[tid] + ((tid > 0 ? sv[tid - 1] : 0.f) + kappa);
      p.ddt[(row0 + tid) * p.H + h] = fmaf(Ah, da, sdd[tid]);
      contrib = sdt[tid] * da;
    }
    const float dA = block_sum(contrib, sred);  // ends in a sync: the buffer is free
    if (tid == 0) p.dA_part[hq] = dA;
  }

  // the group's dG^T into the scratch, zeros left of the warp's tiles
  if (active) {
    float* dg = p.dG + (((long long)b * p.nc + c) * p.groups + grp) * Q * Q;
#pragma unroll
    for (int jj = 0; jj < NTT; ++jj) {
      const int t0 = 8 * (j0 + jj) + 2 * tig, t1 = t0 + 1;
      if (j0 + jj < NTq) {
        const float4 v = *reinterpret_cast<const float4*>(frag + 128 * jj);
        if (sa < Q && t0 < Q) dg[sa * Q + t0] = v.x;
        if (sa < Q && t1 < Q) dg[sa * Q + t1] = v.y;
        if (sb < Q && t0 < Q) dg[sb * Q + t0] = v.z;
        if (sb < Q && t1 < Q) dg[sb * Q + t1] = v.w;
      }
    }
    for (int e = lane; e < 16 * r0; e += 32) {
      const int s = r0 + e / r0, t = e % r0;
      if (s < Q) dg[s * Q + t] = 0.f;
    }
  }
}

// 5: one GEMM per (chunk, batch row, which of dC and dB, DT columns of ds)
template <int DS>
struct DbcShape {
  static constexpr int DT = DS < 64 ? DS : 64;          // columns d per block
  static constexpr int WN = DT / 32 > 0 ? DT / 32 : 1;  // warps along d
  static constexpr int NTW = DT / 8 / WN;               // n tiles per warp
  static constexpr int WM = kWarps / WN;                // warps along the rows
  static constexpr int MTW = kMaxQ / 16 / WM;           // m tiles per warp
  static constexpr int KT = 32;                         // k per stage
  static constexpr int LDA = KT + 4;                    // A [m][k]: 4 mod 32
  static constexpr int LDK = kMaxQ + 8;                 // A [k][m]: 8 mod 32
  static constexpr int LDB = DT + 8;                    // B [k][n]: 8 or 24 mod 32
  static constexpr size_t A = (size_t)kMaxQ * LDA > (size_t)KT * LDK ? (size_t)kMaxQ * LDA
                                                                     : (size_t)KT * LDK;
  static constexpr size_t stage = A + (size_t)KT * LDB + 2 * kMaxQ;  // A, B, l, dt
  static constexpr int kStages = 3;
  static constexpr size_t sum = kStages * stage;  // the groups' dG tiles summed
  static constexpr size_t total = sum + A;
};

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dbc(const BwdParams p) {
  using L = DbcShape<DS>;
  constexpr int KT = L::KT, MTW = L::MTW, NTW = L::NTW;
  const int c = blockIdx.x, b = blockIdx.y, which = blockIdx.z & 1;  // 0: dC, 1: dB
  const int d0 = (blockIdx.z >> 1) * L::DT;
  const int Q = p.Q, Qp = pad16(Q), tid = threadIdx.x;
  const long long row0 = (long long)b * p.S + (long long)c * Q;
  // the heads' part: dy S_in (S_in = 0 entering the first chunk), x dS_next
  // (dS_next = 0 leaving the last)
  const bool heads = which == 0 ? c > 0 : c < p.nc - 1;
  const int kt_head = heads ? p.H * HD / KT : 0, kt_dg = (Q + KT - 1) / KT;
  const int nkt = kt_head + p.groups * kt_dg;
  const bool vecQ = Q % 4 == 0;

  extern __shared__ __align__(16) float smem[];
  auto load = [&](int kt) {
    float* sA = smem + (kt % L::kStages) * L::stage;
    float* sBt = sA + L::A;
    float* sl = sBt + KT * L::LDB;
    float* sdt = sl + kMaxQ;
    if (kt < kt_head) {
      const int h = kt * KT / HD, p0 = kt * KT % HD;
      const long long hq = ((long long)b * p.nc + c) * p.H + h;
      // A(t, (h, p)) = dy[t][h][p] (or x), scaled at the fragment by exp(l_t)
      // (or decay_t dt_t); B((h, p), d) = S_in[h][p][d] (or dS_next)
      load_tile<KT>(sA, L::LDA, (which == 0 ? p.dy : p.x) + (row0 * p.H + h) * HD + p0,
                    (long long)p.H * HD, Q, Qp, true);
      load_tile<L::DT>(sBt, L::LDB, (which == 0 ? p.state : p.dstate) + (hq * HD + p0) * DS + d0,
                       DS, KT, KT, true);
      for (int t = tid; t < Qp; t += kThreads) {
        if (t < Q) {
          cp_async4(sl + t, p.lsum + hq * Q + t);
          cp_async4(sdt + t, p.dt + (row0 + t) * p.H + h);
        } else {
          sl[t] = sdt[t] = 0.f;
        }
      }
    } else {  // k tile kd / groups of the dG part, group kd % groups; B with the last group
      const int kd = kt - kt_head, grp = kd % p.groups, k0 = (kd / p.groups) * KT;
      const int nk = min(KT, Q - k0);
      const bool with_b = grp == p.groups - 1;
      const float* dg = p.dG + (((long long)b * p.nc + c) * p.groups + grp) * Q * Q;
      if (which == 0) {  // A(t, s) = dG^T[s][t], k-major; B(s, d) = B[s][d]
        load_block(sA, L::LDK, dg + (long long)k0 * Q, Q, nk, KT, Q, Qp, vecQ);
        if (with_b) load_tile<L::DT>(sBt, L::LDB, p.B + (row0 + k0) * DS + d0, DS, nk, KT, true);
      } else {           // A(s, t) = dG^T[s][t]; B(t, d) = C[t][d]
        load_block(sA, L::LDA, dg + k0, Q, Q, Qp, nk, KT, vecQ);
        if (with_b) load_tile<L::DT>(sBt, L::LDB, p.C + (row0 + k0) * DS + d0, DS, nk, KT, true);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[MTW][NTW][4];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTW; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < nkt) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + L::kStages - 1 < nkt) load(kt + L::kStages - 1);
    cp_async_commit();
    const float* sA = smem + (kt % L::kStages) * L::stage;
    const float* sBt = sA + L::A;
    const float* sl = sBt + KT * L::LDB;
    const float* sdt = sl + kMaxQ;
    const bool head = kt < kt_head;
    const int kd = kt - kt_head, grp = head ? 0 : kd % p.groups;
    const int kd0 = head ? 0 : (kd / p.groups) * KT;  // s (dC) or t (dB) of column 0
    const float* a = sA;
    if (!head && p.groups > 1) {
      // the groups' dG tiles summed in group order, each thread its own
      // float4s, before one product with B
      const int rows = which == 0 ? KT : Qp, c4 = (which == 0 ? Qp : KT) / 4;
      const int ld = which == 0 ? L::LDK : L::LDA;
      float* sum = smem + L::sum;
      for (int i = tid; i < rows * c4; i += kThreads) {
        const int off = (i / c4) * ld + (i % c4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(sA + off);
        float4* sp = reinterpret_cast<float4*>(sum + off);
        if (grp == 0) {
          *sp = v;
        } else {
          const float4 w = *sp;
          *sp = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
        }
      }
      if (grp < p.groups - 1) continue;
      __syncthreads();  // every thread's part of the sum is in
      a = sum;
    }
    float sc[MTW][2];  // the heads' row scales
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) {
      const int ra = 16 * (wm * MTW + mi) + g, rb = ra + 8;
      sc[mi][0] = sc[mi][1] = 1.f;
      if (head && ra < Qp) {
        const float lQ = sl[Q - 1];
        sc[mi][0] = which == 0 ? exp2f(sl[ra]) : exp2f(lQ - sl[ra]) * sdt[ra];
        sc[mi][1] = which == 0 ? exp2f(sl[rb]) : exp2f(lQ - sl[rb]) * sdt[rb];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      // the m tiles that this k step reaches: the causal mask zeroes dG^T[s][t] for t < s
      bool on[MTW];
      bool any = false;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        const int m0 = 16 * (wm * MTW + mi), k = kd0 + kk;
        on[mi] = m0 < Qp && (head || (which == 0 ? k <= m0 + 15 : k + 7 >= m0));
        any = any || on[mi];
      }
      if (!any) continue;
      uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) {
        const float* bp = sBt + (kk + tig) * L::LDB + 8 * (wn * NTW + ni) + g;
        split(bp[0], bh[ni][0], bl[ni][0]);
        split(bp[4 * L::LDB], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        if (!on[mi]) continue;
        const int m0 = 16 * (wm * MTW + mi);
        uint32_t ah[4], al[4];
        if (head) {
          const float* ap = a + (m0 + g) * L::LDA + kk + tig;
          split(ap[0] * sc[mi][0], ah[0], al[0]);
          split(ap[8 * L::LDA] * sc[mi][1], ah[1], al[1]);
          split(ap[4] * sc[mi][0], ah[2], al[2]);
          split(ap[8 * L::LDA + 4] * sc[mi][1], ah[3], al[3]);
        } else if (which == 1) {
          load_a(a, L::LDA, m0, kk, g, tig, ah, al);
        } else {
          const float* ap = a + (kk + tig) * L::LDK + m0 + g;  // A(m, k) = a[k][m]
          split(ap[0], ah[0], al[0]);
          split(ap[8], ah[1], al[1]);
          split(ap[4 * L::LDK], ah[2], al[2]);
          split(ap[4 * L::LDK + 8], ah[3], al[3]);
        }
#pragma unroll
        for (int ni = 0; ni < NTW; ++ni) mma3(acc[mi][ni], ah, al, bh[ni], bl[ni]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = which == 0 ? p.dC : p.dB;
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
    const int ra = 16 * (wm * MTW + mi) + g, rb = ra + 8;
#pragma unroll
    for (int ni = 0; ni < NTW; ++ni) {
      const int d = d0 + 8 * (wn * NTW + ni) + 2 * tig;
      if (ra < Q)
        *reinterpret_cast<float2*>(out + (row0 + ra) * DS + d) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (rb < Q)
        *reinterpret_cast<float2*>(out + (row0 + rb) * DS + d) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// 6: dA[h] (A shared: per_row 0) or dA[r][h] (A per row), a sum of the
// partials of its rows and chunks in a fixed order
__global__ void __launch_bounds__(kThreads) ssd_bwd_da(const BwdParams p, int Bb, int per_row) {
  __shared__ float sred[kWarps];
  const int h = blockIdx.x, r = blockIdx.y;
  const int n = per_row ? p.nc : Bb * p.nc;
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long bc = per_row ? (long long)r * p.nc + i : i;  // (row, chunk)
    v += p.dA_part[bc * p.H + h];
  }
  v = block_sum(v, sred);
  if (threadIdx.x == 0) p.dA[per_row ? (long long)r * p.H + h : h] = v;
}

bool grid_is(const int* g, int x, int y, int z) { return g[0] == x && g[1] == y && g[2] == z; }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD, int DS>
cudaError_t launch_bwd(const Params& fp, const BwdParams& p, int Bb, int per_row,
                       const int* grid, cudaStream_t stream) {
  const int n4 = HD * DS / 4, scan_blocks = (n4 + kThreads - 1) / kThreads;
  const int groups = (p.H + p.head_group - 1) / p.head_group;
  if (p.groups != groups || !grid_is(grid, 2 * p.nc, p.H, Bb)
      || !grid_is(grid + 3, 2 * scan_blocks, p.H, Bb) || !grid_is(grid + 6, p.nc, groups, Bb)
      || !grid_is(grid + 9, p.nc, groups, Bb)
      || !grid_is(grid + 12, p.nc, Bb, 2 * DS / DbcShape<DS>::DT)
      || !grid_is(grid + 15, p.H, per_row ? Bb : 1, 1))
    return cudaErrorInvalidConfiguration;
  const dim3 g[6] = {dim3(grid[0], grid[1], grid[2]), dim3(grid[3], grid[4], grid[5]),
                     dim3(grid[6], grid[7], grid[8]), dim3(grid[9], grid[10], grid[11]),
                     dim3(grid[12], grid[13], grid[14]), dim3(grid[15], grid[16], grid[17])};
  const size_t smem1 = state_smem_floats<HD, DS>(p.Q) * sizeof(float);
  const size_t smemI = InterSmem<HD, DS>::total * sizeof(float);
  const size_t smemH = IntraSmem<HD, DS>::total * sizeof(float);
  const size_t smemD = DbcShape<DS>::total * sizeof(float);
  cudaError_t err = set_smem(ssd_bwd_chunk_local<HD, DS>, smem1);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_inter<HD, DS>, smemI);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_intra<HD, DS>, smemH);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_dbc<HD, DS>, smemD);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_local<HD, DS><<<g[0], kThreads, smem1, stream>>>(fp);
  ssd_bwd_scans<<<g[1], kThreads, 0, stream>>>(fp, n4);
  ssd_bwd_inter<HD, DS><<<g[2], kThreads, smemI, stream>>>(p);
  ssd_bwd_intra<HD, DS><<<g[3], kThreads, smemH, stream>>>(p);
  ssd_bwd_dbc<HD, DS><<<g[4], kThreads, smemD, stream>>>(p);
  ssd_bwd_da<<<g[5], kThreads, 0, stream>>>(p, Bb, per_row);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_ds(const Params& fp, const BwdParams& p, int Bb, int ds, int per_row,
                          const int* grid, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch_bwd<HD, 16>(fp, p, Bb, per_row, grid, stream);
    case 128: return launch_bwd<HD, 128>(fp, p, Bb, per_row, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward.  float32, every tensor contiguous: x, dy and dx (Bb,S,H,hd),
// dt and ddt (Bb,S,H), B, C, dB and dC (Bb,S,ds), A and dA (H,) or (Bb,H)
// (per_row_a 1; A read at A[b * a_stride + h]).  hd in {32, 64}, ds in
// {16, 128}, 1 <= Q <= 128 and S % Q == 0; heads are taken head_group at a
// time.  Scratch from the caller, contiguous float32: lsum (Bb, S/Q, H, Q),
// state and dstate (Bb, S/Q, H, hd, ds), dG (Bb, S/Q, groups, Q, Q), u and q
// (Bb, S/Q, H, Q), kappa and dA_part (Bb, S/Q, H).  grid holds the six
// launches' grids, three numbers each (kernels/ssd_scan_bwd.py::plan).
// Launches six kernels on `stream`; returns a cudaError_t value (0 on
// success; cudaErrorInvalidConfiguration for grids that do not cover the
// work).
extern "C" int ssd_scan_bwd(
    const float* x, const float* dt, const float* B, const float* C, const float* A,
    const float* dy, float* dx, float* ddt, float* dB, float* dC, float* dA, float* lsum,
    float* state, float* dstate, float* dG, float* u, float* q, float* kappa, float* dA_part,
    int Bb, int S, int H, int hd, int ds, int Q, int head_group, long long a_stride,
    int per_row_a, const int* grid, void* stream) {
  if (Q < 1 || Q > kMaxQ || S % Q != 0 || Bb < 1 || H < 1 || Bb > 65535 || H > 65535
      || head_group < 1)
    return cudaErrorInvalidValue;
  Params fp = {};
  fp.x = x; fp.dt = dt; fp.B = B; fp.C = C; fp.A = A; fp.dy = dy;
  fp.lsum = lsum; fp.state = state; fp.dstate = dstate; fp.as = a_stride;
  fp.xs[0] = (long long)S * H * hd; fp.xs[1] = (long long)H * hd; fp.xs[2] = hd;
  fp.dts[0] = (long long)S * H; fp.dts[1] = H;
  fp.bs[0] = fp.cs[0] = (long long)S * ds; fp.bs[1] = fp.cs[1] = ds;
  fp.Q = Q; fp.H = H; fp.nc = S / Q;
  fp.vec = aligned16(x, fp.xs, 3) && aligned16(dy, fp.xs, 3) && aligned16(B, fp.bs, 2)
           && aligned16(C, fp.cs, 2);
  BwdParams p;
  p.x = x; p.dt = dt; p.B = B; p.C = C; p.A = A; p.dy = dy;
  p.dx = dx; p.ddt = ddt; p.dB = dB; p.dC = dC; p.dA = dA;
  p.lsum = lsum; p.state = state; p.dstate = dstate; p.dG = dG;
  p.u = u; p.q = q; p.kappa = kappa; p.dA_part = dA_part;
  p.as = a_stride; p.S = S; p.H = H; p.Q = Q; p.nc = S / Q;
  p.head_group = head_group; p.groups = (H + head_group - 1) / head_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_bwd_ds<32>(fp, p, Bb, ds, per_row_a, grid, st);
    case 64: return launch_bwd_ds<64>(fp, p, Bb, ds, per_row_a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}
