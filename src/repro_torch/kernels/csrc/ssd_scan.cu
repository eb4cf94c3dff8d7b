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

// rows [0, n) of an (n x COLS) tile, global rows `stride` floats apart, into
// shared rows `ld` floats apart by cp.async; rows [n, n_pad) are zeroed
template <int COLS>
__device__ void load_tile(float* dst, int ld, const float* src, long long stride, int n,
                          int n_pad, bool vec) {
  if (vec) {
    constexpr int C4 = COLS / 4;
    for (int i = threadIdx.x; i < n * C4; i += blockDim.x) {
      const int t = i / C4, q = (i % C4) * 4;
      cp_async16(dst + t * ld + q, src + t * stride + q);
    }
  } else {
    for (int i = threadIdx.x; i < n * COLS; i += blockDim.x) {
      const int t = i / COLS, q = i % COLS;
      cp_async4(dst + t * ld + q, src + t * stride + q);
    }
  }
  for (int i = threadIdx.x; i < (n_pad - n) * COLS; i += blockDim.x)
    dst[(n + i / COLS) * ld + i % COLS] = 0.f;
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
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_state(const Params p) {
  constexpr int LDX = HD + 8, LDB = DS + 8;  // 8 mod 32: fragments walk rows by k
  constexpr int MT = HD / 16;                // m tiles (state rows p)
  constexpr int WN = kWarps / MT;            // warps along n
  constexpr int NT = DS / 8;                 // n tiles (state columns d)
  constexpr int NPW = NT / WN > 0 ? NT / WN : 1;
  const int Q = p.Q, Kp = pad8(Q);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* sx = smem;             // x[s][p]
  float* sB = sx + Kp * LDX;    // B[s][d]
  float* sdt = sB + Kp * LDB;
  float* sl = sdt + kMaxQ;
  float* sdec = sl + kMaxQ;     // exp(l_Q - l_s) dt_s, 0 past Q

  const bool last = c == p.nc - 1;  // its state is never read
  const long long t0 = (long long)c * Q;
  if (!last) {
    load_tile<HD>(sx, LDX, p.x + b * p.xs[0] + t0 * p.xs[1] + h * p.xs[2], p.xs[1], Q, Kp,
                  p.vec);
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
        lg[t] = sl[t];
        sdec[t] = exp2f(lQ - sl[t]) * sdt[t];
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
  float* sg = p.state + (((long long)b * p.nc + c) * p.H + h) * (HD * DS);
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int d = 8 * (n0 + j) + 2 * tig;
    *reinterpret_cast<float2*>(sg + (16 * mt + g) * DS + d) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(sg + (16 * mt + g + 8) * DS + d) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// pass 2: in place, S_in[c] = exp(l_Q[c-1]) S_in[c-1] + S_{c-1} for c >= 1
// (S_in[0] = 0 is never read and not written).  One thread per four
// consecutive state values of one (batch row, head).  It reads kStateBatch
// chunks' local states at once, so that many loads are in flight, and
// writes each slot only after reading it.
constexpr int kStateBatch = 8;

__global__ void __launch_bounds__(kThreads, 4) ssd_state_pass(const Params p, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // float4 within hd * ds
  const int last = p.nc - 1;                          // local states to read
  if (i >= n4 || last == 0) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = (long long)p.H * n4;  // float4s from one chunk to the next
  float4* s = reinterpret_cast<float4*>(p.state) + ((long long)b * p.nc * p.H + h) * n4 + i;
  const long long lstep = (long long)p.H * p.Q;
  const float* lq = p.lsum + ((long long)b * p.nc * p.H + h) * p.Q + p.Q - 1;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < last; c0 += kStateBatch) {
    float4 v[kStateBatch];
    float lQ[kStateBatch];
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (c0 + k < last) {
        v[k] = s[(c0 + k) * step];
        lQ[k] = lq[(c0 + k) * lstep];
      }
    }
    if (c0 > 0) s[c0 * step] = run;  // S_in[c0], its slot read just above
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (c0 + k < last) {
        const float e = exp2f(lQ[k]);
        run.x = fmaf(e, run.x, v[k].x);
        run.y = fmaf(e, run.y, v[k].y);
        run.z = fmaf(e, run.z, v[k].z);
        run.w = fmaf(e, run.w, v[k].w);
        if (k + 1 < kStateBatch && c0 + k + 1 < last) s[(c0 + k + 1) * step] = run;
      }
    }
  }
  s[last * step] = run;  // S_in[nc - 1]
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
  Params p;
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
// is the port's gradient, in plain float32 FMAs on the CUDA cores (each
// product a sequential fmaf chain, as the plain float32 version sums), with
// l taken from pass 1 (a compensated sum) and every sum that the tests
// compare runs (dB, dC, dA, ddt) reduced in a fixed order: no atomics.  With
// M = where(t >= s, exp(l_t - l_s), 0) (the exponent masked before the exp),
// decay = exp(l_Q - l), S_in the state entering the chunk and dS_next the
// gradient of the one leaving it, one call is seven launches:
//
// 1. ssd_chunk_state and ssd_state_pass (the forward's passes 1 and 2): l
//    and S_in into the scratch the forward would use;
// 2. ssd_bwd_dstate_local, one block per (chunk c >= 1, head, batch row):
//    local[c] = (exp(l) dy)^T C, the gradient of S_in[c] from chunk c's own
//    outputs, into the dstate scratch (Bb, nc, H, hd, ds);
// 3. ssd_bwd_dstate_pass, in place and in reverse over the chunks:
//    dS_next[c] = local[c+1] + exp(l_Q[c+1]) dS_next[c+1];
// 4. ssd_bwd_head, one block per (chunk, head, batch row): B dS_next^T and
//    C S_in^T (Q x hd), then dW = dy x^T and G = C B^T (Q x Q, in
//    registers, G by halves), then W = M G dt and dG = dW M dt; it writes
//      dx  = W^T dy + decay dt (B dS_next^T),
//      ddt = sum_t dW M G + u + A da,   u_s = decay_s x_s . (B dS_next^T)_s,
//    with da_u = sum_{t >= u} dl_t: a compensated reverse scan of
//    q + rowsum(R) - colsum(R) (q_t = dy_t . y_inter_t, R = dW * W), plus a
//    compensated prefix scan of v = dt u (exclusive), plus
//    kappa = exp(l_Q) <dS_next, S_in>; and dG per head into the dG
//    scratch (Bb, nc, H, Q, Q), and sum_u dt_u da_u into dA_part;
// 5. ssd_bwd_heads_sum, one block per (chunk, batch row): over the heads in
//    order, dC += (exp(l) dy) S_in and dB += (decay dt x) dS_next; then
//    dG_tot = sum_h dG (in order), dC += dG_tot B and dB += dG_tot^T C;
// 6. ssd_bwd_da: dA per head (A shared: over rows and chunks) or per (row,
//    head), a tree sum of dA_part.
//
// What bounds it on an H100.  At the Mamba2 training call (Bb 8, S 2048,
// H 24, hd 64, ds 128, Q 128) the function needs about 37.5 GFLOP (the
// causal halves of G, dG_tot B and dG_tot^T C per (row, chunk); per (row,
// head) the causal halves of dW and W^T dy in every chunk, and five
// Q x hd x ds products in all chunks but one: the chunk state, local,
// C-side and two dS_next products) against about 339 MB moved (x, dy, dx,
// and dt, B, C with their gradients): 0.56 ms in float32 FMAs at 67 TFLOP/s
// against 0.10 ms for the bytes.  Beyond the bound this first design pays
// for the full Q x Q products (the causal half is masked, not skipped), for
// C S_in^T and G once per head, for the dG scratch (201 MB written and read
// at that shape) and for CUDA-core FMAs where the forward has 3xTF32 tensor
// cores.
//
// Shared memory: every Q-row tile holds kMaxQ rows (rows past Q are zeros)
// with a row stride of one float more than its width (1 mod 32: a warp
// walking rows or columns hits 32 banks).  The 256 threads are a 16 x 16
// tile; thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of each
// product.

namespace {

constexpr int kBT = 16;  // threads per side of the thread tile
constexpr int kLdQ = kMaxQ + 1;

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
  const float* state;  // (Bb, nc, H, hd, ds): S_in for c >= 1, from pass 2
  float* dstate;       // (Bb, nc, H, hd, ds): local[c], then dS_next[c]
  float* dG;           // (Bb, nc, H, Q, Q): dW M dt per head
  float* dA_part;      // (Bb, nc, H): sum_u dt_u da_u per chunk
  long long as;        // A over b (0: every row reads the same A over h)
  int S, H, Q, nc;
};

// acc[i][j] += sum_{k < K} a(ty + 16 i, k) b(k, tx + 16 j), a(m, k) at
// a[m * am + k * ak] and b(k, n) at b[k * bk + n * bn] in shared memory:
// one fmaf chain per output, k in order
template <int RM, int RN>
__device__ __forceinline__ void block_mm(float (&acc)[RM][RN], const float* a, int am, int ak,
                                         const float* b, int bk, int bn, int K) {
  const int ty = threadIdx.x / kBT, tx = threadIdx.x % kBT;
  a += ty * am;
  b += tx * bn;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[kBT * i * am + k * ak];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = b[k * bk + kBT * j * bn];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// rows [0, n) of a COLS-wide global tile (rows `stride` floats apart) into
// shared rows `ld` floats apart, each row times scale[row] where scale is
// given; rows [n, rows) zero
template <int COLS>
__device__ void load_rows(float* dst, int ld, const float* src, long long stride, int n,
                          int rows, const float* scale) {
  for (int i = threadIdx.x; i < rows * COLS; i += blockDim.x) {
    const int r = i / COLS, c = i % COLS;
    float v = 0.f;
    if (r < n) v = scale ? scale[r] * src[r * stride + c] : src[r * stride + c];
    dst[r * ld + c] = v;
  }
}

// an (hd x ds) state of the scratch into shared rows `ld` apart, or zeros
template <int HD, int DS>
__device__ void load_state(float* dst, int ld, const float* src) {
  for (int i = threadIdx.x; i < HD * DS; i += blockDim.x)
    dst[(i / DS) * ld + i % DS] = src ? src[i] : 0.f;
}

// the sum over the 16 threads of a thread-tile row (lanes tx = 0..15 of a
// half warp), as a tree; every lane gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = kBT / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum over the block's threads, as a tree in shared memory; every
// thread gets it
__device__ float block_sum(float v, float* sred) {
  sred[threadIdx.x] = v;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sred[threadIdx.x] += sred[threadIdx.x + off];
    __syncthreads();
  }
  const float r = sred[0];
  __syncthreads();
  return r;
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

// 2: local[c] = sum_t (exp(l_t) dy_t)^T C_t, an (hd x ds) product over the
// chunk's rows, for c >= 1 (S_in[0] is zero: its gradient is never read)
template <int HD, int DS>
__host__ __device__ constexpr size_t local_smem_floats() {
  return (size_t)kMaxQ * (HD + 1) + (size_t)kMaxQ * (DS + 1) + kMaxQ;
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dstate_local(const BwdParams p) {
  constexpr int LDX = HD + 1, LDS = DS + 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (c == 0) return;
  extern __shared__ float smem[];
  float* sdy = smem;              // exp(l_t) dy[t][p]
  float* sC = sdy + kMaxQ * LDX;  // C[t][d]
  float* sel = sC + kMaxQ * LDS;  // exp(l_t)
  const int Q = p.Q;
  const long long t0 = (long long)b * p.S + (long long)c * Q;
  const float* lg = p.lsum + (((long long)b * p.nc + c) * p.H + h) * Q;
  for (int t = threadIdx.x; t < kMaxQ; t += kThreads) sel[t] = t < Q ? exp2f(lg[t]) : 0.f;
  __syncthreads();
  load_rows<HD>(sdy, LDX, p.dy + (t0 * p.H + h) * HD, (long long)p.H * HD, Q, kMaxQ, sel);
  load_rows<DS>(sC, LDS, p.C + t0 * DS, DS, Q, kMaxQ, nullptr);
  __syncthreads();
  float acc[HD / kBT][DS / kBT];
  zero(acc);
  block_mm(acc, sdy, 1, LDX, sC, LDS, 1, Q);  // a(p, t) = sdy[t][p]; b(t, d) = C[t][d]
  float* out = p.dstate + (((long long)b * p.nc + c) * p.H + h) * (HD * DS);
  const int ty = threadIdx.x / kBT, tx = threadIdx.x % kBT;
#pragma unroll
  for (int i = 0; i < HD / kBT; ++i)
#pragma unroll
    for (int j = 0; j < DS / kBT; ++j) out[(ty + kBT * i) * DS + tx + kBT * j] = acc[i][j];
}

// 3: in place, in reverse: slot c <- dS_next[c] = G[c+1], where G[c] =
// local[c] + exp(l_Q[c]) G[c+1] is the gradient of S_in[c] and G[nc] = 0.
// One thread per state value of one (head, batch row).
__global__ void __launch_bounds__(kThreads) ssd_bwd_dstate_pass(const BwdParams p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = (long long)p.H * n;
  float* s = p.dstate + ((long long)b * p.nc * p.H + h) * n + i;
  const long long lstep = (long long)p.H * p.Q;
  const float* lq = p.lsum + ((long long)b * p.nc * p.H + h) * p.Q + p.Q - 1;
  float run = 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const float local = c > 0 ? s[c * step] : 0.f;
    s[c * step] = run;
    run = fmaf(exp2f(lq[c * lstep]), run, local);
  }
}

// 4: per (chunk, head, batch row).  Shared memory, in floats: B and C
// (kMaxQ x (ds+1) each); then S_in and dS_next (hd x (ds+1) each) in stage 1,
// x and dy (kMaxQ x (hd+1) each) in stage 2, in the same place; W (kMaxQ x
// (kMaxQ+1)) over B, C and x once G and dW are in registers; then the
// vectors.  hd 64, ds 128: 55,296 floats = 216 KB, one block per SM.
template <int HD, int DS>
struct HeadSmem {
  static constexpr int LDX = HD + 1, LDS = DS + 1;
  static constexpr size_t B = 0, C = (size_t)kMaxQ * LDS, R = 2 * (size_t)kMaxQ * LDS;
  static constexpr size_t Sin = R, dSn = R + (size_t)HD * LDS;
  static constexpr size_t x = R;
  static constexpr size_t dy = R + (size_t)kMaxQ * LDX > (size_t)kMaxQ * kLdQ
                                   ? R + (size_t)kMaxQ * LDX : (size_t)kMaxQ * kLdQ;
  static constexpr size_t tiles = dy + (size_t)kMaxQ * LDX > R + 2 * (size_t)HD * LDS
                                      ? dy + (size_t)kMaxQ * LDX : R + 2 * (size_t)HD * LDS;
  // l, dt, decay, u, q, row sums of R, e, ddt, scans (2), 16 x kMaxQ column
  // partials twice, and the block sum's kThreads
  static constexpr size_t vec = tiles;
  static constexpr size_t total = tiles + 10 * kMaxQ + 2 * kBT * kMaxQ + kThreads;
};

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_head(const BwdParams p) {
  using L = HeadSmem<HD, DS>;
  constexpr int LDX = L::LDX, LDS = L::LDS, RN = HD / kBT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kBT, tx = tid % kBT;
  const int Q = p.Q;
  const bool first = c == 0, last = c == p.nc - 1;
  const long long t0 = (long long)b * p.S + (long long)c * Q;

  extern __shared__ float smem[];
  float* sB = smem + L::B;
  float* sC = smem + L::C;
  float* sSin = smem + L::Sin;
  float* sdSn = smem + L::dSn;
  float* sx = smem + L::x;
  float* sdy = smem + L::dy;
  float* sW = smem;
  float* sl = smem + L::vec;
  float* sdt = sl + kMaxQ;
  float* sdec = sdt + kMaxQ;
  float* su = sdec + kMaxQ;
  float* sq = su + kMaxQ;
  float* srow = sq + kMaxQ;
  float* se = srow + kMaxQ;
  float* sddt = se + kMaxQ;
  float* sscan_e = sddt + kMaxQ;
  float* sscan_v = sscan_e + kMaxQ;
  float* scolR = sscan_v + kMaxQ;  // [ty][s]
  float* scolD = scolR + kBT * kMaxQ;
  float* sred = scolD + kBT * kMaxQ;

  const long long hq = ((long long)b * p.nc + c) * p.H + h;
  const float* lg = p.lsum + hq * Q;
  for (int t = tid; t < kMaxQ; t += kThreads) {
    sl[t] = t < Q ? lg[t] : 0.f;
    sdt[t] = t < Q ? p.dt[(t0 + t) * p.H + h] : 0.f;
  }
  __syncthreads();
  const float lQ = sl[Q - 1], Ah = p.A[b * p.as + h];
  for (int t = tid; t < kMaxQ; t += kThreads) sdec[t] = t < Q ? exp2f(lQ - sl[t]) : 0.f;

  // stage 1: B, C, S_in and dS_next
  load_rows<DS>(sB, LDS, p.B + t0 * DS, DS, Q, kMaxQ, nullptr);
  load_rows<DS>(sC, LDS, p.C + t0 * DS, DS, Q, kMaxQ, nullptr);
  load_state<HD, DS>(sSin, LDS, first ? nullptr : p.state + hq * (HD * DS));
  load_state<HD, DS>(sdSn, LDS, last ? nullptr : p.dstate + hq * (HD * DS));
  __syncthreads();
  float part = 0.f;
  for (int i = tid; i < HD * DS; i += kThreads)
    part = fmaf(sSin[(i / DS) * LDS + i % DS], sdSn[(i / DS) * LDS + i % DS], part);
  const float kappa = exp2f(lQ) * block_sum(part, sred);
  {
    float bds[kMaxQ / kBT][RN], cs[kMaxQ / kBT][RN];
    zero(bds);
    zero(cs);
    if (!last) block_mm(bds, sB, LDS, 1, sdSn, 1, LDS, DS);  // (B dS_next^T)[s][p]
    if (!first) block_mm(cs, sC, LDS, 1, sSin, 1, LDS, DS);  // (C S_in^T)[t][p]
#pragma unroll
    for (int i = 0; i < kMaxQ / kBT; ++i) {
      const int s = ty + kBT * i;
      const bool on = s < Q;
      float ur = 0.f, qr = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        if (on) {
          const long long at = ((t0 + s) * p.H + h) * HD + tx + kBT * j;
          ur = fmaf(p.x[at], bds[i][j], ur);
          qr = fmaf(p.dy[at], cs[i][j], qr);
          p.dx[at] = sdec[s] * sdt[s] * bds[i][j];
        }
      }
      ur = row_sum16(ur);
      qr = row_sum16(qr);
      if (tx == 0) {
        su[s] = on ? sdec[s] * ur : 0.f;
        sq[s] = on ? exp2f(sl[s]) * qr : 0.f;
      }
    }
  }
  __syncthreads();

  // stage 2: x and dy in S_in's place; dW = dy x^T and G = C B^T
  load_rows<HD>(sx, LDX, p.x + (t0 * p.H + h) * HD, (long long)p.H * HD, Q, kMaxQ, nullptr);
  load_rows<HD>(sdy, LDX, p.dy + (t0 * p.H + h) * HD, (long long)p.H * HD, Q, kMaxQ, nullptr);
  __syncthreads();
  constexpr int MT = kMaxQ / kBT, HALF = MT / 2;
  float dw[MT][MT], w[MT][MT];
  zero(dw);
  block_mm(dw, sdy, LDX, 1, sx, 1, LDX, HD);  // a(t, p) = dy[t][p]; b(p, s) = x[s][p]

  // G = C B^T by halves of the thread's rows (G, dW and W in registers at
  // once would spill), then per element: W = M G dt, dG = dW M dt (to the
  // scratch), R = dW W by rows and columns, sum_t dW M G by columns
  float colR[MT], colD[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) colR[j] = colD[j] = 0.f;
  float* dGg = p.dG + hq * Q * Q;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float g[HALF][MT];
    zero(g);
    // a(t, d) = C[t][d] for rows ty + 16 i + 64 half; b(d, s) = B[s][d]
    block_mm(g, sC + half * HALF * kBT * LDS, LDS, 1, sB, 1, LDS, DS);
#pragma unroll
    for (int ih = 0; ih < HALF; ++ih) {
      const int i = half * HALF + ih, t = ty + kBT * i;
      float rowr = 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int s = tx + kBT * j;
        const float m = (t < Q && s <= t) ? exp2f(sl[t] - sl[s]) : 0.f;
        const float mg = m * g[ih][j];
        w[i][j] = mg * sdt[s];
        const float r = dw[i][j] * w[i][j];
        rowr += r;
        colR[j] += r;
        colD[j] = fmaf(dw[i][j], mg, colD[j]);
        if (t < Q && s < Q) dGg[t * Q + s] = dw[i][j] * m * sdt[s];
      }
      rowr = row_sum16(rowr);
      if (tx == 0) srow[t] = rowr;
    }
  }
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    scolR[ty * kMaxQ + tx + kBT * j] = colR[j];
    scolD[ty * kMaxQ + tx + kBT * j] = colD[j];
  }
  __syncthreads();  // W is in registers: B, C and x are free for it
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) sW[(ty + kBT * i) * kLdQ + tx + kBT * j] = w[i][j];
  // e = q + rowsum(R) - colsum(R) and sum_t dW M G + u, the column sums as
  // trees over the 16 thread rows
  if (tid < kMaxQ) {
    float r[kBT], d[kBT];
#pragma unroll
    for (int k = 0; k < kBT; ++k) {
      r[k] = scolR[k * kMaxQ + tid];
      d[k] = scolD[k * kMaxQ + tid];
    }
#pragma unroll
    for (int w = kBT / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) {
        r[k] += r[k + w];
        d[k] += d[k + w];
      }
    se[tid] = sq[tid] + srow[tid] - r[0];
    sddt[tid] = d[0] + su[tid];
    sscan_v[tid] = sdt[tid] * su[tid];  // v, scanned in place below
  }
  __syncthreads();

  // dx += W^T dy (the same thread wrote these dx values in stage 1)
  {
    float dxi[kMaxQ / kBT][RN];
    zero(dxi);
    block_mm(dxi, sW, 1, kLdQ, sdy, LDX, 1, Q);  // a(s, t) = W[t][s]; b(t, p) = dy[t][p]
#pragma unroll
    for (int i = 0; i < kMaxQ / kBT; ++i) {
      const int s = ty + kBT * i;
      if (s < Q) {
#pragma unroll
        for (int j = 0; j < RN; ++j) p.dx[((t0 + s) * p.H + h) * HD + tx + kBT * j] += dxi[i][j];
      }
    }
  }

  // da_u = sum_{t >= u} e_t + sum_{s < u} v_s + kappa
  if (tid < 32) {
    warp_scan(se, sscan_e, Q, true);
    warp_scan(sscan_v, sscan_v, Q, false);
  }
  __syncthreads();
  float contrib = 0.f;
  if (tid < Q) {
    const float da = sscan_e[tid] + ((tid > 0 ? sscan_v[tid - 1] : 0.f) + kappa);
    p.ddt[(t0 + tid) * p.H + h] = fmaf(Ah, da, sddt[tid]);
    contrib = sdt[tid] * da;
  }
  const float dA = block_sum(contrib, sred);
  if (tid == 0) p.dA_part[hq] = dA;
}

// 5: per (chunk, batch row), over the heads.  Shared memory, in floats:
// per head x and dy (kMaxQ x (hd+1) each, scaled at load) and S_in and
// dS_next (hd x (ds+1) each); then dG_tot (kMaxQ x (kMaxQ+1)), B and C
// (kMaxQ x (ds+1) each) in the same place; then l, dt and the two scales.
// hd 64, ds 128: 50,048 floats = 196 KB, one block per SM.
template <int HD, int DS>
struct SumSmem {
  static constexpr int LDX = HD + 1, LDS = DS + 1;
  static constexpr size_t x = 0, dy = (size_t)kMaxQ * LDX, Sin = 2 * (size_t)kMaxQ * LDX,
                          dSn = Sin + (size_t)HD * LDS;
  static constexpr size_t stage1 = dSn + (size_t)HD * LDS;
  static constexpr size_t G = 0, B = (size_t)kMaxQ * kLdQ, C = B + (size_t)kMaxQ * LDS;
  static constexpr size_t stage2 = C + (size_t)kMaxQ * LDS;
  static constexpr size_t vec = stage1 > stage2 ? stage1 : stage2;
  static constexpr size_t total = vec + 4 * kMaxQ;
};

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_heads_sum(const BwdParams p) {
  using L = SumSmem<HD, DS>;
  constexpr int LDX = L::LDX, LDS = L::LDS, RN = DS / kBT;
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / kBT, tx = tid % kBT;
  const int Q = p.Q;
  const bool first = c == 0, last = c == p.nc - 1;
  const long long t0 = (long long)b * p.S + (long long)c * Q;

  extern __shared__ float smem[];
  float* sx = smem + L::x;
  float* sdy = smem + L::dy;
  float* sSin = smem + L::Sin;
  float* sdSn = smem + L::dSn;
  float* sG = smem + L::G;
  float* sB = smem + L::B;
  float* sC = smem + L::C;
  float* sl = smem + L::vec;
  float* sdt = sl + kMaxQ;
  float* sel = sdt + kMaxQ;  // exp(l)
  float* sxs = sel + kMaxQ;  // decay dt

  float accC[kMaxQ / kBT][RN], accB[kMaxQ / kBT][RN];
  zero(accC);
  zero(accB);
  for (int h = 0; h < p.H; ++h) {
    const long long hq = ((long long)b * p.nc + c) * p.H + h;
    for (int t = tid; t < kMaxQ; t += kThreads) {
      sl[t] = t < Q ? p.lsum[hq * Q + t] : 0.f;
      sdt[t] = t < Q ? p.dt[(t0 + t) * p.H + h] : 0.f;
    }
    __syncthreads();
    const float lQ = sl[Q - 1];
    for (int t = tid; t < kMaxQ; t += kThreads) {
      sel[t] = t < Q ? exp2f(sl[t]) : 0.f;
      sxs[t] = t < Q ? exp2f(lQ - sl[t]) * sdt[t] : 0.f;
    }
    __syncthreads();
    if (!first) {
      load_rows<HD>(sdy, LDX, p.dy + (t0 * p.H + h) * HD, (long long)p.H * HD, Q, kMaxQ, sel);
      load_state<HD, DS>(sSin, LDS, p.state + hq * (HD * DS));
    }
    if (!last) {
      load_rows<HD>(sx, LDX, p.x + (t0 * p.H + h) * HD, (long long)p.H * HD, Q, kMaxQ, sxs);
      load_state<HD, DS>(sdSn, LDS, p.dstate + hq * (HD * DS));
    }
    __syncthreads();
    // a(t, p) = scaled dy[t][p], b(p, d) = S_in[p][d]; the same with x, dS_next
    if (!first) block_mm(accC, sdy, LDX, 1, sSin, LDS, 1, HD);
    if (!last) block_mm(accB, sx, LDX, 1, sdSn, LDS, 1, HD);
    __syncthreads();
  }
  // dG_tot, summed over the heads in order
  const float* dGb = p.dG + ((long long)b * p.nc + c) * p.H * Q * Q;
  for (int i = tid; i < kMaxQ * kMaxQ; i += kThreads) {
    const int t = i / kMaxQ, s = i % kMaxQ;
    float v = 0.f;
    if (t < Q && s <= t)
      for (int h = 0; h < p.H; ++h) v += dGb[(long long)h * Q * Q + t * Q + s];
    sG[t * kLdQ + s] = v;
  }
  load_rows<DS>(sB, LDS, p.B + t0 * DS, DS, Q, kMaxQ, nullptr);
  load_rows<DS>(sC, LDS, p.C + t0 * DS, DS, Q, kMaxQ, nullptr);
  __syncthreads();
  block_mm(accC, sG, kLdQ, 1, sB, LDS, 1, Q);  // a(t, s) = dG[t][s]; b(s, d) = B[s][d]
  block_mm(accB, sG, 1, kLdQ, sC, LDS, 1, Q);  // a(s, t) = dG[t][s]; b(t, d) = C[t][d]
#pragma unroll
  for (int i = 0; i < kMaxQ / kBT; ++i) {
    const int t = ty + kBT * i;
    if (t < Q) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        p.dC[(t0 + t) * DS + tx + kBT * j] = accC[i][j];
        p.dB[(t0 + t) * DS + tx + kBT * j] = accB[i][j];
      }
    }
  }
}

// 6: dA[h] (A shared: per_row 0) or dA[r][h] (A per row), a tree sum of
// the partials of its rows and chunks
__global__ void __launch_bounds__(kThreads) ssd_bwd_da(const BwdParams p, int Bb, int per_row) {
  __shared__ float sred[kThreads];
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

template <int HD, int DS>
cudaError_t launch_bwd(const Params& fp, const BwdParams& p, int Bb, int per_row,
                       const int* grid, cudaStream_t stream) {
  const int n4 = HD * DS / 4, n = HD * DS;
  const dim3 g[7] = {dim3(grid[0], grid[1], grid[2]), dim3(grid[3], grid[4], grid[5]),
                     dim3(grid[6], grid[7], grid[8]), dim3(grid[9], grid[10], grid[11]),
                     dim3(grid[12], grid[13], grid[14]), dim3(grid[15], grid[16], grid[17]),
                     dim3(grid[18], grid[19], grid[20])};
  if (!grid_is(grid, p.nc, p.H, Bb) || !grid_is(grid + 3, (n4 + kThreads - 1) / kThreads, p.H, Bb)
      || !grid_is(grid + 6, p.nc, p.H, Bb)
      || !grid_is(grid + 9, (n + kThreads - 1) / kThreads, p.H, Bb)
      || !grid_is(grid + 12, p.nc, p.H, Bb) || !grid_is(grid + 15, p.nc, Bb, 1)
      || !grid_is(grid + 18, p.H, per_row ? Bb : 1, 1))
    return cudaErrorInvalidConfiguration;
  const size_t smem1 = state_smem_floats<HD, DS>(p.Q) * sizeof(float);
  const size_t smemL = local_smem_floats<HD, DS>() * sizeof(float);
  const size_t smemH = HeadSmem<HD, DS>::total * sizeof(float);
  const size_t smemS = SumSmem<HD, DS>::total * sizeof(float);
  if (smem1 > kMaxSmem || smemL > kMaxSmem || smemH > kMaxSmem || smemS > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dstate_local<HD, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smemL);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head<HD, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smemH);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_heads_sum<HD, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smemS);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<HD, DS><<<g[0], kThreads, smem1, stream>>>(fp);
  ssd_state_pass<<<g[1], kThreads, 0, stream>>>(fp, n4);
  ssd_bwd_dstate_local<HD, DS><<<g[2], kThreads, smemL, stream>>>(p);
  ssd_bwd_dstate_pass<<<g[3], kThreads, 0, stream>>>(p, n);
  ssd_bwd_head<HD, DS><<<g[4], kThreads, smemH, stream>>>(p);
  ssd_bwd_heads_sum<HD, DS><<<g[5], kThreads, smemS, stream>>>(p);
  ssd_bwd_da<<<g[6], kThreads, 0, stream>>>(p, Bb, per_row);
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
// {16, 128}, 1 <= Q <= 128 and S % Q == 0.  Scratch from the caller,
// contiguous float32: lsum (Bb, S/Q, H, Q), state and dstate (Bb, S/Q, H, hd,
// ds), dG (Bb, S/Q, H, Q, Q) and dA_part (Bb, S/Q, H).  grid holds the seven
// launches' grids, three numbers each (kernels/ssd_scan_bwd.py::plan).
// Launches seven kernels on `stream`; returns a cudaError_t value (0 on
// success).
extern "C" int ssd_scan_bwd(
    const float* x, const float* dt, const float* B, const float* C, const float* A,
    const float* dy, float* dx, float* ddt, float* dB, float* dC, float* dA, float* lsum,
    float* state, float* dstate, float* dG, float* dA_part, int Bb, int S, int H, int hd,
    int ds, int Q, long long a_stride, int per_row_a, const int* grid, void* stream) {
  if (Q < 1 || Q > kMaxQ || S % Q != 0 || Bb < 1 || H < 1 || Bb > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Params fp = {};
  fp.x = x; fp.dt = dt; fp.B = B; fp.C = C; fp.A = A;
  fp.lsum = lsum; fp.state = state; fp.as = a_stride;
  fp.xs[0] = (long long)S * H * hd; fp.xs[1] = (long long)H * hd; fp.xs[2] = hd;
  fp.dts[0] = (long long)S * H; fp.dts[1] = H;
  fp.bs[0] = fp.cs[0] = (long long)S * ds; fp.bs[1] = fp.cs[1] = ds;
  fp.Q = Q; fp.H = H; fp.nc = S / Q; fp.head_group = 1;
  fp.vec = aligned16(x, fp.xs, 3) && aligned16(B, fp.bs, 2) && aligned16(C, fp.cs, 2);
  BwdParams p;
  p.x = x; p.dt = dt; p.B = B; p.C = C; p.A = A; p.dy = dy;
  p.dx = dx; p.ddt = ddt; p.dB = dB; p.dC = dC; p.dA = dA;
  p.lsum = lsum; p.state = state; p.dstate = dstate; p.dG = dG; p.dA_part = dA_part;
  p.as = a_stride; p.S = S; p.H = H; p.Q = Q; p.nc = S / Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_bwd_ds<32>(fp, p, Bb, ds, per_row_a, grid, st);
    case 64: return launch_bwd_ds<64>(fp, p, Bb, ds, per_row_a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}
