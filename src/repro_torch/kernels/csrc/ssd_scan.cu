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
