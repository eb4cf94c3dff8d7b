// Mamba2 SSD (state space duality) scan for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan.py:70 ssd_scan (body _ssd_kernel) and, on the
// model path, the pure-jnp oracle it stands in for,
// src/repro/models/ssm.py::ssd_scan_ref.  Inputs x (Bb,S,H,hd), dt (Bb,S,H),
// B and C (Bb,S,ds) shared by all heads, A (H,) negative; output y in x's
// layout.  Everything is float32.  For each chunk of Q rows, with l the
// within-chunk cumulative sum of dt*A:
//
//   G = C B^T                                      (Q x Q)
//   W = where(t >= s, exp(l_t - l_s), 0) * G * dt_s
//   y = W x + exp(l) * (C S^T)                     (Q x hd)
//   S = exp(l_Q) S + (exp(l_Q - l) * dt * x)^T B   (hd x ds)
//
// The mask is a select before the product: for t < s, l_t - l_s is a sum of
// up to Q - 1 terms dt*|A| and exp overflows to inf, which a multiply by 0
// would turn into NaN.
//
// What bounds it on an H100: float32 operations, not bytes.  At the Mamba2
// forward's shape (Bb 8, S 2048, H 24, hd 64, ds 128, Q 128) the work is
// about 15.6 GFLOP (the causal half of G once per batch row and chunk, the
// causal half of W x, and C S^T and the state update in all chunks but one)
// against about 220 MB moved (x and y once, dt, B and C once): 0.233 ms at
// 67 TFLOP/s against 0.066 ms at 3.35 TB/s.
//
// This first version is simple and right.  One block of 256 threads per
// (head, batch row) walks the chunks in order; the (hd, ds) float32 state
// stays in shared memory for the whole sequence, because blocks carry
// nothing from one to the next as the TPU grid's sequential chunk dim did.
// Each chunk stages x, dt, B and C in shared memory (rows padded so the
// column walks below hit distinct banks), takes l with a warp scan, then
// runs four register-tiled products on CUDA-core FMAs: C S^T and C B^T in
// one pass over ds, W x over the causal columns only, and the state update.
// W overwrites C's buffer once C is read.  It uses no tensor cores yet, it
// recomputes G = C B^T for every head although G does not depend on the
// head, and at Bb x H blocks it fills the 132 SMs poorly at small batch
// (24 blocks at Bb = 1; about 195 KB of shared memory allows one block per
// SM).  Tensor cores, a G shared across heads and chunk-parallel passes are
// later work (ROADMAP B2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kMaxQ = 128;     // chunk rows; 8 per thread row group
constexpr int kRows = kMaxQ / 16;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

struct Params {
  const float* x;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;
  float* y;
  long long xs[3];   // element strides of x over (b, s, h); the last dim is unit
  long long dts[2];  // dt over (b, s)
  long long bs[2];   // B over (b, s)
  long long cs[2];   // C over (b, s)
  long long ys[3];   // y over (b, s, h)
  int S, Q;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// shared memory in floats: x (Q x HD), B (Q x (DS+1)), C then W (Q x
// max(DS+1, Q|1)), the state (HD x (DS+1)), and dt, l, exp(l), decay (Q each)
__host__ __device__ constexpr size_t smem_floats(int HD, int DS, int Q) {
  return (size_t)Q * HD + (size_t)Q * (DS + 1) + (size_t)Q * imax(DS + 1, Q | 1)
         + (size_t)HD * (DS + 1) + 4 * (size_t)Q;
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd(const Params p) {
  constexpr int PJ = HD / 16;  // y columns per thread: p = tx + 16 j
  constexpr int DJ = DS / 16;  // state columns per thread: d = tx + 16 j
  constexpr int LDB = DS + 1;  // row stride of B, C and the state
  const int Q = p.Q;
  const int LDW = Q | 1;       // row stride of W

  extern __shared__ float smem[];
  float* sx = smem;                          // x[t][p]
  float* sB = sx + Q * HD;                   // B[t][d]
  float* sCW = sB + Q * LDB;                 // C[t][d], then W[t][s]
  float* sS = sCW + Q * imax(LDB, LDW);      // state[p][d]
  float* sdt = sS + HD * LDB;
  float* sl = sdt + Q;                       // l[t]
  float* sel = sl + Q;                       // exp(l[t])
  float* sdec = sel + Q;                     // exp(l[Q-1] - l[t]) * dt[t]
  __shared__ float s_eQ;                     // exp(l[Q-1])

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float A = p.A[h];
  const float* xg = p.x + b * p.xs[0] + h * p.xs[2];
  const float* dtg = p.dt + b * p.dts[0] + h;
  const float* Bg = p.B + b * p.bs[0];
  const float* Cg = p.C + b * p.cs[0];
  float* yg = p.y + b * p.ys[0] + h * p.ys[2];

  // this thread's q rows t = 8 ty + i (blocked, so that W x can stop at its
  // last row) and G columns s = tx + 16 j, clamped into the chunk: clamped
  // rows and columns are computed and never stored
  int trow[kRows], scol[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    trow[i] = min(kRows * ty + i, Q - 1);
    scol[i] = min(tx + 16 * i, Q - 1);
  }

  for (int i = tid; i < HD * LDB; i += kThreads) sS[i] = 0.f;

  for (int c = 0; c < p.S / Q; ++c) {
    const long long t0 = (long long)c * Q;
    for (int i = tid; i < Q * HD; i += kThreads) {
      const int t = i / HD, q = i % HD;
      sx[i] = xg[(t0 + t) * p.xs[1] + q];
    }
    for (int i = tid; i < Q * DS; i += kThreads) {
      const int t = i / DS, d = i % DS;
      sB[t * LDB + d] = Bg[(t0 + t) * p.bs[1] + d];
      sCW[t * LDB + d] = Cg[(t0 + t) * p.cs[1] + d];
    }
    for (int t = tid; t < Q; t += kThreads) sdt[t] = dtg[(t0 + t) * p.dts[1]];
    __syncthreads();

    // l = cumsum(dt * A) by warp 0: four rows per lane, then a warp scan
    if (tid < 32) {
      constexpr int PER = kMaxQ / 32;
      float v[PER], run = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = tid * PER + k;
        run += t < Q ? sdt[t] * A : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += n;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = tid * PER + k;
        if (t < Q) {
          sl[t] = excl + v[k];
          sel[t] = expf(sl[t]);
        }
      }
      __syncwarp();
      const float lQ = sl[Q - 1];
      for (int t = tid; t < Q; t += 32) sdec[t] = expf(lQ - sl[t]) * sdt[t];
      if (tid == 0) s_eQ = expf(lQ);
    }
    __syncthreads();

    // one pass over ds: acc = C S^T (this thread's rows x columns p) and
    // g = C B^T (its rows x columns s)
    float acc[kRows][PJ], g[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) g[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < DS; ++d) {
      float cv[kRows], bv[kRows], sv[PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        cv[i] = sCW[trow[i] * LDB + d];
        bv[i] = sB[scol[i] * LDB + d];
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) sv[j] = sS[(tx + 16 * j) * LDB + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
#pragma unroll
        for (int j = 0; j < kRows; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float e = sel[trow[i]];
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
    }
    __syncthreads();  // every read of C is done: W takes its buffer

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = kRows * ty + i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int s = tx + 16 * j;
        if (t < Q && s < Q)
          sCW[t * LDW + s] = t >= s ? expf(sl[t] - sl[s]) * g[i][j] * sdt[s] : 0.f;
      }
    }
    __syncthreads();

    // y = W x + acc, over the columns s <= this thread's last row
    const int s_end = min(kRows * ty + kRows, Q);
    for (int s = 0; s < s_end; ++s) {
      float wv[kRows], xv[PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) wv[i] = sCW[trow[i] * LDW + s];
#pragma unroll
      for (int j = 0; j < PJ; ++j) xv[j] = sx[s * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = kRows * ty + i;
      if (t < Q) {
        float* row = yg + (t0 + t) * p.ys[1];
#pragma unroll
        for (int j = 0; j < PJ; ++j) row[tx + 16 * j] = acc[i][j];
      }
    }

    // state: S = exp(l_Q) S + (decay * x)^T B; this thread owns rows
    // p = ty + 16 i and columns d = tx + 16 j
    float upd[PJ][DJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) upd[i][j] = 0.f;
    for (int s = 0; s < Q; ++s) {
      const float dec = sdec[s];
      float u[PJ], bv[DJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i) u[i] = sx[s * HD + ty + 16 * i] * dec;
#pragma unroll
      for (int j = 0; j < DJ; ++j) bv[j] = sB[s * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) upd[i][j] = fmaf(u[i], bv[j], upd[i][j]);
    }
    const float eQ = s_eQ;
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        float* sp = sS + (ty + 16 * i) * LDB + tx + 16 * j;
        *sp = eQ * *sp + upd[i][j];
      }
    __syncthreads();  // the next chunk overwrites x, B and C
  }
}

template <int HD, int DS>
cudaError_t launch(const Params& p, int Bb, int H, cudaStream_t stream) {
  const size_t smem = smem_floats(HD, DS, p.Q) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ssd_fwd<HD, DS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, Bb), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_ds(const Params& p, int Bb, int H, int ds, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch<HD, 16>(p, Bb, H, stream);
    case 128: return launch<HD, 128>(p, Bb, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 only.  hd in {32, 64}, ds in {16, 128}, 1 <= Q <= 128 and
// S % Q == 0.  Returns a cudaError_t value (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_fwd(
    const float* x, const float* dt, const float* B, const float* C, const float* A,
    float* y, int Bb, int S, int H, int hd, int ds, int Q,
    const long long* x_strides, const long long* dt_strides, const long long* b_strides,
    const long long* c_strides, const long long* y_strides, void* stream) {
  if (Q < 1 || Q > kMaxQ || S % Q != 0 || Bb < 1 || H < 1 || Bb > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.B = B; p.C = C; p.A = A; p.y = y;
  for (int i = 0; i < 3; ++i) { p.xs[i] = x_strides[i]; p.ys[i] = y_strides[i]; }
  for (int i = 0; i < 2; ++i) {
    p.dts[i] = dt_strides[i]; p.bs[i] = b_strides[i]; p.cs[i] = c_strides[i];
  }
  p.S = S; p.Q = Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_ds<32>(p, Bb, H, ds, st);
    case 64: return launch_ds<64>(p, Bb, H, ds, st);
    default: return cudaErrorInvalidValue;
  }
}
