// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _attn_kernel)
// and, on the model path, the XLA online-softmax loop it stands in for,
// src/repro/models/attention.py::chunked_attention.  It computes what
// chunked_attention computes: q is scaled and rounded to its dtype, scores
// and the running max/denominator are float32, p is rounded to the kv dtype
// before the PV product, the output is acc / max(l, 1e-20) rounded once.
// The causal mask is aligned by q_offset (row s sees keys <= q_offset + s),
// and keys at or past kv_len are masked (-1e9, as the reference).
//
// Layouts are strided, so one kernel serves the model layout
// q (B,S,KR,Gl,D), k/v (B,T,KR,D) and the reference layout q (B,Hq,S,D),
// k/v (B,Hkv,T,D) viewed as (B,S,Hkv,group,D): GQA reads kv head kr for all
// Gl q heads of its group, with no copy or repeat of kv.
//
// What bounds it on an H100: prefill is bound by matmul operations (4·S·T·D
// per q head, half of it masked away when causal), decode (S = 1) by reading
// the visible kv-cache prefix once.  This first version is simple and right:
// one block of 128 threads per (q tile, kv head, batch row); the q tile is
// scaled into shared memory once, kv tiles of 64 rows are staged through
// shared memory in float32, every thread owns RPT q rows x 8 score columns
// and RPT rows x D/8 output columns in registers, and scores use CUDA-core
// FMAs.  Tiles wholly past kv_len, and wholly past the tile's last visible
// position when causal, are never loaded, so decode reads only the prefix
// and causal prefill does about half the work.  Decode (few q rows) uses
// RPT = 1 (16-row q tiles) so it wastes fewer rows.  Tensor cores (wgmma),
// TMA, split-kv for decode and tuned tiles are later work (ROADMAP B1).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kBK = 64;        // kv rows per tile = 8 column groups x 8
constexpr float kNegInf = -1e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[4];  // element strides of q over (b, s, kr, g); d is unit
  long long ks[3];  // k over (b, t, kr)
  long long vs[3];  // v over (b, t, kr)
  long long os[4];  // o over (b, s, kr, g)
  int S, KR, Gl, T, R;  // R = S * Gl q rows per (b, kr)
  int causal, q_offset, kv_end;  // kv_end = min(kv_len, T)
  float scale;  // 1/sqrt(D), already rounded to q's dtype
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

template <int D, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(16 * RPT * (D + 1) + 2 * kBK * (D + 1) + 16 * RPT * (kBK + 1));
}

template <typename TQ, typename TKV, int D, int RPT>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int BQ = 16 * RPT;
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

  // keys this tile can see: below kv_len and, when causal, up to the last
  // row's position
  const int r_last = min(r0 + BQ, p.R) - 1;
  int kv_stop = p.kv_end;
  if (p.causal) kv_stop = min(kv_stop, p.q_offset + r_last / p.Gl + 1);

  int qpos[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = p.q_offset + (r0 + ty * RPT + i) / p.Gl;
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

    float s[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RPT], kk[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = sQ[(ty * RPT + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = sK[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
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
        sP[(ty * RPT + i) * LP + tx + 8 * j] = round_to<TKV>(pij);
      }
      l[i] = l[i] * alpha + group8_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty * RPT + i;
    if (r >= p.R) continue;
    const int s = r / p.Gl, g = r % p.Gl;
    TQ* orow = o + b * p.os[0] + s * p.os[1] + kr * p.os[2] + g * p.os[3];
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 8 * j] = from_f32<TQ>(acc[i][j] / den);
  }
}

template <typename TQ, typename TKV, int D, int RPT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, RPT>();
  auto kern = flash_fwd<TQ, TKV, D, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + 16 * RPT - 1) / (16 * RPT), p.KR, B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_rows(const Params& p, int B, cudaStream_t stream) {
  // decode and other short q: 16-row tiles waste less of the block
  if (p.R <= 16) return launch<TQ, TKV, D, 1>(p, B, stream);
  return launch<TQ, TKV, D, 4>(p, B, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_rows<TQ, TKV, 32>(p, B, stream);
    case 64: return launch_rows<TQ, TKV, 64>(p, B, stream);
    case 128: return launch_rows<TQ, TKV, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Supported (q, kv): (0,0), (1,1),
// (0,1) — the last is an f32 model decoding from the bf16 cache.
// Returns a cudaError_t value (0 on success); cudaErrorInvalidValue for a
// combination the kernel does not take.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int q_dtype, int kv_dtype, int B, int S, int KR, int Gl, int T, int D,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int i = 0; i < 4; ++i) { p.qs[i] = q_strides[i]; p.os[i] = o_strides[i]; }
  for (int i = 0; i < 3; ++i) { p.ks[i] = k_strides[i]; p.vs[i] = v_strides[i]; }
  p.S = S; p.KR = KR; p.Gl = Gl; p.T = T; p.R = S * Gl;
  p.causal = causal; p.q_offset = q_offset;
  p.kv_end = kv_len < T ? kv_len : T;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(p, B, D, st);
  if (q_dtype == 1 && kv_dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(p, B, D, st);
  if (q_dtype == 0 && kv_dtype == 1) return launch_d<float, __nv_bfloat16>(p, B, D, st);
  return cudaErrorInvalidValue;
}
