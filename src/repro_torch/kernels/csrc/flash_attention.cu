// Causal GQA flash attention for sm_90a: the hand-written CUDA replacement
// of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (grid (B, H, nq, nk), the nk axis sequential with m/l/acc in VMEM
// scratch).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.
//
// What it computes: o[b,i,h] = softmax_j(q[b,i,h] . k[b,j,h/G] / sqrt(hd))
// . v[b,j,h/G] over the keys j <= i + (T - S) (all j < T when not causal),
// with G = H / KV.  q, o (B,S,H,hd); k, v (B,T,KV,hd); bf16 or f32 in,
// f32 scores, softmax and accumulator, output rounded once to the input
// type.  A row that sees no key gets 0 (denominator clamped at 1e-30).
//
// Bound: at the serve shapes (S = T = 512, hd = 64) a query tile does
// 2 * 64 * 64 * hd FMAs per 64-key tile and reads 2 * 64 * hd inputs: about
// 2 * 64 / sizeof(T) operations per byte, well above the H100's ridge, so
// the arithmetic bounds it.  This first kernel does the products with
// scalar f32 FMAs from shared memory (no tensor cores), so its ceiling is
// the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 tensor rate that
// bound_ms is computed against; wgmma tiles are later work.
//
// Design (what the TPU grid becomes):
//  * one block per (64-row query tile, query head, batch row); the
//    sequential kv grid axis becomes a loop inside the block over 64-key
//    tiles, ending at the causal diagonal, so masked-out tiles are never
//    read.  Query tiles are issued longest-first (the causal work grows
//    with the row index).
//  * 256 threads as 16 x 16; each owns a 4 x 4 patch of the 64 x 64 score
//    tile (rows ty + 16 i, keys tx + 16 j) and a 4 x hd/16 patch of the
//    output (rows ty + 16 i, dims tx + 16 j), so the online-softmax
//    rescale of a row's accumulator is thread-local; row max and sum
//    reduce over the 16 lanes of a half-warp with shuffles.
//  * Q, K, V and P tiles live in shared memory as f32, with row strides
//    padded by one word where a half-warp walks down a column, so those
//    reads are conflict-free.  The KV head is read as h / G directly:
//    there is no repeat_kv on the card.
//  * ragged S and T: tile rows past S are zero and never stored; keys past
//    T are masked to probability 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a strided (rows, HD) operand into a padded f32
// tile; rows at or past n_valid are zero.
template <typename T, int HD, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_valid, size_t row_stride) {
  constexpr int V = VecN<T>::N;
  constexpr int VPR = HD / V;
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * V;
    float tmp[V];
    if (r < n_valid) {
      load16(src + (size_t)(row0 + r) * row_stride + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * STRIDE + c + e] = tmp[e];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tn,
                 int H, int KV, int causal) {
  constexpr int QS = HD + 1, KS = HD + 1, PS = BK + 1, DJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * HD;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Tn - S;
  const float scale = 1.0f / sqrtf((float)HD);
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const T* qbase = q + ((size_t)b * S * H + h) * HD;
  const T* kbase = k + ((size_t)b * Tn * KV + kvh) * HD;
  const T* vbase = v + ((size_t)b * Tn * KV + kvh) * HD;

  load_tile<T, HD, QS>(Qs, qbase, q0, min(BQ, S - q0), qrow);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(Tn, q0 + BQ + off) : Tn;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                       // Qs written / last tile consumed
    const int nk = min(BK, Tn - k0);
    load_tile<T, HD, KS>(Ks, kbase, k0, nk, krow);
    load_tile<T, HD, HD>(Vs, vbase, k0, nk, krow);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Tn && (!causal || kj <= qi + off);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float corr = (mn == -INFINITY) ? 1.f : expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)(b * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store1(orow + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int H, int KV, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, H, KV, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tn, int H, int KV, int HD, int causal,
                cudaStream_t st) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tn, H, KV, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tn, H, KV, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tn, H, KV, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tn, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int HD, int dtype, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, HD, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, HD, causal,
                                      st);
  return (int)cudaErrorInvalidValue;
}
