// Flash-decode of one query token against a KV cache, for sm_90a: the
// hand-written CUDA replacement of the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py:decode_attention_kernel
// (grid (B, H, nk), the nk axis sequential with m/l/acc in VMEM scratch),
// and the function the JAX decode step computes in
// src/repro/models/attention.py:decode_attention.  Plain C interface,
// loaded with ctypes by src/repro_torch/kernels/decode_attention/kernel.py.
//
// What it computes: out[b,0,h] = softmax_j(q[b,0,h] . k[b,j,h/G] / sqrt(hd))
// . v[b,j,h/G] over j < cache_len[b] (clamped to [0, T]), G = H / KV <= 8;
// q, out (B,1,H,hd), caches (B,T,KV,hd), bf16 or f32 in, f32 softmax and
// accumulator.  With no valid position the output is 0 (denominator
// clamped at 1e-30), never NaN.
//
// Bound: bytes.  Each cache element is read once and used for 2 * G
// operations (a dot-product term per query head, an accumulate per query
// head), a few operations per byte against the H100's ridge of ~295, so
// the 3.35 TB/s of HBM bounds it.
//
// Design (what the TPU grid becomes):
//  * one block per (cache split, KV head, batch row) serves all G query
//    heads of its KV head, so each cache byte is read once (the TPU grid
//    ran one program per query head and re-read the KV block G times).
//  * 4 warps; a key is read by a group of hd / VEC lanes, each holding
//    one 16-byte vector (VEC = 8 bf16 or 4 f32), so a warp reads
//    32 / (hd / VEC) consecutive cache rows per load, fully coalesced.
//    Each lane group walks U keys per step with U loads in flight, keeps
//    the running max, denominator and accumulator of its G heads in
//    registers, and rescales once per step.
//  * partial softmaxes combine across the lane groups of a warp with
//    shuffles, across warps in shared memory, and across splits through a
//    small f32 scratch: the last block of a (batch row, KV head) to finish
//    (an atomic ticket after a __threadfence) combines them and resets its
//    ticket.  Splits exist so that small batches still put four blocks on
//    every SM; the wrapper picks their number.
//  * any T: positions past cache_len[b] are never loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;
constexpr int NT = NW * 32;
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

// weight of a partial with running max m under the combined max mx
__device__ __forceinline__ float rescale(float m, float mx) {
  return (m == -INFINITY) ? 0.f : expf(m - mx);
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ len,
                  T* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ counter, int Tn, int H, int KV,
                  int nsplit, int chunk) {
  constexpr int V = VecN<T>::N;
  constexpr int LPK = HD / V;          // lanes per key
  constexpr int KPW = 32 / LPK;        // keys per warp per load
  constexpr int U = GP >= 8 ? 2 : 4;   // keys per lane group per step
  constexpr int STEP = NW * KPW * U;
  __shared__ float sm_m[NW][GP], sm_l[NW][GP], sm_acc[NW][GP][HD];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int kg = lane / LPK, li = lane % LPK;
  const int L = min(max(len[b], 0), Tn);
  const int t_beg = split * chunk;
  const int t_end = min(t_beg + chunk, L);
  const float scale = 1.0f / sqrtf((float)HD);

  float qf[GP][V], m[GP], l[GP], acc[GP][V];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      load16(q + ((size_t)b * H + kvh * G + g) * HD + li * V, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qf[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  const size_t krow = (size_t)KV * HD;
  const T* kb = k + ((size_t)b * Tn * KV + kvh) * HD + li * V;
  const T* vb = v + ((size_t)b * Tn * KV + kvh) * HD + li * V;
  for (int base = t_beg; base < t_end; base += STEP) {
    float kk[U][V], vv[U][V];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * NW * KPW + w * KPW + kg;
      valid[u] = t < t_end;
      if (valid[u]) {
        load16(kb + (size_t)t * krow, kk[u]);
        load16(vb + (size_t)t * krow, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kk[u][e] = vv[u][e] = 0.f;
      }
    }
    float s[U][GP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d = fmaf(qf[g][e], kk[u][e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(FULL, d, o);
        s[u][g] = valid[u] ? d * scale : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) continue;     // nothing valid for this group yet
      const float corr = rescale(m[g], mx);
      float p[U], ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = valid[u] ? expf(s[u][g] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vv[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mx;
    }
  }

  // combine the KPW lane groups of the warp
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo = __shfl_xor_sync(FULL, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = rescale(m[g], mx), c = rescale(mo, mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mx;
    }
  }
  if (kg == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (li == 0) {
        sm_m[w][g] = m[g];
        sm_l[w][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) sm_acc[w][g][li * V + e] = acc[g][e];
    }
  }
  __syncthreads();

  // combine the warps: one thread per (head, dim)
  const size_t pstride = (size_t)GP * (HD + 2);       // one split's record
  float* pbase =
      nsplit > 1 ? part + ((size_t)b * KV + kvh) * nsplit * pstride : nullptr;
  for (int idx = threadIdx.x; idx < GP * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NW; ++i) mx = fmaxf(mx, sm_m[i][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float e = rescale(sm_m[i][g], mx);
      lsum += sm_l[i][g] * e;
      a += sm_acc[i][g][d] * e;
    }
    if (nsplit == 1) {
      if (g < G)
        store1(out + ((size_t)b * H + kvh * G + g) * HD + d,
               a / fmaxf(lsum, 1e-30f));
    } else {
      float* rec = pbase + split * pstride + (size_t)g * (HD + 2);
      if (d == 0) {
        rec[0] = mx;
        rec[1] = lsum;
      }
      rec[2 + d] = a;
    }
  }
  if (nsplit == 1) return;

  // the last split block of this (batch row, KV head) combines the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(&counter[b * KV + kvh], 1);
    is_last = ticket == nsplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, __ldcg(pbase + s * pstride + (size_t)g * (HD + 2)));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* rec = pbase + s * pstride + (size_t)g * (HD + 2);
      const float e = rescale(__ldcg(rec), mx);
      lsum += __ldcg(rec + 1) * e;
      a += __ldcg(rec + 2 + d) * e;
    }
    store1(out + ((size_t)b * H + kvh * G + g) * HD + d,
           a / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) counter[b * KV + kvh] = 0;
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* out, float* part, int* counter, int B, int Tn, int H,
           int KV, int nsplit, cudaStream_t st) {
  const int chunk = (Tn + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, KV, B);
  decode_kernel<T, HD, GP><<<grid, NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, static_cast<T*>(out), part, counter,
      Tn, H, KV, nsplit, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v, const int* len,
               void* out, float* part, int* counter, int B, int Tn, int H,
               int KV, int nsplit, cudaStream_t st) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, HD, 1>(q, k, v, len, out, part, counter, B, Tn, H, KV,
                            nsplit, st);
  if (G <= 2)
    return launch<T, HD, 2>(q, k, v, len, out, part, counter, B, Tn, H, KV,
                            nsplit, st);
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, len, out, part, counter, B, Tn, H, KV,
                            nsplit, st);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, len, out, part, counter, B, Tn, H, KV,
                            nsplit, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const int* len,
                void* out, float* part, int* counter, int B, int Tn, int H,
                int KV, int HD, int nsplit, cudaStream_t st) {
  switch (HD) {
    case 16: return dispatch_g<T, 16>(q, k, v, len, out, part, counter, B,
                                      Tn, H, KV, nsplit, st);
    case 32: return dispatch_g<T, 32>(q, k, v, len, out, part, counter, B,
                                      Tn, H, KV, nsplit, st);
    case 64: return dispatch_g<T, 64>(q, k, v, len, out, part, counter, B,
                                      Tn, H, KV, nsplit, st);
    case 128: return dispatch_g<T, 128>(q, k, v, len, out, part, counter, B,
                                        Tn, H, KV, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  part / counter may be null when
// nsplit == 1; otherwise part holds B * KV * nsplit * GP * (hd + 2) floats
// (GP = H / KV rounded up to 1, 2, 4 or 8) and counter B * KV zeroed ints,
// which the kernel leaves zeroed.  Returns the launch's cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, void* part,
                                void* counter, int B, int T, int H, int KV,
                                int HD, int dtype, int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || nsplit <= 0 ||
      (nsplit > 1 && (part == nullptr || counter == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counter);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, len, out, p, c, B, T, H, KV, HD,
                              nsplit, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, len, out, p, c, B, T, H, KV,
                                      HD, nsplit, st);
  return (int)cudaErrorInvalidValue;
}
