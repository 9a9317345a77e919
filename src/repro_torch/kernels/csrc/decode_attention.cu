// Flash-decode of one query token against a KV cache, for sm_90a: the
// hand-written CUDA replacement of the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py:decode_attention_kernel
// (grid (B, H, nk), the nk axis sequential with m/l/acc in VMEM scratch),
// and the function the JAX decode step computes in
// src/repro/models/attention.py:decode_attention.  Plain C interface,
// loaded with ctypes by src/repro_torch/kernels/decode_attention/kernel.py,
// which picks the route and the number of cache splits.
//
// What it computes: out[b,0,h] = softmax_j(q[b,0,h] . k[b,j,h/G] / sqrt(hd))
// . v[b,j,h/G] over j < cache_len[b] (clamped to [0, T]), G = H / KV <= 8;
// q, out (B,1,H,hd), caches (B,T,KV,hd), bf16 or f32 in, f32 softmax and
// accumulator; P is rounded to v's dtype before P.V as in the Pallas
// kernel.  With no valid position the output is 0 (denominator clamped at
// 1e-30), never NaN.
//
// The (o, lse) form, for a cache sharded over its sequence axis: with a
// non-null `lse` (B, H) float32 the kernel also writes each row's
// log-sum-exp of the scaled scores over its valid positions, lse = m +
// log(l) from the running max m and sum l the combining block holds, and
// writes out as float32 instead of q's dtype, so the shards' partial
// softmaxes can be merged (models/attention.py).  A row with no valid
// position gives lse = -inf and o = 0.
//
// Bound: bytes.  Each cache element is read once and used for 2 * G
// operations, a few operations per byte against the H100's ridge of ~295,
// so the 3.35 TB/s of HBM bounds it.  What reaches HBM is enough bytes in
// flight per SM, every byte read once, and little work per byte.
//
// Routes, chosen by the launcher from dtype and head_dim before the launch:
//
//   | dtype | head_dim | route        | entry point             |
//   |-------|----------|--------------|-------------------------|
//   | bf16  | 64, 128  | tensor cores | decode_attention_tc     |
//   | bf16  | 16, 32   | scalar f32   | decode_attention        |
//   | f32   | any      | scalar f32   | decode_attention        |
//
// Tensor-core route (namespace tc):
//  * one block of 4 warps per (cache split, KV head, batch row) serves all
//    G query heads of its KV head, so each cache byte is read once.  The
//    number of splits comes from the launcher (`n_splits`): about one
//    block per SM, all resident in one wave at the occupancy that
//    `decode_attention_tc_occupancy` reports (one streaming block per SM
//    reaches HBM; further splits only add combine work).
//  * copies: K and V tiles of 64 cache rows stream through a ring of 3
//    stages in shared memory by cp.async (16 bytes a thread, rows past
//    cache_len zero-filled, never read); each thread keeps 2 tiles in
//    flight ahead of the one being consumed, one barrier per tile.  Rows
//    are padded by 16 bytes so ldmatrix reads them without bank conflicts.
//  * scores: mma.sync m16n8k16 with the G query rows as the M operand
//    padded to 16 (rows 8-15 are the constant 0 and G <= 8 fills the rest;
//    the tensor cores make the padding free) and 16 keys of the tile per
//    warp as N, so no (key, head) dot product needs a shuffle.  Each lane
//    then holds distinct (head, key) scores: every exponent is computed
//    once, the row max takes two quad shuffles per 16 keys, the row sum
//    none until the end.  P, converted to bf16 in registers, is the A
//    fragment of P.V (the accumulator layout lines up), V is read by
//    ldmatrix.trans.
//  * partial softmaxes combine across the 4 warps in shared memory (the
//    ring, reused) and across splits through a small f32 scratch: the last
//    block of a (batch row, KV head) to finish (an atomic ticket after a
//    __threadfence) combines them and resets its ticket.
//
// Scalar route (namespace scalar): lane groups of hd / 8
// lanes per key, U keys per step, a shuffle per (key, head) dot product;
// the same split combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

// weight of a partial with running max m under the combined max mx
__device__ __forceinline__ float rescale(float m, float mx) {
  return (m == -INFINITY) ? 0.f : expf(m - mx);
}

namespace scalar {

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

// element d of (row, head) `rh`'s output from the combined accumulator a,
// sum l and max m (natural-log units): in T, or with lse in float32 and
// its log-sum-exp beside it
template <typename T, int HD>
__device__ __forceinline__ void put(void* out, float* lse, size_t rh, int d,
                                    float a, float l, float m) {
  const float o = a / fmaxf(l, 1e-30f);
  if (lse == nullptr) {
    store1(static_cast<T*>(out) + rh * HD + d, o);
    return;
  }
  static_cast<float*>(out)[rh * HD + d] = o;
  if (d == 0) lse[rh] = m + logf(l);
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ len,
                  void* __restrict__ out_, float* __restrict__ lse,
                  float* __restrict__ part, int* __restrict__ counter,
                  int Tn, int H, int KV, int nsplit, int chunk) {
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
        put<T, HD>(out_, lse, (size_t)b * H + kvh * G + g, d, a, lsum, mx);
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
    put<T, HD>(out_, lse, (size_t)b * H + kvh * G + g, d, a, lsum, mx);
  }
  if (threadIdx.x == 0) counter[b * KV + kvh] = 0;
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* out, float* lse, float* part, int* counter, int B, int Tn,
           int H, int KV, int nsplit, cudaStream_t st) {
  const int chunk = (Tn + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, KV, B);
  decode_kernel<T, HD, GP><<<grid, NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, out, lse, part, counter, Tn, H, KV,
      nsplit, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v, const int* len,
               void* out, float* lse, float* part, int* counter, int B,
               int Tn, int H, int KV, int nsplit, cudaStream_t st) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, HD, 1>(q, k, v, len, out, lse, part, counter, B, Tn, H,
                            KV, nsplit, st);
  if (G <= 2)
    return launch<T, HD, 2>(q, k, v, len, out, lse, part, counter, B, Tn, H,
                            KV, nsplit, st);
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, len, out, lse, part, counter, B, Tn, H,
                            KV, nsplit, st);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, len, out, lse, part, counter, B, Tn, H,
                            KV, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const int* len,
                void* out, float* lse, float* part, int* counter, int B,
                int Tn, int H, int KV, int HD, int nsplit, cudaStream_t st) {
  switch (HD) {
    case 16: return dispatch_g<T, 16>(q, k, v, len, out, lse, part, counter,
                                      B, Tn, H, KV, nsplit, st);
    case 32: return dispatch_g<T, 32>(q, k, v, len, out, lse, part, counter,
                                      B, Tn, H, KV, nsplit, st);
    case 64: return dispatch_g<T, 64>(q, k, v, len, out, lse, part, counter,
                                      B, Tn, H, KV, nsplit, st);
    case 128: return dispatch_g<T, 128>(q, k, v, len, out, lse, part,
                                        counter, B, Tn, H, KV, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


}  // namespace scalar

namespace tc {

constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr int BT = 64;              // cache rows per tile, 16 per warp
constexpr int ST = 3;               // ring stages
constexpr int GMAX = 8;             // query heads per KV head
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Layout {
  static constexpr int ROW = HD * 2 + 16;            // padded row, bytes
  static constexpr int TILE = BT * ROW;              // one K or V tile
  static constexpr int SMEM = ST * 2 * TILE;
  static constexpr int CHUNKS = HD / 8;              // 16-byte chunks a row
  // the warps' partials, reusing the ring after the loop
  static_assert(NW * GMAX * (HD + 2) * 4 <= SMEM, "combine buffer");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += A (16 x 16, rows 8-15 zero: a0 rows 0-7 k 0-7, a2
// rows 0-7 k 8-15) . B (16 x 8: b0 k 0-7, b1 k 8-15)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// weight of a partial with running max m (log2 units) under max mx
__device__ __forceinline__ float rescale2(float m, float mx) {
  return (m == -INFINITY) ? 0.f : exp2f(m - mx);
}

// element d of (row, head) `rh`'s output from the combined accumulator a,
// sum l and max m (log2 units): bf16, or with lse in float32 and its
// log-sum-exp (natural units) beside it
template <int HD>
__device__ __forceinline__ void put(void* out, float* lse, size_t rh, int d,
                                    float a, float l, float m) {
  const float o = a / fmaxf(l, 1e-30f);
  if (lse == nullptr) {
    static_cast<__nv_bfloat16*>(out)[rh * HD + d] = __float2bfloat16(o);
    return;
  }
  static_cast<float*>(out)[rh * HD + d] = o;
  if (d == 0) lse[rh] = (m + log2f(l)) * 0.6931471805599453f;
}

// Fragment layout (lane l, g = l / 4): the scores of n-block nb are
// s[nb][e] = (head g, key 8 nb + 2 (l % 4) + e); the output accumulator
// o[nb][e] = (head g, dim 8 nb + 2 (l % 4) + e), o[nb][2..3] the zero rows.
template <int HD>
__global__ void __launch_bounds__(NT)
    decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ len, void* __restrict__ out_,
                     float* __restrict__ lse, float* __restrict__ part,
                     int* __restrict__ counter, int Tn, int H, int KV,
                     int nsplit, int chunk, float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const uint32_t ring = smem_u32(smem);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, lq = lane & 3;
  const int Lb = min(max(len[b], 0), Tn);
  const int t_beg = split * chunk;
  const int t_end = min(t_beg + chunk, Lb);
  const int ntiles = t_end > t_beg ? (t_end - t_beg + BT - 1) / BT : 0;

  const size_t krow = (size_t)KV * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Tn * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Tn * KV + kvh) * HD;

  // tile i (rows t_beg + 64 i ...) into stage s: K then V, rows at or past
  // t_end zero-filled
  auto issue = [&](int i, int s) {
    const int row0 = t_beg + i * BT;
#pragma unroll
    for (int it = 0; it < 2 * BT * L::CHUNKS / NT; ++it) {
      const int idx = threadIdx.x + it * NT;
      const int which = idx / (BT * L::CHUNKS);
      const int rem = idx % (BT * L::CHUNKS);
      const int r = rem / L::CHUNKS, c = rem % L::CHUNKS;
      const int t = row0 + r;
      const bool ok = t < t_end;
      const __nv_bfloat16* src =
          (which ? vb : kb) + (size_t)(ok ? t : t_beg) * krow + c * 8;
      cp_async16(ring + (s * 2 + which) * L::TILE + r * L::ROW + c * 16, src,
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < ntiles) issue(i, i);
    cp_commit();
  }

  // q as the A fragments, rows g < G real
  uint32_t qa[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (g < G) {
      const __nv_bfloat16* qp =
          q + ((size_t)b * H + kvh * G + g) * HD + 16 * kk + 2 * lq;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qp);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    } else {
      qa[kk][0] = qa[kk][1] = 0u;
    }
  }

  float m = -INFINITY, l = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

  // ldmatrix row addresses of this lane: K (non-transposed) matrices
  // (keys 0-7 | 8-15) x (dims +0 | +8), V (transposed) the same with the
  // roles of the two halves swapped
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t k_lane = (16 * w + (mi >> 1) * 8 + mr) * L::ROW + (mi & 1) * 16;
  const uint32_t v_lane = (16 * w + (mi & 1) * 8 + mr) * L::ROW + (mi >> 1) * 16;

  for (int i = 0; i < ntiles; ++i) {
    cp_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < ntiles) issue(i + ST - 1, (i + ST - 1) % ST);
    cp_commit();
    const int s = i % ST;
    const uint32_t ks = ring + (s * 2) * L::TILE, vs = ks + L::TILE;
    const int t0 = t_beg + i * BT + 16 * w;          // this warp's 16 keys
    if (t0 >= t_end) continue;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(ks + k_lane + kk * 32, kf);
      mma(sc[0], qa[kk][0], qa[kk][1], kf[0], kf[1]);
      mma(sc[1], qa[kk][0], qa[kk][1], kf[2], kf[3]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + 8 * nb + 2 * lq + e;
        const float x = t < t_end ? sc[nb][e] * scale_log2 : -INFINITY;
        sc[nb][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float mn = fmaxf(m, mx);                   // finite: key t0 valid
    const float corr = exp2f(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nb][e] = exp2f(sc[nb][e] - mn);
        ps += sc[nb][e];
      }
    l = l * corr + ps;
    m = mn;
    const uint32_t pa0 = pack_bf16(sc[0][0], sc[0][1]);
    const uint32_t pa2 = pack_bf16(sc[1][0], sc[1][1]);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      o[nb][0] *= corr;
      o[nb][1] *= corr;
    }
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t vf[4];
      ldsm_x4_t(vs + v_lane + n2 * 32, vf);
      mma(o[2 * n2], pa0, pa2, vf[0], vf[1]);
      mma(o[2 * n2 + 1], pa0, pa2, vf[2], vf[3]);
    }
  }
  cp_wait<0>();
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  __syncthreads();                                   // the ring is free

  // the warps' partials: cm[w][g], cl[w][g], co[w][g][d]
  float* cm = reinterpret_cast<float*>(smem);
  float* cl = cm + NW * GMAX;
  float* co = cl + NW * GMAX;
  if (g < G) {
    if (lq == 0) {
      cm[w * GMAX + g] = m;
      cl[w * GMAX + g] = l;
    }
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      float* dst = co + (w * GMAX + g) * HD + 8 * nb + 2 * lq;
      dst[0] = o[nb][0];
      dst[1] = o[nb][1];
    }
  }
  __syncthreads();

  // combine the warps: one thread per (head, dim)
  const size_t pstride = (size_t)G * (HD + 2);       // one split's record
  float* pbase =
      nsplit > 1 ? part + ((size_t)b * KV + kvh) * nsplit * pstride : nullptr;
  for (int idx = threadIdx.x; idx < G * HD; idx += NT) {
    const int hg = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NW; ++i) mx = fmaxf(mx, cm[i * GMAX + hg]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float e = rescale2(cm[i * GMAX + hg], mx);
      lsum += cl[i * GMAX + hg] * e;
      a += co[(i * GMAX + hg) * HD + d] * e;
    }
    if (nsplit == 1) {
      put<HD>(out_, lse, (size_t)b * H + kvh * G + hg, d, a, lsum, mx);
    } else {
      float* rec = pbase + split * pstride + (size_t)hg * (HD + 2);
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
    const int hg = idx / HD, d = idx % HD;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, __ldcg(pbase + s * pstride + (size_t)hg * (HD + 2)));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* rec = pbase + s * pstride + (size_t)hg * (HD + 2);
      const float e = rescale2(__ldcg(rec), mx);
      lsum += __ldcg(rec + 1) * e;
      a += __ldcg(rec + 2 + d) * e;
    }
    put<HD>(out_, lse, (size_t)b * H + kvh * G + hg, d, a, lsum, mx);
  }
  if (threadIdx.x == 0) counter[b * KV + kvh] = 0;
}

template <int HD>
int prepare(bool* done) {
  return smem_limit_once((const void*)decode_tc_kernel<HD>, Layout<HD>::SMEM,
                         done);
}

template <int HD>
struct Attr {
  static bool done[MAX_DEVICES];
};
template <int HD>
bool Attr<HD>::done[MAX_DEVICES] = {};

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* out, float* lse, float* part, int* counter, int B, int Tn,
           int H, int KV, int nsplit, cudaStream_t st) {
  const int e = prepare<HD>(Attr<HD>::done);
  if (e) return e;
  const int chunk = (Tn + nsplit - 1) / nsplit;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  const dim3 grid(nsplit, KV, B);
  decode_tc_kernel<HD><<<grid, NT, Layout<HD>::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), len, out, lse, part, counter, Tn,
      H, KV, nsplit, chunk, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int occupancy(int* blocks) {
  const int e = prepare<HD>(Attr<HD>::done);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_tc_kernel<HD>, NT, Layout<HD>::SMEM);
}

}  // namespace tc

}  // namespace

// The scalar route: dtype 0 float32, 1 bfloat16.  lse null: out in the
// input dtype; else out float32 and lse (B, H) float32 (the (o, lse)
// form).  part / counter may be null when nsplit == 1; otherwise part
// holds B * KV * nsplit * GP * (hd + 2) floats (GP = H / KV rounded up to
// 1, 2, 4 or 8) and counter B * KV zeroed ints, which the kernel leaves
// zeroed.  Returns the launch's cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, void* lse,
                                void* part, void* counter, int B, int T, int H,
                                int KV, int HD, int dtype, int nsplit,
                                void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || nsplit <= 0 ||
      (nsplit > 1 && (part == nullptr || counter == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  float* ls = static_cast<float*>(lse);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counter);
  if (dtype == 0)
    return scalar::dispatch_hd<float>(q, k, v, len, out, ls, p, c, B, T, H,
                                      KV, HD, nsplit, st);
  if (dtype == 1)
    return scalar::dispatch_hd<__nv_bfloat16>(q, k, v, len, out, ls, p, c, B,
                                              T, H, KV, HD, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16, head_dim 64 or 128, H / KV <= 8.
// lse as for the scalar route (null: out bf16; else out and lse float32);
// part / counter as for the scalar route but with records of G = H / KV
// heads: B * KV * nsplit * G * (hd + 2) floats.  Returns the launch's
// cudaError_t.
extern "C" int decode_attention_tc(const void* q, const void* k,
                                   const void* v, const void* cache_len,
                                   void* out, void* lse, void* part,
                                   void* counter, int B, int T, int H, int KV,
                                   int HD, int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || H / KV > tc::GMAX ||
      nsplit <= 0 || (nsplit > 1 && (part == nullptr || counter == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  float* ls = static_cast<float*>(lse);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counter);
  if (HD == 64)
    return tc::launch<64>(q, k, v, len, out, ls, p, c, B, T, H, KV, nsplit,
                          st);
  if (HD == 128)
    return tc::launch<128>(q, k, v, len, out, ls, p, c, B, T, H, KV, nsplit,
                           st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the tensor-core route resident per SM on the current device
// (the occupancy calculator at its block size and shared memory), which
// the launcher's split choice fills in whole waves.
extern "C" int decode_attention_tc_occupancy(int HD, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (HD == 64) return tc::occupancy<64>(n);
  if (HD == 128) return tc::occupancy<128>(n);
  return (int)cudaErrorInvalidValue;
}
