// Causal GQA flash attention for sm_90a: the hand-written CUDA replacement
// of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (grid (B, H, nq, nk), the nk axis sequential with m/l/acc in VMEM
// scratch).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py, which picks the route.
//
// What it computes: o[b,i,h] = softmax_j(q[b,i,h] . k[b,j,h/G] / sqrt(hd))
// . v[b,j,h/G] over the keys j <= i + (T - S) (all j < T when not causal),
// with G = H / KV.  q, o (B,S,H,hd); k, v (B,T,KV,hd); bf16 or f32 in,
// f32 scores, softmax and accumulator, output rounded once to the input
// type.  As in the Pallas kernel, P is rounded to v's dtype before P.V
// and the denominator sums the unrounded P.  A row that sees no key gets
// 0 (denominator clamped at 1e-30).
//
// Bound: the call reads q, k and v once and writes o once, and does 4 hd
// FLOPs per visible (query, key) pair.  At S = 8192 the pairs bound it
// (989 TFLOP/s of bf16 tensor cores: 130 us); at the serve shape, S = 512,
// the bytes do (3.35 TB/s: 6.3 us).  Inside the kernel a 128-key tile in
// shared memory serves 128 query rows, 128 FLOPs per byte of K/V, so the
// tensor cores, not the copies, set the pace.
//
// Routes, chosen by the launcher from dtype and head_dim before the launch
// (a failed build or launch raises; there is no fallback between them):
//
//   | dtype | head_dim | route        | entry point            |
//   |-------|----------|--------------|------------------------|
//   | bf16  | 64, 128  | tensor cores | flash_attention_tc     |
//   | bf16  | 16, 32   | scalar f32   | flash_attention        |
//   | f32   | any      | scalar f32   | flash_attention        |
//
// f32 stays scalar because f32 through the tensor cores is TF32, which
// misses the f32 tolerance; hd 16 and 32 (the reduced test configs) are
// narrower than the 128-byte swizzle row the tensor-core route is built
// on.
//
// Tensor-core route (namespace tc):
//  * one block per (query head, batch row, 128-row query tile), the grid
//    ordered so that every head's longest causal tile is issued before any
//    shorter one; 2 consumer warpgroups of 64 rows each and one producer
//    warp (288 threads, one block per SM at hd 64 and 128).
//  * copies: the producer's lane 0 issues TMA loads (cp.async.bulk.tensor,
//    4-D tensor maps over (B, rows, heads, hd) so the KV head is read as
//    h / G with no repeat, and rows past S or T are zero-filled by the
//    hardware, never read) into a ring of 2 stages of K and V tiles (128
//    keys), each stage guarded by a "full" mbarrier (transaction bytes)
//    and an "empty" one (one arrival per consumer warp).  TMA was chosen
//    over cp.async because one thread moves a whole tile with no address
//    arithmetic in the consumers, and it writes the 128-byte swizzle that
//    the wgmma descriptors read.  Tiles stay bf16 in shared memory, one
//    128-byte swizzled panel per 64 columns of hd.
//  * products: S = Q.K^T by wgmma.mma_async m64n128k16 with both operands
//    K-major in shared memory; P.V by m64n64k16 with P from registers (the
//    S accumulator converted to bf16 in place: its layout is the A
//    fragment's) and V read through the descriptor's transpose bit, one
//    instruction per 64-column panel of hd.  f32 accumulators.
//  * the causal loop ends at the diagonal (per warpgroup), only tiles that
//    cross the diagonal or T are masked, and the online softmax runs on
//    the accumulator fragments in log2 units (one FFMA and one ex2 per
//    score; each row's 32 scores of a tile sit in one quad of lanes: two
//    shuffles for the max, the sum stays per-thread until the end).
//  * tried on an H100 and ranked (PERF.md): 128-key tiles beat 64-key
//    ones, the longest-first grid order beats head-major order, 2 stages
//    match 3, and overlapping the next tile's Q.K^T with this tile's
//    softmax (a second score buffer) lost at 128-key tiles, so each
//    product is waited for and the two warpgroups (and the producer)
//    overlap instead.  One warpgroup per block won at the serve shape and
//    lost at S = 8192; three the reverse at hd 64 and lost at hd 128
//    (capped at 128 registers), so two it is.
//
// Scalar route (namespace scalar): one block of 256
// threads per (64-row query tile, head, batch row), Q/K/V/P tiles widened
// to f32 in padded shared memory, scalar FMAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

namespace scalar {

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
  static bool attr_set[MAX_DEVICES] = {};
  const int e = smem_limit_once((const void*)flash_kernel<T, HD>, (int)smem,
                                attr_set);
  if (e) return e;
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


}  // namespace scalar

namespace tc {

constexpr int BQ = 128;               // query rows per block
constexpr int NWG = 2;                // consumer warpgroups, 64 rows each
constexpr int NCW = NWG * 4;          // consumer warps
constexpr int NT = NCW * 32 + 32;     // + one producer warp
constexpr int BK = 128;               // keys per K/V tile
constexpr int ST = 2;                 // ring stages
constexpr int QROWS = 64;             // rows of a Q box: one warpgroup
constexpr int ROW_BYTES = 128;        // one swizzled panel row: 64 bf16

template <int HD>
struct Layout {
  static constexpr int P = HD / 64;                       // column panels
  static constexpr int Q_PANEL = QROWS * ROW_BYTES;       // 8 KB
  static constexpr int Q_BYTES = NWG * P * Q_PANEL;
  static constexpr int KV_PANEL = BK * ROW_BYTES;
  static constexpr int KV_BYTES = P * KV_PANEL;           // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BAR = Q_BYTES + ST * STAGE;        // mbarriers
  static constexpr int SMEM = BAR + 8 * (2 * ST + 1) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box {64 columns, 1 head, rows, 1 batch row} of a 4-D tensor map into
// shared memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulator registers across the
// asynchronous wgmma (issue ... wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC32(d, o)                                                     \
  F4(d, o + 0), F4(d, o + 4), F4(d, o + 8), F4(d, o + 12), F4(d, o + 16), \
      F4(d, o + 20), F4(d, o + 24), F4(d, o + 28)
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, "
#define REGS64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), both from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d, 0), ACC32(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragment in registers) . B (16 x 64)
// with B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F4
#undef ACC32
#undef REGS32
#undef REGS64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of m64nNk16 for thread (warp w of the warpgroup, lane
// l): d[i] is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.

// S = Q.K^T of one BK-key tile: hd / 16 wgmma steps, both operands K-major
// 128-byte-swizzled panels (the k-th step 32 bytes into a panel)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t ks) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32, p = kk >> 2;
    wgmma_ss(sc, sdesc(q_wg + p * L::Q_PANEL + col, 16, 1024),
             sdesc(ks + p * L::KV_PANEL + col, 16, 1024), kk > 0);
  }
}

// O += P.V of one BK-key tile: P from registers (BK / 16 steps of 16
// keys), V MN-major through the transpose bit, one wgmma per 64-column
// panel of hd
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 64][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int p = 0; p < HD / 64; ++p)
      wgmma_rs(acc[p], pa[kk],
               sdesc(vs + p * L::KV_PANEL + kk * 16 * ROW_BYTES, 1024, 1024));
}

// Online softmax of one score tile in place: masks keys past T or the
// diagonal (only where `masked`), updates the rows' running max (log2
// units) and per-thread partial sums, leaves P (f32) in sc and the
// accumulator's rescale factors in c0 / c1 (rows r0 / r1).
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N], int k0, int r0, int r1, int Tn, int off, int causal,
    bool masked, float scale_log2, int lane, float& m0, float& m1,
    float& l0, float& l1, float& c0, float& c1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (masked) {
      const int c = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int r = (i & 2) ? r1 : r0;
      if (c >= Tn || (causal && c > r + off)) sc[i] = -INFINITY;
    }
    if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
  }
  const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  c0 = mn0 == -INFINITY ? 1.f : ex2(m0 - mn0);
  c1 = mn1 == -INFINITY ? 1.f : ex2(m1 - mn1);
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float pv = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -b1 : -b0));
    sc[i] = pv;
    if (i & 2) ps1 += pv; else ps0 += pv;
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

// P (f32, accumulator layout) as the bf16 A fragments of the 16-key steps
// of P.V: the accumulator's layout is the A fragment's
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, int S, int Tn, int H,
                    int KV, int causal, float scale_log2) {
  using L = Layout<HD>;
  constexpr int P = L::P;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + L::Q_BYTES;
  const uint32_t full = base + L::BAR, empty = full + 8 * ST,
                 qbar = full + 16 * ST;

  // grid (H, B, nq): every head and batch row of the longest query tile
  // is issued before any of the next, so the causal work runs longest
  // first across the whole grid
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int off = Tn - S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kend = causal ? min(Tn, q0 + BQ + off) : Tn;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCW);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {                   // producer warp: lane 0 issues TMA
    if (lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int g = 0; g < NWG; ++g)
        for (int p = 0; p < P; ++p)
          tma_load(q_s + (g * P + p) * L::Q_PANEL, &qmap, qbar, 64 * p, h,
                   q0 + QROWS * g, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(empty + 8 * s, ((j / ST) - 1) & 1);
        const uint32_t ks = kv_s + s * L::STAGE, vs = ks + L::KV_BYTES;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        for (int p = 0; p < P; ++p) {
          tma_load(ks + p * L::KV_PANEL, &kmap, full + 8 * s, 64 * p, kvh,
                   j * BK, b);
          tma_load(vs + p * L::KV_PANEL, &vmap, full + 8 * s, 64 * p, kvh,
                   j * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp >> 2, w4 = warp & 3;
  const int row_first = q0 + 64 * wg;
  const int r0 = row_first + 16 * w4 + (lane >> 2), r1 = r0 + 8;
  const int kend_wg = causal ? min(Tn, row_first + 64 + off) : Tn;
  const int nwg = kend_wg > 0 ? (kend_wg + BK - 1) / BK : 0;
  const uint32_t q_wg = q_s + wg * P * L::Q_PANEL;
  float acc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 1.f,
        c1 = 1.f;
  auto masked = [&](int j) {
    return (j + 1) * BK > Tn || (causal && j * BK + BK - 1 > row_first + off);
  };

  mbar_wait(qbar, 0);
  // per tile: S = Q.K^T, softmax, O += P.V, each product waited for
  for (int j = 0; j < nwg; ++j) {
    const int s = j % ST;
    const uint32_t ks = kv_s + s * L::STAGE, vs = ks + L::KV_BYTES;
    mbar_wait(full + 8 * s, (j / ST) & 1);
    reg_fence(sc);
    wg_fence();
    issue_qk<HD>(sc, q_wg, ks);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    softmax_tile(sc, j * BK, r0, r1, Tn, off, causal, masked(j),
                 scale_log2, lane, m0, m1, l0, l1, c0, c1);
    pack_p(sc, pa);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= (i & 2) ? c1 : c0;
      reg_fence(acc[p]);
    }
    wg_fence();
    issue_pv<HD>(acc, pa, vs);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) reg_fence(acc[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  // tiles past this warpgroup's diagonal: release them unread
  for (int j = nwg; j < ntiles; ++j) {
    mbar_wait(full + 8 * (j % ST), (j / ST) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (j % ST));
  }

  const float inv0 = 1.0f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.0f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i & 2) ? r1 : r0;
      if (r >= S) continue;
      const float inv = (i & 2) ? inv1 : inv0;
      const int c = 64 * p + 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)(b * S + r) * H + h) * HD + c) =
          __floats2bfloat162_rn(acc[p][i] * inv, acc[p][i + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query so the library needs no link against libcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, rows, heads, hd) bf16 tensor as a 4-D map {hd, heads, rows, B}
// read in boxes {64, 1, box_rows, 1}, 128-byte swizzled; rows or columns
// out of range read as zero.
int make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
             int hd, int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int H, int KV, int causal, cudaStream_t st) {
  using L = Layout<HD>;
  static bool attr_set[MAX_DEVICES] = {};
  int e = smem_limit_once((const void*)flash_tc_kernel<HD>,
                          L::SMEM, attr_set);
  if (e) return e;
  CUtensorMap qm, km, vm;
  if ((e = make_map(&qm, q, B, S, H, HD, QROWS))) return e;
  // with T = 0 no K/V tile is loaded (every row gets 0): the two maps are
  // never read and only need a valid address and extent
  if ((e = make_map(&km, Tn > 0 ? k : q, B, max(Tn, 1), KV, HD, BK)))
    return e;
  if ((e = make_map(&vm, Tn > 0 ? v : q, B, max(Tn, 1), KV, HD, BK)))
    return e;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_tc_kernel<HD><<<grid, NT, L::SMEM, st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, Tn, H, KV, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The scalar route: dtype 0 float32, 1 bfloat16; head_dim 16, 32, 64 or
// 128.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int HD, int dtype, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return scalar::dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, HD, causal,
                                      st);
  if (dtype == 1)
    return scalar::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, HD,
                                              causal, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16, head_dim 64 or 128, q/k/v 16-byte
// aligned.  Returns the launch's cudaError_t.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o, int B, int S, int T,
                                  int H, int KV, int HD, int causal,
                                  void* stream) {
  if (B <= 0 || S <= 0 || T < 0 || H <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64)
    return tc::launch<64>(q, k, v, o, B, S, T, H, KV, causal, st);
  if (HD == 128)
    return tc::launch<128>(q, k, v, o, B, S, T, H, KV, causal, st);
  return (int)cudaErrorInvalidValue;
}
