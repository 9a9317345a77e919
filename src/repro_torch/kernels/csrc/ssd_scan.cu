// Mamba2 SSD chunked scan for sm_90a: the hand-written CUDA replacement of
// the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel (body _ssd_kernel)
// (grid (B, H, nc), the chunk axis sequential with the (P,N) state in VMEM
// scratch).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/ssd_scan/kernel.py, which picks the route.
//
// What it computes, per (batch b, head h), over the chunks in order with
// the f32 state h_prev (P,N), zero before the first chunk:
//   cs      = cumsum_q(A[h] * dt[q])                         (Q,)
//   w[i,j]  = (C_i . B_j) * exp(cs_i - cs_j) * dt_j  for j <= i, else 0,
//             rounded to x's dtype
//   y_i     = sum_j w[i,j] x_j  +  exp(cs_i) * (C_i . h_prev)     (f32 sums)
//   h       = h_prev * exp(cs_Q) + sum_j x_j (B_j exp(cs_Q - cs_j) dt_j)^T,
//             the B weights rounded to x's dtype
// with x (B,nc,Q,H,P) and Bm, Cm (B,nc,Q,N) in bf16 or f32, dt (B,nc,Q,H)
// and A (H,) in f32; y (B,nc,Q,H,P) in bf16 or f32 (the caller's choice:
// x's dtype is the Pallas contract, f32 is what the model's D skip and gate
// norm take); the final state (B,H,P,N) in f32.  The exponent above the
// diagonal is never taken (cs_i - cs_j > 0 there and exp may overflow; a
// masked inf times 0 would be NaN).  Q <= 256; P, N in {16, 64, 128}.
//
// Bound: at the serve shape (B=8, nc=2, Q=256, H=24, P=64, N=128, bf16 in,
// f32 y) the call must move 46.5 MB (x 12.6 MB, B and C 2.1 MB, dt 0.4 MB,
// y 25.2 MB, state 6.3 MB): 13.9 us at 3.35 TB/s.  The products it needs
// (C.B^T once per batch row and chunk over the causal pairs, w.x over the
// causal pairs and x^T.wB per head, C.h_prev per head after the first
// chunk) are 4.2 GFLOP: 4.2 us at the 989 TFLOP/s bf16 tensor rate.  So
// bytes bound it, by about three times.
//
// Routes, chosen by the launcher from dtype and (P, N) before the launch
// (a failed build or launch raises; there is no fallback between them):
//
//   | dtype | (P, N)           | route        | entry point   |
//   |-------|------------------|--------------|---------------|
//   | bf16  | {64, 128}^2      | tensor cores | ssd_scan_tc   |
//   | bf16  | a 16 in P or N   | scalar f32   | ssd_scan      |
//   | f32   | any              | scalar f32   | ssd_scan      |
//
// f32 stays scalar because f32 through the tensor cores is TF32, which
// misses the f32 tolerance; P or N = 16 (the reduced test configs) is
// narrower than the 64-row warp tiling of the tensor-core route.
//
// Tensor-core route (namespace tc): the standard SSD decomposition in three
// launches on one stream, so the chunk axis, sequential on the TPU only
// because its grid runs in order, runs in parallel except for one
// elementwise pass.  Every product is mma.sync m16n8k16 with bf16 operands
// (exact products) and f32 accumulation; operands are read from padded
// shared-memory rows (16 bytes of pad: ldmatrix is free of bank conflicts)
// by ldmatrix, .trans where the operand is stored k-major.
//  (a) ssd_state_kernel, one block per (batch row and chunk, head): x's
//      rows of the head and the chunk's B rows by cp.async, cs by a block
//      scan meanwhile (written out for (b) and (c)), wB = B * exp(cs_Q -
//      cs) * dt rounded to bf16 in place, then s_c = x^T . wB (M = P over
//      the 4 warps, N, K = Q) into a (B, nc, H, P, N) f32 scratch.
//  (b) ssd_pass_kernel, one thread per 8 state elements per (batch row,
//      head): walks the chunks, loading 8 ahead of the dependent chain,
//      h_c = h_{c-1} exp(cs_Q) + s_c in f32; over s_c it writes h_{c-1}
//      (the h_prev of chunk c) as bf16 hi + lo, and it writes the final
//      state in f32.
//  (c) ssd_out_kernel, one block per (batch row and chunk, head group of G,
//      64-row tile), the longest tiles issued first: C_i . B_j^T for every
//      column tile j <= i is computed ONCE per block (warps of 16 rows),
//      kept as f32 accumulator fragments in shared memory, and applied to
//      each head of the group, two heads in flight (one per warpgroup,
//      each with its own buffers and named barrier; one at P = N = 128,
//      where two do not fit in shared memory): per head the weights are
//      scaled, masked and rounded to bf16 in registers (the accumulator
//      layout is the A fragment's), then w . x_j with x_j streamed
//      through a 2-stage cp.async ring; the next head's operands are
//      fetched meanwhile.  y_off = exp(cs_i) C_i . h_prev keeps f32
//      accuracy with h_prev as bf16 hi + lo (two products, ~2^-17
//      relative).  G comes from the launcher (`head_group`): the largest
//      divisor of H that still leaves a block for every SM.
//
// Scalar route (namespace scalar): one block of 256 threads per (head,
// batch row) walks the chunks with the (P,N) f32 state in shared memory;
// each chunk's rows go 64 at a time against streamed 64-column tiles
// (B_j, x_j) widened to f32, the weight tile made, masked and rounded in
// registers and staged in shared memory; scalar FMAs.  184.6 KB of shared
// memory at P = N = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int TQ = 64;      // row / column tile of a chunk
constexpr int MAXQ = 256;   // longest chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

namespace scalar {

constexpr int NT = 256;     // threads per block, as 16 x 16
constexpr int WS = TQ + 1;  // padded row stride of the weight tile

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a float rounded to T and back, as `w.astype(x.dtype)` rounds it
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// shared-memory layout, in floats
template <int P, int N>
struct Smem {
  static constexpr int NS = N + 1;               // padded stride of (., N)
  static constexpr int H_OFF = 0;                // h_prev (P, NS)
  static constexpr int C_OFF = H_OFF + P * NS;   // C_i    (TQ, NS)
  static constexpr int B_OFF = C_OFF + TQ * NS;  // B_j    (TQ, NS)
  static constexpr int X_OFF = B_OFF + TQ * NS;  // x_j    (TQ, P)
  static constexpr int W_OFF = X_OFF + TQ * P;   // w      (TQ, WS)
  static constexpr int CS_OFF = W_OFF + TQ * WS; // cs     (MAXQ)
  static constexpr int DT_OFF = CS_OFF + MAXQ;   // dt     (MAXQ)
  static constexpr int G_OFF = DT_OFF + MAXQ;    // exp(cs_Q - cs) dt (MAXQ)
  static constexpr int WT_OFF = G_OFF + MAXQ;    // warp totals of the scan
  static constexpr size_t BYTES = sizeof(float) * (WT_OFF + NT / 32);
};

// rows [r0, r0 + TQ) of a (rows, COLS) operand with row stride `rs`
// elements into an f32 tile of row stride SS; rows at or past n_valid are 0
template <typename T, int COLS, int SS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n_valid, size_t rs) {
  for (int e = threadIdx.x; e < TQ * COLS; e += NT) {
    const int r = e / COLS, c = e % COLS;
    dst[r * SS + c] =
        (r0 + r < n_valid) ? ld(src + (size_t)(r0 + r) * rs + c) : 0.f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ A, void* __restrict__ y,
               float* __restrict__ state, int nc, int Q, int H,
               int out_bf16) {
  using S = Smem<P, N>;
  constexpr int NS = S::NS;
  constexpr int PJ = P / 16;   // y columns, state rows per thread
  constexpr int NJ = N / 16;   // state columns per thread
  extern __shared__ float sm[];
  float* hs = sm + S::H_OFF;
  float* Cs = sm + S::C_OFF;
  float* Bs = sm + S::B_OFF;
  float* Xs = sm + S::X_OFF;
  float* Ws = sm + S::W_OFF;
  float* cs = sm + S::CS_OFF;
  float* dts = sm + S::DT_OFF;
  float* gs = sm + S::G_OFF;
  float* wt = sm + S::WT_OFF;

  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4, lane = t & 31, warp = t >> 5;
  const float a = A[h];
  const size_t xrow = (size_t)H * P;   // row stride of x and y
  const int nt = (Q + TQ - 1) / TQ;

  for (int e = t; e < P * NS; e += NT) hs[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t row0 = ((size_t)b * nc + c) * Q;   // the chunk's first row
    const T* xc = x + row0 * xrow + (size_t)h * P;
    const T* Bc = Bm + row0 * N;
    const T* Cc = Cm + row0 * N;
    const size_t yc = row0 * xrow + (size_t)h * P;  // y offset, elements

    // cs = inclusive cumsum of a * dt over the chunk
    __syncthreads();                  // the last chunk is done with cs, gs, h
    const float d = t < Q ? dt[(row0 + t) * H + h] : 0.f;
    float v = a * d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wt[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wt[w];
    cs[t] = v;
    dts[t] = d;
    __syncthreads();
    const float cs_last = cs[Q - 1];
    gs[t] = t < Q ? expf(cs_last - v) * d : 0.f;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TQ;
      __syncthreads();                // Cs is free
      load_rows<T, N, NS>(Cs, Cc, i0, Q, N);
      __syncthreads();

      // y_off = exp(cs_i) * C_i . h_prev
      float yo[4][PJ], yd[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yo[i][j] = yd[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = hs[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yo[i][j] = fmaf(cv[i], hv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cs[i0 + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < PJ; ++j) yo[i][j] *= e;
      }

      // y_diag over the column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        __syncthreads();              // Bs, Xs and Ws are free
        load_rows<T, N, NS>(Bs, Bc, j0, Q, N);
        load_rows<T, P, P>(Xs, xc, j0, Q, xrow);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = j0 + tx + 16 * j;
            float w = 0.f;
            if (gj <= gi && gj < Q)   // mask before exp
              w = round_to<T>(s[i][j] * expf(cs[gi] - cs[gj]) * dts[gj]);
            Ws[(ty + 16 * i) * WS + tx + 16 * j] = w;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < TQ; ++k) {
          float wv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * WS + k];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = Xs[k * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              yd[i][j] = fmaf(wv[i], xv[j], yd[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty + 16 * i;
        if (gi >= Q) continue;
        const size_t yr = yc + (size_t)gi * xrow;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float v = yd[i][j] + yo[i][j];
          if (out_bf16)
            st(static_cast<__nv_bfloat16*>(y) + yr + tx + 16 * j, v);
          else
            st(static_cast<float*>(y) + yr + tx + 16 * j, v);
        }
      }
    }

    // state: h = h_prev * exp(cs_Q) + x^T . (B * exp(cs_Q - cs) * dt)
    float sacc[PJ][NJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sacc[i][j] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TQ;
      __syncthreads();                // Bs and Xs are free
      load_rows<T, N, NS>(Bs, Bc, j0, Q, N);
      load_rows<T, P, P>(Xs, xc, j0, Q, xrow);
      __syncthreads();
      const int kn = min(TQ, Q - j0);
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float gk = gs[j0 + k];
        float bv[NJ], xv[PJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          bv[j] = round_to<T>(Bs[k * NS + tx + 16 * j] * gk);
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[k * P + ty + 16 * i];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    __syncthreads();                  // every row tile has read h_prev
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* hp = hs + (ty + 16 * i) * NS + tx + 16 * j;
        *hp = *hp * decay + sacc[i][j];
      }
  }

  __syncthreads();
  float* so = state + ((size_t)b * H + h) * P * N;
  for (int e = t; e < P * N; e += NT) so[e] = hs[(e / N) * NS + e % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* Bm, const void* Cm, const float* dt,
           const float* A, void* y, float* state, int B, int nc, int Q,
           int H, int out_bf16, cudaStream_t st) {
  constexpr size_t smem = Smem<P, N>::BYTES;
  static bool done[MAX_DEVICES] = {};
  const int e =
      smem_limit_once((const void*)ssd_kernel<T, P, N>, (int)smem, done);
  if (e) return e;
  const dim3 grid(H, B);
  ssd_kernel<T, P, N><<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, y, state, nc, Q, H, out_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const void* Bm, const void* Cm,
               const float* dt, const float* A, void* y, float* state, int B,
               int nc, int Q, int H, int N, int out_bf16, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                     H, out_bf16, st);
    case 64: return launch<T, P, 64>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                     H, out_bf16, st);
    case 128: return launch<T, P, 128>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                       H, out_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(const void* x, const void* Bm, const void* Cm,
               const float* dt, const float* A, void* y, float* state, int B,
               int nc, int Q, int H, int P, int N, int out_bf16,
               cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                      H, N, out_bf16, st);
    case 64: return dispatch_n<T, 64>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                      H, N, out_bf16, st);
    case 128: return dispatch_n<T, 128>(x, Bm, Cm, dt, A, y, state, B, nc, Q,
                                        H, N, out_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace scalar

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;             // warps per block
constexpr int NT = NW * 32;

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

// d (16 x 8, f32) += A (16 x 16: a0 rows 0-7 k 0-7, a1 rows 8-15 k 0-7, a2
// rows 0-7 k 8-15, a3 rows 8-15 k 8-15) . B (16 x 8: b0 k 0-7, b1 k 8-15).
// Lane l holds d[0..1] = (row l/4, cols 2(l%4) + 0..1), d[2..3] the same
// columns of row l/4 + 8.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ldmatrix lane addresses (lane l, mi = l / 8, r8 = l % 8) for a 16 x 16
// bf16 block at (row0, col0) of a row-major shared array of `rb` bytes a
// row.  A operand stored (m, k): rows row0 + (mi & 1) 8 + r8, columns col0
// + (mi >> 1) 8.  B operand stored (n, k), two n-blocks: rows row0 + (mi >>
// 1) 8 + r8, columns col0 + (mi & 1) 8.  Both transposed forms (stored (k,
// m) or (k, n), read with .trans) swap the roles of the two halves.
__device__ __forceinline__ uint32_t addr_a(uint32_t base, int rb, int row0,
                                           int col0, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
  return base + (row0 + (mi & 1) * 8 + r8) * rb + (col0 + (mi >> 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t addr_b(uint32_t base, int rb, int row0,
                                           int col0, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
  return base + (row0 + (mi >> 1) * 8 + r8) * rb + (col0 + (mi & 1) * 8) * 2;
}

// Inclusive cumsum over the block's 2 * NT elements, thread t holding
// elements 2t and 2t + 1 in v0, v1; `wt` holds NW floats.
__device__ __forceinline__ void cumsum2(float& v0, float& v1, float* wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v1 += v0;
  float s = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) wt[warp] = s;
  __syncthreads();
  float off = s - v1;
  for (int w = 0; w < warp; ++w) off += wt[w];
  v0 += off;
  v1 += off;
}

// (a) ---------------------------------------------------------------------
template <int P, int N>
struct StateSmem {
  static constexpr int XB = P * 2 + 16;          // padded row bytes of x
  static constexpr int WB = N * 2 + 16;          // ... of wB
  static constexpr int X_OFF = 0;                // x rows of the head (Q, P)
  static constexpr int W_OFF = X_OFF + MAXQ * XB;   // wB (Q, N)
  static constexpr int CS_OFF = W_OFF + MAXQ * WB;  // cs (MAXQ f32)
  static constexpr int G_OFF = CS_OFF + MAXQ * 4;   // exp(cs_Q - cs) dt
  static constexpr int WT_OFF = G_OFF + MAXQ * 4;   // scan warp totals
  static constexpr int BYTES = WT_OFF + NW * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                     const float* __restrict__ dt,
                     const float* __restrict__ A, float* __restrict__ cs_out,
                     float* __restrict__ states, int Q, int H) {
  using S = StateSmem<P, N>;
  constexpr int XC = P / 8, WC = N / 8;   // 16-byte chunks a row
  constexpr int MT = P / 64;              // 16-row m-tiles per warp
  constexpr int NB = N / 8;               // 8-column n-blocks
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* sm = smem_tc;
  float* csv = reinterpret_cast<float*>(sm + S::CS_OFF);
  float* gv = reinterpret_cast<float*>(sm + S::G_OFF);
  float* wt = reinterpret_cast<float*>(sm + S::WT_OFF);
  const int bc = blockIdx.x, h = blockIdx.y;   // bc = b * nc + c
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int Qp = (Q + 15) & ~15;
  const size_t row0 = (size_t)bc * Q;
  const uint32_t xs = smem_u32(sm + S::X_OFF), ws = smem_u32(sm + S::W_OFF);

  // the head's x rows (rows Q..Qp zero)
  for (int e = t; e < Qp * XC; e += NT) {
    const int q = e / XC, c8 = e % XC;
    const bool ok = q < Q;
    cp_async16(xs + q * S::XB + c8 * 16,
               x + ((row0 + (ok ? q : 0)) * H + h) * P + c8 * 8, ok ? 16 : 0);
  }
  // B rows (rows Q..Qp zero), scaled in place below
  for (int e = t; e < Qp * WC; e += NT) {
    const int q = e / WC, c8 = e % WC;
    const bool ok = q < Q;
    cp_async16(ws + q * S::WB + c8 * 16,
               Bm + (row0 + (ok ? q : 0)) * N + c8 * 8, ok ? 16 : 0);
  }
  cp_commit();

  // cs, written out for the state pass and the outputs
  const float a = A[h];
  const int q0 = 2 * t;
  const float d0 = q0 < Q ? dt[(row0 + q0) * H + h] : 0.f;
  const float d1 = q0 + 1 < Q ? dt[(row0 + q0 + 1) * H + h] : 0.f;
  float v0 = a * d0, v1 = a * d1;
  cumsum2(v0, v1, wt);
  csv[q0] = v0;
  csv[q0 + 1] = v1;
  float* cso = cs_out + ((size_t)bc * H + h) * Q;
  if (q0 < Q) cso[q0] = v0;
  if (q0 + 1 < Q) cso[q0 + 1] = v1;
  __syncthreads();
  const float last = csv[Q - 1];
  gv[q0] = q0 < Q ? expf(last - v0) * d0 : 0.f;
  gv[q0 + 1] = q0 + 1 < Q ? expf(last - v1) * d1 : 0.f;
  cp_wait<0>();
  __syncthreads();

  // wB = B * g rounded to bf16, in place
  for (int e = t; e < Q * WC; e += NT) {
    const int q = e / WC, c8 = e % WC;
    uint4* wp = reinterpret_cast<uint4*>(sm + S::W_OFF + q * S::WB + c8 * 16);
    uint4 u = *wp;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&u);
    const float g = gv[q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(hp[i]);
      hp[i] = __floats2bfloat162_rn(f.x * g, f.y * g);
    }
    *wp = u;
  }
  __syncthreads();

  // s = x^T . wB: warp w owns state rows [w P/4, (w + 1) P/4)
  float acc[MT][NB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const int p0 = warp * (P / 4);
  for (int k0 = 0; k0 < Qp; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)   // x stored (k, m): the .trans A form
      ldsm_x4_t(addr_b(xs, S::XB, k0, p0 + 16 * m, lane), af[m]);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t bf[4];              // wB stored (k, n): the .trans B form
      ldsm_x4_t(addr_a(ws, S::WB, k0, 16 * n2, lane), bf);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(acc[m][2 * n2], af[m], bf[0], bf[1]);
        mma(acc[m][2 * n2 + 1], af[m], bf[2], bf[3]);
      }
    }
  }
  float* so = states + ((size_t)bc * H + h) * P * N;
  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + 16 * m + g + 8 * hf;
        *reinterpret_cast<float2*>(so + (size_t)p * N + 8 * n + 2 * qd) =
            make_float2(acc[m][n][2 * hf], acc[m][n][2 * hf + 1]);
      }
}

// (b) ---------------------------------------------------------------------
// Each thread owns 8 consecutive state elements (32 bytes of a chunk's
// slot).  Over chunk c >= 1 it writes h_prev as bf16 hi (16 bytes) then
// lo (16 bytes) in place of the s_c it has read: its own bytes only, so no
// thread overwrites what another has yet to read, and the output kernel
// copies each 16-byte half straight into its hi or lo rows.
constexpr int PASS_E = 8;           // state elements per thread

__device__ __forceinline__ uint4 pack8(const float (&v)[PASS_E]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  return u;
}

__global__ void __launch_bounds__(NT)
    ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cs,
                    float* __restrict__ state, int nc, int Q, int H, int PN) {
  const int e = (blockIdx.x * NT + threadIdx.x) * PASS_E;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  constexpr int U = 8;                // chunks loaded ahead of the chain
  float acc[PASS_E] = {};
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 s[U][2];
    float a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nc) break;
      const size_t bch = ((size_t)b * nc + c0 + u) * H + h;
      const float4* sp =
          reinterpret_cast<const float4*>(states + bch * PN + e);
      s[u][0] = sp[0];
      s[u][1] = sp[1];
      a[u] = cs[bch * Q + Q - 1];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      const size_t bch = ((size_t)b * nc + c) * H + h;
      if (c) {                        // h_prev of chunk c as bf16 hi, lo
        float hi[PASS_E], lo[PASS_E];
#pragma unroll
        for (int k = 0; k < PASS_E; ++k) {
          hi[k] = __bfloat162float(__float2bfloat16(acc[k]));
          lo[k] = acc[k] - hi[k];
        }
        uint4* hp = reinterpret_cast<uint4*>(states + bch * PN + e);
        hp[0] = pack8(hi);
        hp[1] = pack8(lo);
      }
      const float d = expf(a[u]);
      const float sv[PASS_E] = {s[u][0].x, s[u][0].y, s[u][0].z, s[u][0].w,
                                s[u][1].x, s[u][1].y, s[u][1].z, s[u][1].w};
#pragma unroll
      for (int k = 0; k < PASS_E; ++k) acc[k] = acc[k] * d + sv[k];
    }
  }
  float4* so = reinterpret_cast<float4*>(state + ((size_t)b * H + h) * PN + e);
  so[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  so[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// (c) ---------------------------------------------------------------------
// WG warpgroups of 4 warps: all of them make C.B^T together, then each
// takes every WG-th head of the group, with its own h_prev, x ring, cs and
// dt in shared memory, so WG heads are in flight.  Two where they fit in
// the 227 KB (all but P = N = 128).  Each warpgroup fetches its next
// head's h_prev, cs and dt (once this head's y_off has read h_prev) and
// first x tile (into the free ring stage) by cp.async while it works on
// this head, so a head starts with its operands in shared memory.
template <int P, int N>
struct OutSmem {
  static constexpr int WG = P * N > 8192 ? 1 : 2;
  static constexpr int CB = N * 2 + 16;          // padded row bytes: C, B, h
  static constexpr int XB = P * 2 + 16;          // ... of x
  static constexpr int C_OFF = 0;                // C_i (TQ, N)
  static constexpr int S_OFF = C_OFF + TQ * CB;  // C.B^T fragments, f32
  static constexpr int U_OFF = S_OFF + TQ * MAXQ * 4;
  // the union: the B rows (MAXQ, N) while C.B^T is made, then one slot
  // per warpgroup: h_prev as bf16 hi and lo (P, N each), the x ring (2
  // stages of (TQ, P)), cs and dt (2 buffers each: this head's and the
  // next head's)
  static constexpr int HI = 0;
  static constexpr int LO = HI + P * CB;
  static constexpr int X = LO + P * CB;
  static constexpr int CS = X + 2 * TQ * XB;
  static constexpr int DT = CS + 2 * MAXQ * 4;
  static constexpr int SLOT = DT + 2 * MAXQ * 4;
  static constexpr int U_B = MAXQ * CB;
  static constexpr int U_H = WG * SLOT;
  static constexpr int BYTES = U_OFF + (U_B > U_H ? U_B : U_H);
};

// the warpgroup's own barrier (id 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(NT) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// wait until at most n (0, 1 or 2) of the latest cp.async groups are
// still in flight
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 2) cp_wait<2>();
  else if (n == 1) cp_wait<1>();
  else cp_wait<0>();
}

// rows [j0, j0 + TQ) of head h's x into a ring stage (rows past Q zero),
// by the NT threads of one warpgroup (`tw` the thread's index in it);
// the caller commits
template <int P>
__device__ __forceinline__ void load_x_tile(uint32_t dst, const bf16* x,
                                            size_t row0, int j0, int Q, int H,
                                            int h, int tw) {
  constexpr int XC = P / 8, XB = P * 2 + 16;
  for (int e = tw; e < TQ * XC; e += NT) {
    const int r = e / XC, c8 = e % XC, q = j0 + r;
    const bool ok = q < Q;
    cp_async16(dst + r * XB + c8 * 16,
               x + ((row0 + (ok ? q : 0)) * H + h) * P + c8 * 8, ok ? 16 : 0);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(OutSmem<P, N>::WG * NT)
    ssd_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const float* __restrict__ dt,
                   const float* __restrict__ cs_in,
                   const float* __restrict__ hprev, void* __restrict__ y,
                   int nc, int Q, int H, int G, int out_bf16) {
  using S = OutSmem<P, N>;
  constexpr int WG = S::WG, NTH = WG * NT;
  constexpr int NC8 = N / 8;
  constexpr int YB = P / 8;               // n-blocks of y
  constexpr int NBW = 8 / WG;             // C.B^T n-blocks per warp
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* sm = smem_tc;
  float4* sc = reinterpret_cast<float4*>(sm + S::S_OFF);
  const int it = gridDim.z - 1 - blockIdx.z;   // longest row tiles first
  const int bc = blockIdx.x, c = bc % nc;
  const int h0 = blockIdx.y * G, h1 = min(h0 + G, H);
  const int i0 = it * TQ, ncols = (it + 1) * TQ;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rw = warp & 3, wg = warp >> 2, tw = t & (NT - 1);
  const int g = lane >> 2, qd = lane & 3;
  const size_t row0 = (size_t)bc * Q;
  const uint32_t cbase = smem_u32(sm + S::C_OFF);
  const uint32_t ubase = smem_u32(sm + S::U_OFF);
  const int r0 = rw * 16;                 // the warp's rows of the tile

  // C_i, then B rows 0..ncols (rows past Q zero)
  for (int e = t; e < (TQ + ncols) * NC8; e += NTH) {
    const int r = e / NC8, c8 = e % NC8;
    const bool isC = r < TQ;
    const int q = isC ? i0 + r : r - TQ;
    const bool ok = q < Q;
    const bf16* src = (isC ? Cm : Bm) + (row0 + (ok ? q : 0)) * N + c8 * 8;
    cp_async16((isC ? cbase + r * S::CB : ubase + (r - TQ) * S::CB) + c8 * 16,
               src, ok ? 16 : 0);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // C_i . B_j^T once for the whole head group, kept as fragments: warp
  // (rw, wg) makes rows r0.. and n-blocks [wg NBW, (wg + 1) NBW)
  for (int jt = 0; jt <= it; ++jt) {
    float acc[NBW][4];
#pragma unroll
    for (int n = 0; n < NBW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(addr_a(cbase, S::CB, r0, k0, lane), a);
#pragma unroll
      for (int n2 = 0; n2 < NBW / 2; ++n2) {
        uint32_t b[4];
        ldsm_x4(addr_b(ubase, S::CB, jt * TQ + 8 * (wg * NBW + 2 * n2), k0,
                       lane), b);
        mma(acc[2 * n2], a, b[0], b[1]);
        mma(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NBW; ++n)
      sc[((jt * 4 + rw) * 8 + wg * NBW + n) * 32 + lane] =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();                        // the B rows are not read again

  unsigned char* slot = sm + S::U_OFF + wg * S::SLOT;
  const uint32_t sbase = smem_u32(slot);
  const uint32_t hib = sbase + S::HI;
  const uint32_t lob = sbase + S::LO;
  const uint32_t xbase = sbase + S::X;
  const int nrow = min(ncols, Q);
  const int ia = i0 + r0 + g, ib = ia + 8;   // this thread's two rows
  // head h's cs and dt into buffer `buf` and (c > 0) its h_prev, which the
  // state pass left as 8-element groups of 16 bytes hi then 16 bytes lo
  auto fetch_head = [&](int h, int buf) {
    for (int q = tw; q < nrow; q += NT) {
      cp_async4(sbase + S::CS + (buf * MAXQ + q) * 4,
                cs_in + ((size_t)bc * H + h) * Q + q);
      cp_async4(sbase + S::DT + (buf * MAXQ + q) * 4,
                dt + (row0 + q) * H + h);
    }
    if (c > 0) {
      const float* hp = hprev + ((size_t)bc * H + h) * P * N;
      for (int e = tw; e < P * N / 8; e += NT) {
        const int p = e / (N / 8), n = (e % (N / 8)) * 8;
        cp_async16(hib + p * S::CB + n * 2, hp + 8 * e, 16);
        cp_async16(lob + p * S::CB + n * 2, hp + 8 * e + 4, 16);
      }
    }
  };
  int stage = 0;                          // the free ring stage
  if (h0 + wg < h1) {
    fetch_head(h0 + wg, 0);
    load_x_tile<P>(xbase, x, row0, 0, Q, H, h0 + wg, tw);
    cp_commit();
    stage = 1;
  }
  for (int h = h0 + wg, buf = 0; h < h1; h += WG, buf ^= 1) {
    const bool has_next = h + WG < h1;
    const float* csv =
        reinterpret_cast<const float*>(slot + S::CS + buf * MAXQ * 4);
    const float* dtv =
        reinterpret_cast<const float*>(slot + S::DT + buf * MAXQ * 4);
    cp_wait<0>();
    wg_sync(wg);                          // this head's operands are in

    float yacc[YB][4];
#pragma unroll
    for (int n = 0; n < YB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
    const float csa = ia < Q ? csv[ia] : 0.f, csb = ib < Q ? csv[ib] : 0.f;
    if (c > 0) {                          // y_off = exp(cs_i) C_i . h_prev
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(addr_a(cbase, S::CB, r0, k0, lane), a);
#pragma unroll
        for (int n2 = 0; n2 < YB / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4(addr_b(hib, S::CB, 16 * n2, k0, lane), b);
          mma(yacc[2 * n2], a, b[0], b[1]);
          mma(yacc[2 * n2 + 1], a, b[2], b[3]);
          ldsm_x4(addr_b(lob, S::CB, 16 * n2, k0, lane), b);
          mma(yacc[2 * n2], a, b[0], b[1]);
          mma(yacc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      const float ea = ia < Q ? expf(csa) : 0.f;
      const float eb = ib < Q ? expf(csb) : 0.f;
#pragma unroll
      for (int n = 0; n < YB; ++n) {
        yacc[n][0] *= ea;
        yacc[n][1] *= ea;
        yacc[n][2] *= eb;
        yacc[n][3] *= eb;
      }
    }
    if (has_next) {                       // h_prev is read: fetch the next
      wg_sync(wg);
      fetch_head(h + WG, buf ^ 1);
      cp_commit();
    }

    // w[i,j] = bf16((C_i.B_j) exp(cs_i - cs_j) dt_j), masked before exp
    auto wgt = [&](float s, float ci, int i, int j) -> float {
      return (j <= i && j < Q) ? s * expf(ci - csv[j]) * dtv[j] : 0.f;
    };
    for (int jt = 0; jt <= it; ++jt) {
      // this head's next tile, or the next head's first, into the free
      // stage; then wait for tile jt (tile 0 is in since the head began),
      // leaving the groups committed after it in flight
      const bool more = jt < it || has_next;
      if (more) {
        load_x_tile<P>(xbase + stage * TQ * S::XB, x, row0,
                       jt < it ? (jt + 1) * TQ : 0, Q, H,
                       jt < it ? h : h + WG, tw);
        cp_commit();
        stage ^= 1;
      }
      cp_wait_n(int(jt == 0 && has_next) + int(more));
      wg_sync(wg);
      // tile jt's stage, which the next load reuses
      const uint32_t xb = xbase + (stage ^ (more ? 0 : 1)) * TQ * S::XB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 s0 = sc[((jt * 4 + rw) * 8 + 2 * kk) * 32 + lane];
        const float4 s1 = sc[((jt * 4 + rw) * 8 + 2 * kk + 1) * 32 + lane];
        const int j0 = jt * TQ + 16 * kk + 2 * qd;
        uint32_t a[4];
        a[0] = pack_bf16(wgt(s0.x, csa, ia, j0), wgt(s0.y, csa, ia, j0 + 1));
        a[1] = pack_bf16(wgt(s0.z, csb, ib, j0), wgt(s0.w, csb, ib, j0 + 1));
        a[2] = pack_bf16(wgt(s1.x, csa, ia, j0 + 8),
                         wgt(s1.y, csa, ia, j0 + 9));
        a[3] = pack_bf16(wgt(s1.z, csb, ib, j0 + 8),
                         wgt(s1.w, csb, ib, j0 + 9));
#pragma unroll
        for (int n2 = 0; n2 < YB / 2; ++n2) {
          uint32_t b[4];                  // x_j stored (k, n): .trans B form
          ldsm_x4_t(addr_a(xb, S::XB, 16 * kk, 16 * n2, lane), b);
          mma(yacc[2 * n2], a, b[0], b[1]);
          mma(yacc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      wg_sync(wg);                        // the stage is free
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = hf ? ib : ia;
      if (i >= Q) continue;
      const size_t yr = ((row0 + i) * H + h) * P + 2 * qd;
#pragma unroll
      for (int n = 0; n < YB; ++n) {
        const float v0 = yacc[n][2 * hf], v1 = yacc[n][2 * hf + 1];
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + yr +
                                             8 * n) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(y) + yr + 8 * n) =
              make_float2(v0, v1);
      }
    }
  }
}

template <int P, int N>
int launch(const void* x, const void* Bm, const void* Cm, const float* dt,
           const float* A, void* y, float* state, float* states, float* cs,
           int B, int nc, int Q, int H, int G, int out_bf16,
           cudaStream_t st) {
  using SA = StateSmem<P, N>;
  using SC = OutSmem<P, N>;
  static bool done_a[MAX_DEVICES] = {}, done_c[MAX_DEVICES] = {};
  int e = smem_limit_once((const void*)ssd_state_kernel<P, N>, SA::BYTES,
                          done_a);
  if (e) return e;
  e = smem_limit_once((const void*)ssd_out_kernel<P, N>, SC::BYTES, done_c);
  if (e) return e;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  ssd_state_kernel<P, N><<<dim3(B * nc, H), NT, SA::BYTES, st>>>(
      xb, bb, dt, A, cs, states, Q, H);
  if ((e = (int)cudaGetLastError())) return e;
  constexpr int PN = P * N;
  ssd_pass_kernel<<<dim3((PN / PASS_E + NT - 1) / NT, H, B), NT, 0, st>>>(
      states, cs, state, nc, Q, H, PN);
  if ((e = (int)cudaGetLastError())) return e;
  const int nt = (Q + TQ - 1) / TQ;
  ssd_out_kernel<P, N><<<dim3(B * nc, (H + G - 1) / G, nt), SC::WG * NT,
                         SC::BYTES, st>>>(
      xb, bb, static_cast<const bf16*>(Cm), dt, cs, states, y, nc, Q, H, G,
      out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The scalar route.  dtype (of x, Bm, Cm) and out_dtype (of y): 0 float32,
// 1 bfloat16.  Returns the launch's cudaError_t.
extern "C" int ssd_scan(const void* x, const void* Bm, const void* Cm,
                        const void* dt, const void* A, void* y, void* state,
                        int B, int nc, int Q, int H, int P, int N, int dtype,
                        int out_dtype, void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || Q > MAXQ || H <= 0 || B > 65535 ||
      (out_dtype != 0 && out_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return scalar::dispatch_p<float>(x, Bm, Cm, dtf, Af, y, sf, B, nc, Q, H,
                                     P, N, out_dtype, st);
  if (dtype == 1)
    return scalar::dispatch_p<__nv_bfloat16>(x, Bm, Cm, dtf, Af, y, sf, B, nc,
                                             Q, H, P, N, out_dtype, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16 x, Bm, Cm (16-byte aligned), P and N 64
// or 128; y in out_dtype (0 float32, 1 bfloat16).  `states` holds B * nc *
// H * P * N floats and `cs` B * nc * H * Q (scratch, written before read);
// G heads share each block's C.B^T.  Three launches on `stream`; returns
// the first cudaError_t.
extern "C" int ssd_scan_tc(const void* x, const void* Bm, const void* Cm,
                           const void* dt, const void* A, void* y,
                           void* state, void* states, void* cs, int B, int nc,
                           int Q, int H, int P, int N, int G, int out_dtype,
                           void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || Q > MAXQ || H <= 0 || H > 65535 ||
      B > 65535 || G <= 0 || (out_dtype != 0 && out_dtype != 1) ||
      states == nullptr || cs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  float* ss = static_cast<float*>(states);
  float* cf = static_cast<float*>(cs);
#define SSD_TC(PP, NN)                                                     \
  if (P == PP && N == NN)                                                  \
    return tc::launch<PP, NN>(x, Bm, Cm, dtf, Af, y, sf, ss, cf, B, nc, Q, \
                              H, G, out_dtype, st);
  SSD_TC(64, 64)
  SSD_TC(64, 128)
  SSD_TC(128, 64)
  SSD_TC(128, 128)
#undef SSD_TC
  return (int)cudaErrorInvalidValue;
}
