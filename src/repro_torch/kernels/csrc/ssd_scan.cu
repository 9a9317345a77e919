// Mamba2 SSD chunked scan for sm_90a: the hand-written CUDA replacement of
// the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel (body _ssd_kernel)
// (grid (B, H, nc), the chunk axis sequential with the (P,N) state in VMEM
// scratch).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/ssd_scan/kernel.py.
//
// What it computes, per (batch b, head h), walking the chunks in order with
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
// masked inf times 0 would be NaN).
//
// Bound: at the serve shape (B=8, nc=2, Q=256, H=24, P=64, N=128, bf16 in,
// f32 y) the call must move 46.5 MB (x 12.6 MB, B and C 2.1 MB, dt 0.4 MB,
// y 25.2 MB, state 6.3 MB): 13.9 us at 3.35 TB/s.  The products it needs
// (C.B^T once per batch row and chunk over the causal pairs, w.x over the
// causal pairs and x^T.wB per head, C.h_prev per head after the first
// chunk) are 4.2 GFLOP: 4.2 us at the 989 TFLOP/s bf16 tensor rate.  So
// bytes bound it, by about three times.  This first kernel does every
// product with scalar f32 FMAs from shared memory and recomputes C.B^T for
// each head, so it runs far from either bound; wgmma tiles, one C.B^T per
// (batch, chunk) and more blocks when B*H is small (B*H = 192 blocks at
// the serve shape, 1.45 waves on 132 SMs; 24 at B=1) are later work.
//
// Design (what the TPU grid becomes):
//  * one block of 256 threads per (head, batch row); the sequential chunk
//    axis is a loop inside the block, and the (P,N) f32 state stays in
//    shared memory across it (32 KB at P=64, N=128).
//  * cs is a block scan of A*dt (one element per thread; Q <= 256).
//  * the (Q,Q) weight matrix is never held whole (256 KB in f32 at Q=256):
//    the chunk's rows are taken 64 at a time, and for each row tile the
//    64-column tiles j <= i stream through shared memory (B_j and x_j), the
//    64 x 64 weight tile being made, masked and rounded in registers and
//    staged in shared memory for the product with x_j.  C_i . h_prev is
//    taken before the row tile's first column tile.  Then the column tiles
//    stream once more for the state update, whose (P,N) sum lives in
//    registers until every row tile has read h_prev.
//  * 256 threads as 16 x 16: a thread owns rows ty + 16a of a tile and
//    columns tx + 16c, so products read one operand by broadcast and the
//    other along a padded row (stride N + 1 or 65), free of bank conflicts.
//  * shared memory: h (P, N+1), C_i and B_j (64, N+1), x_j (64, P), the
//    weight tile (64, 65), cs, dt and exp(cs_Q - cs) dt (256 each): 135 KB
//    at P=64, N=128, set as dynamic shared memory by attribute.
//  * ragged chunks (Q not a multiple of 64): tile rows past Q load as 0,
//    their weights are 0 and they are never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block, as 16 x 16
constexpr int TQ = 64;      // row / column tile of a chunk
constexpr int MAXQ = 256;   // longest chunk: one cumsum element per thread
constexpr int WS = TQ + 1;  // padded row stride of the weight tile
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

template <typename T, typename OT, int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ A, OT* __restrict__ y,
               float* __restrict__ state, int nc, int Q, int H) {
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
    OT* yc = y + row0 * xrow + (size_t)h * P;

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
        OT* yrow = yc + (size_t)gi * xrow;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          st(yrow + tx + 16 * j, yd[i][j] + yo[i][j]);
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

template <typename T, typename OT, int P, int N>
int launch(const void* x, const void* Bm, const void* Cm, const float* dt,
           const float* A, void* y, float* state, int B, int nc, int Q,
           int H, cudaStream_t st) {
  constexpr size_t smem = Smem<P, N>::BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, OT, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(H, B);
  ssd_kernel<T, OT, P, N><<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, static_cast<OT*>(y), state, nc, Q, H);
  return (int)cudaGetLastError();
}

template <typename T, typename OT>
int dispatch_pn(const void* x, const void* Bm, const void* Cm,
                const float* dt, const float* A, void* y, float* state, int B,
                int nc, int Q, int H, int P, int N, cudaStream_t st) {
  if (P == 16 && N == 16)
    return launch<T, OT, 16, 16>(x, Bm, Cm, dt, A, y, state, B, nc, Q, H, st);
  if (P == 16 && N == 128)
    return launch<T, OT, 16, 128>(x, Bm, Cm, dt, A, y, state, B, nc, Q, H, st);
  if (P == 64 && N == 16)
    return launch<T, OT, 64, 16>(x, Bm, Cm, dt, A, y, state, B, nc, Q, H, st);
  if (P == 64 && N == 128)
    return launch<T, OT, 64, 128>(x, Bm, Cm, dt, A, y, state, B, nc, Q, H, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_out(const void* x, const void* Bm, const void* Cm,
                 const float* dt, const float* A, void* y, float* state,
                 int B, int nc, int Q, int H, int P, int N, int out_dtype,
                 cudaStream_t st) {
  if (out_dtype == 0)
    return dispatch_pn<T, float>(x, Bm, Cm, dt, A, y, state, B, nc, Q, H, P,
                                 N, st);
  if (out_dtype == 1)
    return dispatch_pn<T, __nv_bfloat16>(x, Bm, Cm, dt, A, y, state, B, nc,
                                         Q, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, Bm, Cm) and out_dtype (of y): 0 float32, 1 bfloat16.
// Returns the launch's cudaError_t.
extern "C" int ssd_scan(const void* x, const void* Bm, const void* Cm,
                        const void* dt, const void* A, void* y, void* state,
                        int B, int nc, int Q, int H, int P, int N, int dtype,
                        int out_dtype, void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || Q > MAXQ || H <= 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return dispatch_out<float>(x, Bm, Cm, dtf, Af, y, sf, B, nc, Q, H, P, N,
                               out_dtype, st);
  if (dtype == 1)
    return dispatch_out<__nv_bfloat16>(x, Bm, Cm, dtf, Af, y, sf, B, nc, Q, H,
                                       P, N, out_dtype, st);
  return (int)cudaErrorInvalidValue;
}
