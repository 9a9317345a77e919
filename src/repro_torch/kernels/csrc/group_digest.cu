// The Multi-Raft grouped digest reduction for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/group_digest/kernel.py
// (group_reduce_kernel).  Per group g and packed feature f:
//   int lanes    g_int[g, f] = sum of int_mat[b, f] over members b with
//                gids[b] == g (int32, wrapping like the JAX sum);
//   float lanes  g_sum[g, j] = the same sum of flt_mat[b, j], and
//                g_max[g, j] = the max, -inf for an empty group.
// Members whose id is outside [0, G) are dropped (ungrouped members carry
// id G).  One thread per (group, feature) owns its output cell, with no
// atomics, and adds in ascending member order, so the float sums
// accumulate in exactly the order of `segment_sum` — the JAX kernel's own
// contract — and of the plain twin, bit for bit.  Nothing is fused into a
// multiply-add (`__fadd_rn`); the max is NaN if either side is NaN and
// takes +0 over -0 at a tie of zeros, as XLA's max does.  Every cell is
// written, so the outputs need no fill before the launch.
//
// What bounds it on the H100: at the slice's fleet (B = 5 members,
// Fi = 355 packed int lanes, Ff = 3 float lanes, G = 1 group) it reads
// about 7 KB and writes about 1.5 KB, a few nanoseconds of memory time,
// so the launch and the dependent chain inside it bound it.  The TPU
// kernel ran its member blocks through a sequential grid accumulating
// into a resident output by one-hot row selects.  Here a thread loads a
// chunk of kChunk members at once — each member's id and its own
// column's value, all unconditional, so no load waits on an id compare —
// and issues the next chunk's loads before it adds the current one,
// selecting by gids[b] == g in ascending b: B <= kChunk is one round
// trip.  The float cells start on a warp of their own, so no warp runs
// both the int and the float path one after the other.  Both choices,
// and kChunk = 8 over 16, measured faster on the H100 at the fleet's
// shape: at this size a warp's instruction count weighs as much as its
// memory round trips.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;        // members loaded per round trip

// Members b0 .. b0 + kChunk - 1 of column `col`: their ids (-1, which
// matches no group, past B) and values.
template <typename T>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ gids,
                                           const T* __restrict__ mat,
                                           int b0, int B, int stride,
                                           int col, int (&gid)[kChunk],
                                           T (&val)[kChunk]) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int b = b0 + u;
    gid[u] = -1;
    val[u] = T(0);
    if (b < B) {
      gid[u] = gids[b];
      val[u] = mat[(long long)b * stride + col];
    }
  }
}

// The max of the JAX contract: NaN if either is NaN, else the larger,
// +0 over -0 when the two compare equal.
__device__ __forceinline__ float max_nan(float m, float v) {
  const float tie = __int_as_float(__float_as_int(m) & __float_as_int(v));
  const float larger = m == v ? tie : fmaxf(m, v);
  return (isnan(m) || isnan(v)) ? NAN : larger;
}

struct IntSum {
  uint32_t s = 0;                        // wraps like a JAX int32 sum
  __device__ void add(const int (&gid)[kChunk], const uint32_t (&val)[kChunk],
                      int g) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (gid[u] == g) s += val[u];
  }
};

struct FloatSumMax {
  float s = 0.0f, m = -INFINITY;
  __device__ void add(const int (&gid)[kChunk], const float (&val)[kChunk],
                      int g) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (gid[u] == g) {
        s = __fadd_rn(s, val[u]);
        m = max_nan(m, val[u]);
      }
  }
};

// Column `col` of member rows of `stride` into `acc`, in ascending member
// order, two chunk buffers in turn: each chunk's loads go out before the
// one before it is added, and past B no load or add runs.
template <typename T, typename Acc>
__device__ __forceinline__ void reduce_column(const int32_t* __restrict__ gids,
                                              const T* __restrict__ mat,
                                              int B, int stride, int col,
                                              int g, Acc& acc) {
  int gid_a[kChunk], gid_b[kChunk];
  T val_a[kChunk], val_b[kChunk];
  load_chunk(gids, mat, 0, B, stride, col, gid_a, val_a);
  for (int b0 = 0;; b0 += 2 * kChunk) {
    if (b0 + kChunk < B)
      load_chunk(gids, mat, b0 + kChunk, B, stride, col, gid_b, val_b);
    acc.add(gid_a, val_a, g);
    if (b0 + kChunk >= B) break;
    if (b0 + 2 * kChunk < B)
      load_chunk(gids, mat, b0 + 2 * kChunk, B, stride, col, gid_a, val_a);
    acc.add(gid_b, val_b, g);
    if (b0 + 2 * kChunk >= B) break;
  }
}

}  // namespace

// Thread t of group g: int cell t < Fi, float cell t - fi_pad from the
// warp boundary fi_pad >= Fi on.
__global__ void __launch_bounds__(kThreads) group_reduce_kernel(
    const int32_t* __restrict__ gids, const int32_t* __restrict__ int_mat,
    const float* __restrict__ flt_mat, int32_t* __restrict__ g_int,
    float* __restrict__ g_sum, float* __restrict__ g_max, int B, int Fi,
    int Ff, int fi_pad) {
  const int g = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < Fi) {
    IntSum acc;
    reduce_column(gids, (const uint32_t*)int_mat, B, Fi, t, g, acc);
    g_int[(long long)g * Fi + t] = (int32_t)acc.s;
  } else if (t >= fi_pad && t < fi_pad + Ff) {
    const int j = t - fi_pad;
    FloatSumMax acc;
    reduce_column(gids, flt_mat, B, Ff, j, g, acc);
    g_sum[(long long)g * Ff + j] = acc.s;
    g_max[(long long)g * Ff + j] = acc.m;
  }
}

extern "C" int group_reduce(void* gids, void* int_mat, void* flt_mat,
                            void* g_int, void* g_sum, void* g_max, int B,
                            int G, int Fi, int Ff, void* stream) {
  const int fi_pad = (Fi + 31) / 32 * 32;
  dim3 grid((fi_pad + Ff + kThreads - 1) / kThreads, G);
  group_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gids, (const int32_t*)int_mat, (const float*)flt_mat,
      (int32_t*)g_int, (float*)g_sum, (float*)g_max, B, Fi, Ff, fi_pad);
  return (int)cudaGetLastError();
}
