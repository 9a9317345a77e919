// The Multi-Raft grouped digest reduction for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/group_digest/kernel.py
// (group_reduce_kernel).  Per group g and packed feature f:
//   int lanes    g_int[g, f] = sum of int_mat[b, f] over members b with
//                gids[b] == g (int32, wrapping like the JAX sum);
//   float lanes  g_sum[g, j] = the same sum of flt_mat[b, j], and
//                g_max[g, j] = the max, -inf for an empty group.
// Members whose id is outside [0, G) are dropped (ungrouped members carry
// id G).  One thread per (group, feature) walks the members in ascending
// order with no atomics, so the float sums accumulate in exactly the
// order of `segment_sum` — the JAX kernel's own contract — and of the
// plain twin, bit for bit.  Nothing is fused into a multiply-add: the
// loop only adds and compares.
//
// What bounds it on the H100: at the slice's fleet (B = 5 members,
// Fi = 355 packed int lanes, Ff = 3 float lanes, G = 1 group) it reads
// about 7 KB and writes about 1.5 KB, a few nanoseconds of memory time,
// so the launch bounds it.  The TPU kernel ran its member blocks through
// a sequential grid accumulating into a resident output by one-hot row
// selects; here each thread owns one output cell, so there is no
// cross-block reduction to order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void group_reduce_kernel(const int32_t* __restrict__ gids,
                                    const int32_t* __restrict__ int_mat,
                                    const float* __restrict__ flt_mat,
                                    int32_t* __restrict__ g_int,
                                    float* __restrict__ g_sum,
                                    float* __restrict__ g_max,
                                    int B, int Fi, int Ff) {
  const int g = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < Fi) {
    uint32_t acc = 0;                     // wraps like a JAX int32 sum
    for (int b = 0; b < B; ++b)
      if (gids[b] == g) acc += (uint32_t)int_mat[(long long)b * Fi + f];
    g_int[(long long)g * Fi + f] = (int32_t)acc;
  } else if (f < Fi + Ff) {
    const int j = f - Fi;
    float s = 0.0f;
    float m = -INFINITY;
    for (int b = 0; b < B; ++b) {
      if (gids[b] != g) continue;
      const float v = flt_mat[(long long)b * Ff + j];
      s = __fadd_rn(s, v);
      m = (isnan(m) || isnan(v)) ? NAN : fmaxf(m, v);
    }
    g_sum[(long long)g * Ff + j] = s;
    g_max[(long long)g * Ff + j] = m;
  }
}

extern "C" int group_reduce(void* gids, void* int_mat, void* flt_mat,
                            void* g_int, void* g_sum, void* g_max, int B,
                            int G, int Fi, int Ff, void* stream) {
  const int threads = 128;
  dim3 grid((Fi + Ff + threads - 1) / threads, G);
  group_reduce_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gids, (const int32_t*)int_mat, (const float*)flt_mat,
      (int32_t*)g_int, (float*)g_sum, (float*)g_max, B, Fi, Ff);
  return (int)cudaGetLastError();
}
