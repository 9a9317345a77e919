// The digest-tier anti-entropy round for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ae_sync/kernel.py
// (ae_sync_kernel).  One thread per observer slot, one grid row
// (blockIdx.y) per fleet member.  Per slot o of member b:
//   * the source: the wired voter dobs_fol[o] (clipped to the real N) if
//     it is an alive voter, else the FIRST alive voter of the member;
//   * the due rule: the slot is alive, some source exists, and
//     (tick + ae_phase[o]) mod max(ae_interval, 1) == 0 (floor mod);
//   * monotone adoption of the source's (applied_len, term, digest):
//     only when the source's applied index is >= the slot's own;
//   * sync-hop aging: synced = tick - site_rtt[dobs_site[o], site[src]]
//     on every due round.
// The uint32 digests travel as int32 bits and are only copied.  Padded
// slots arrive with dobs_alive == 0, so they are never due and pass
// through.  The outputs are new rows; the inputs are not written.
//
// What bounds it on the H100: per member 8 observer rows (O = 550 at the
// 50X rack) and 6 node rows (N = 87) in, 4 rows out, a 4 x 4 site-pair
// matrix — about 28 KB per member, some 10 ns of memory time, so the
// launch bounds it.  The TPU kernel gathered node values with one-hot
// masked sums over (N, O) and transposed rows by diagonal picks, since
// its vector unit has no per-lane gather; here each thread loads its
// source's values with plain indexed loads, and the first alive voter is
// one shared-memory atomicMin per block.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void ae_sync_kernel(
    const uint8_t* __restrict__ dobs_alive, const int32_t* __restrict__ fol,
    const int32_t* __restrict__ d_applied, const int32_t* __restrict__ d_term,
    const int32_t* __restrict__ d_digest, const int32_t* __restrict__ d_synced,
    const int32_t* __restrict__ phase, const int32_t* __restrict__ d_site,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ voter,
    const int32_t* __restrict__ applied, const int32_t* __restrict__ term,
    const int32_t* __restrict__ digest, const int32_t* __restrict__ site,
    const int32_t* __restrict__ site_rtt, const int32_t* __restrict__ tick_b,
    const int32_t* __restrict__ interval_b,
    int32_t* __restrict__ o_applied, int32_t* __restrict__ o_term,
    int32_t* __restrict__ o_digest, int32_t* __restrict__ o_synced,
    int O, int N, int S) {
  const int b = blockIdx.y;
  const long long nb = (long long)b * N;
  __shared__ int s_first;
  if (threadIdx.x == 0) s_first = N;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (alive[nb + i] && voter[nb + i]) atomicMin(&s_first, i);
  __syncthreads();
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const bool any_voter = s_first < N;
  const int fallback = any_voter ? s_first : 0;

  const long long e = (long long)b * O + o;
  const int f = fol[e];
  const int fc = min(max(f, 0), N - 1);
  const bool fol_ok = f >= 0 && alive[nb + fc] && voter[nb + fc];
  const int src = fol_ok ? fc : fallback;
  const int interval = max(interval_b[b], 1);
  const int tick = tick_b[b];
  int r = (tick + phase[e]) % interval;
  if (r < 0) r += interval;                       // floor mod, as jnp.mod
  const bool due = dobs_alive[e] && (fol_ok || any_voter) && r == 0;

  const int src_applied = applied[nb + src];
  const int mine = d_applied[e];
  const bool adopt = due && src_applied >= mine;
  o_applied[e] = adopt ? src_applied : mine;
  o_term[e] = adopt ? term[nb + src] : d_term[e];
  o_digest[e] = adopt ? digest[nb + src] : d_digest[e];
  if (due) {
    const int hop = site_rtt[((long long)b * S + d_site[e]) * S +
                             site[nb + src]];
    o_synced[e] = tick - hop;
  } else {
    o_synced[e] = d_synced[e];
  }
}

extern "C" int ae_sync(void* dobs_alive, void* fol, void* d_applied,
                       void* d_term, void* d_digest, void* d_synced,
                       void* phase, void* d_site, void* alive, void* voter,
                       void* applied, void* term, void* digest, void* site,
                       void* site_rtt, void* tick, void* interval,
                       void* o_applied, void* o_term, void* o_digest,
                       void* o_synced, int B, int O, int N, int S,
                       void* stream) {
  const int threads = 128;
  dim3 grid((O + threads - 1) / threads, B);
  ae_sync_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dobs_alive, (const int32_t*)fol,
      (const int32_t*)d_applied, (const int32_t*)d_term,
      (const int32_t*)d_digest, (const int32_t*)d_synced,
      (const int32_t*)phase, (const int32_t*)d_site, (const uint8_t*)alive,
      (const uint8_t*)voter, (const int32_t*)applied, (const int32_t*)term,
      (const int32_t*)digest, (const int32_t*)site, (const int32_t*)site_rtt,
      (const int32_t*)tick, (const int32_t*)interval, (int32_t*)o_applied,
      (int32_t*)o_term, (int32_t*)o_digest, (int32_t*)o_synced, O, N, S);
  return (int)cudaGetLastError();
}
