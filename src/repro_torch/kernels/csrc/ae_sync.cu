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
// launch and the dependent chain inside it bound it: a memory round trip,
// the cross-lane steps that find the source, a gather at the source, the
// stores.  The TPU kernel gathered node values with one-hot masked sums
// over (N, O) and transposed rows by diagonal picks, since its vector
// unit has no per-lane gather.  Here there is no block barrier, no shared
// memory and no atomic, and a slot makes at most two round trips, one if
// it is not due:
//   1. every thread issues its independent loads at once: its slot's
//      eight values, the member's tick and interval, the member's alive
//      and voter bytes of nodes lane, lane + 32, ... (kWords a round
//      trip) and, while S*S <= 32, one site_rtt entry a lane.  Bit j of a
//      lane's mask marks node 32 j + lane an alive voter, so one
//      __reduce_min_sync over the lanes' lowest marked nodes names the
//      member's first alive voter (jnp.argmax of the mask; N, read as
//      "none", when no voter is alive), and one __shfl_sync of lane
//      fc & 31's mask gives the wired voter's liveness, bit fc >> 5,
//      without a load.  The due rule follows.
//   2. a due lane alone gathers applied, term, digest and site at its
//      source.  The hop is a __shfl_sync of the preloaded site_rtt at
//      dobs_site * S + site[src].
// Every lane of a warp, those past O included, reaches each collective;
// a shuffle's result is taken before any && that could skip it, and only
// the stores wait on o < O.  The instructions a warp runs count as much
// as its memory round trips at this size (measured on the H100), so the
// fleet's shape (N <= 128, S*S <= 32) has its own instance with one
// round trip of node bytes and no fallback code; the general one loops
// over the node words (N <= 1024), scans N > 1024 by a warp
// min-reduction and loads the hop when S*S > 32: the JAX kernel takes
// any N and S, and so does this one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWords = 4;                // node words a lane loads a trip
constexpr int kSmallN = 32 * kWords;     // N of the one-trip instance

// The first alive voter of one member's node rows for N > 1024 (N when
// none), by the whole warp.
__device__ int first_alive_voter_wide(const uint8_t* __restrict__ alive,
                                      const uint8_t* __restrict__ voter,
                                      int N, int lane) {
  int first = N;
  for (int i = lane; i < N; i += 32)
    if (alive[i] & voter[i]) {
      first = i;
      break;
    }
  return __reduce_min_sync(kFull, first);
}

}  // namespace

// kSmall: N <= kSmallN and S * S <= 32, as the launcher checks.
template <bool kSmall>
__global__ void __launch_bounds__(kThreads) ae_sync_kernel(
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
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = o < O;
  const long long nb = (long long)b * N;
  const long long e = (long long)b * O + o;
  const bool rtt_in_lanes = kSmall || S * S <= 32;

  // round trip 1: everything no other load names
  const int tick = tick_b[b];
  const int interval = max(interval_b[b], 1);
  uint8_t d_alive = 0;
  int f = 0, mine = 0, m_term = 0, m_digest = 0, m_synced = 0, ph = 0;
  int ds = 0;
  if (live) {
    d_alive = dobs_alive[e];
    f = fol[e];
    mine = d_applied[e];
    m_term = d_term[e];
    m_digest = d_digest[e];
    m_synced = d_synced[e];
    ph = phase[e];
    ds = d_site[e];
  }
  int rtt = 0;
  if (rtt_in_lanes && lane < S * S)
    rtt = site_rtt[(long long)b * S * S + lane];
  const int fc = min(max(f, 0), N - 1);

  int first;
  bool fol_ok;
  if (kSmall || N <= 1024) {
    uint32_t mask = 0;                   // bit j: node 32 j + lane
    const int n_words = kSmall ? kWords : (N + 31) >> 5;
    for (int w0 = 0; w0 < n_words; w0 += kWords) {
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int i = (w0 + u) * 32 + lane;
        uint8_t a = 0, v = 0;
        if (i < N) {
          a = alive[nb + i];
          v = voter[nb + i];
        }
        mask |= (uint32_t)(a & v) << (w0 + u);
      }
    }
    first = __reduce_min_sync(kFull,
                              mask ? (__ffs(mask) - 1) * 32 + lane : N);
    const uint32_t fol_mask = __shfl_sync(kFull, mask, fc & 31);
    fol_ok = f >= 0 && ((fol_mask >> (fc >> 5)) & 1u);
  } else {
    first = first_alive_voter_wide(alive + nb, voter + nb, N, lane);
    fol_ok = f >= 0 && (alive[nb + fc] & voter[nb + fc]);
  }
  const bool any_voter = first < N;
  const int src = fol_ok ? fc : (any_voter ? first : 0);
  int r = (int)((unsigned)tick + (unsigned)ph) % interval;
  if (r < 0) r += interval;                       // floor mod, as jnp.mod
  const bool due = d_alive && (fol_ok || any_voter) && r == 0;

  // round trip 2: a due lane's source values
  int s_applied = 0, s_term = 0, s_digest = 0, s_site = 0;
  if (due) {
    s_applied = applied[nb + src];
    s_term = term[nb + src];
    s_digest = digest[nb + src];
    s_site = site[nb + src];
  }
  int hop;
  if (rtt_in_lanes)
    hop = __shfl_sync(kFull, rtt, ds * S + s_site);
  else
    hop = due ? site_rtt[((long long)b * S + ds) * S + s_site] : 0;

  if (!live) return;
  const bool adopt = due && s_applied >= mine;
  o_applied[e] = adopt ? s_applied : mine;
  o_term[e] = adopt ? s_term : m_term;
  o_digest[e] = adopt ? s_digest : m_digest;
  o_synced[e] = due ? (int)((unsigned)tick - (unsigned)hop) : m_synced;
}

extern "C" int ae_sync(void* dobs_alive, void* fol, void* d_applied,
                       void* d_term, void* d_digest, void* d_synced,
                       void* phase, void* d_site, void* alive, void* voter,
                       void* applied, void* term, void* digest, void* site,
                       void* site_rtt, void* tick, void* interval,
                       void* o_applied, void* o_term, void* o_digest,
                       void* o_synced, int B, int O, int N, int S,
                       void* stream) {
  dim3 grid((O + kThreads - 1) / kThreads, B);
  auto kernel = N <= kSmallN && S * S <= 32 ? ae_sync_kernel<true>
                                            : ae_sync_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
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
