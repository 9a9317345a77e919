// The budgeted AppendEntries fan-out for Hopper (sm_90a) — the leader
// bottleneck of the BW-Raft tick.
//
// Replaces the Pallas kernel src/repro/kernels/leader_fanout/kernel.py
// (leader_fanout_kernel).  One block per batch member, one thread per
// node (N <= 1024), computing in registers and shared memory:
//   * the secretary / warned handoff mask and the relay vs direct split,
//   * the payload-scaled batch cost 1 + min(pending, max_ship) / epm,
//   * the exact int32 inclusive block scan of the direct costs (the rank)
//     cut at msg_budget - n_sec,
//   * the delivery latency rtt[lid, relay] * (relay != lid) + rtt[relay, i],
//   * the five app_* rows and the leader-work delta.
// The leader's scalars (lid, has_leader, tick, log length, term, commit)
// are read from device memory, so the host never waits on the tick.
//
// What bounds it on the H100: ten (N,) rows, two rtt rows and five
// output rows, about 8 KB at N = 87 — a few nanoseconds of memory time,
// so the launch bounds it.  The TPU kernel read the whole (N, N) rtt
// matrix for one-hot gathers; here each thread loads its two rtt entries
// directly, and the block-wide any/count use __syncthreads_or/_count.
#include <cuda_runtime.h>
#include <stdint.h>

#define FOLLOWER 0
#define CANDIDATE 1
#define SECRETARY 3

__global__ void fanout_kernel(
    const int32_t* __restrict__ role, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ warn, const int32_t* __restrict__ sec_of,
    const int32_t* __restrict__ match, const int32_t* __restrict__ arrive,
    const int32_t* __restrict__ from, const int32_t* __restrict__ upto,
    const int32_t* __restrict__ term, const int32_t* __restrict__ commit,
    const int32_t* __restrict__ rtt, const int32_t* __restrict__ lid_c,
    const uint8_t* __restrict__ has_leader, const int32_t* __restrict__ tick,
    const int32_t* __restrict__ ldr_len, const int32_t* __restrict__ ldr_term,
    const int32_t* __restrict__ ldr_commit,
    int32_t* __restrict__ o_arrive, int32_t* __restrict__ o_from,
    int32_t* __restrict__ o_upto, int32_t* __restrict__ o_term,
    int32_t* __restrict__ o_commit, int32_t* __restrict__ o_work,
    int N, int msg_budget, int max_ship, int epm) {
  __shared__ int s_scan[1024];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const long long base = (long long)b * N;
  const int32_t* rt = rtt + (long long)b * N * N;
  const int lid = lid_c[b];
  const bool has = has_leader[b] != 0;
  const bool in = i < N;

  // node i qualifies as a relay iff alive, a SECRETARY and unwarned
  const bool q = in && alive[base + i] && role[base + i] == SECRETARY &&
                 warn[base + i] < 0;
  bool to_sec = false, direct = false, relayed = false;
  int relay = lid, dcost = 0;
  if (in) {
    const int sec = sec_of[base + i];
    const int secc = min(max(sec, 0), N - 1);    // clamped, as a gather is
    const bool sec_alive = sec >= 0 && alive[base + secc] &&
                           role[base + secc] == SECRETARY &&
                           warn[base + secc] < 0;
    relay = sec_alive ? secc : lid;
    to_sec = relay != lid;
    const int r = role[base + i];
    const bool target = (r == FOLLOWER || r == CANDIDATE) &&
                        alive[base + i] && i != lid;
    const bool want = has && target && arrive[base + i] < 0;
    direct = want && !to_sec;
    relayed = want && to_sec;
    const int pending = max(ldr_len[b] - match[base + i], 0);
    dcost = direct ? 1 + min(pending, max_ship) / epm : 0;
  }
  const bool any_rel = __syncthreads_or(relayed);
  const int n_q = __syncthreads_count(q);
  const int n_sec = any_rel ? n_q : 0;
  const int budget = max(msg_budget - n_sec, 0);

  // inclusive scan of the direct costs (Hillis-Steele, exact int32)
  s_scan[i] = dcost;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int add = i >= off ? s_scan[i - off] : 0;
    __syncthreads();
    s_scan[i] += add;
    __syncthreads();
  }
  const int rank = s_scan[i];
  const bool ship = relayed || (direct && rank <= budget);
  const int n_direct = __syncthreads_count(ship && direct);
  if (i == 0) o_work[b] = n_direct + n_sec;
  if (!in) return;

  const long long e = base + i;
  if (ship) {
    const int lat = rt[(long long)lid * N + relay] * (to_sec ? 1 : 0) +
                    rt[(long long)relay * N + i];
    o_arrive[e] = tick[b] + lat;
    o_from[e] = match[e];
    o_upto[e] = min(ldr_len[b], match[e] + max_ship);
    o_term[e] = ldr_term[b];
    o_commit[e] = ldr_commit[b];
  } else {
    o_arrive[e] = arrive[e];
    o_from[e] = from[e];
    o_upto[e] = upto[e];
    o_term[e] = term[e];
    o_commit[e] = commit[e];
  }
}

extern "C" int leader_fanout(
    void* role, void* alive, void* warn, void* sec_of, void* match,
    void* arrive, void* from, void* upto, void* term, void* commit, void* rtt,
    void* lid_c, void* has_leader, void* tick, void* ldr_len, void* ldr_term,
    void* ldr_commit, void* o_arrive, void* o_from, void* o_upto,
    void* o_term, void* o_commit, void* o_work, int B, int N, int msg_budget,
    int max_ship, int epm, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  fanout_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)role, (const uint8_t*)alive, (const int32_t*)warn,
      (const int32_t*)sec_of, (const int32_t*)match, (const int32_t*)arrive,
      (const int32_t*)from, (const int32_t*)upto, (const int32_t*)term,
      (const int32_t*)commit, (const int32_t*)rtt, (const int32_t*)lid_c,
      (const uint8_t*)has_leader, (const int32_t*)tick,
      (const int32_t*)ldr_len, (const int32_t*)ldr_term,
      (const int32_t*)ldr_commit, (int32_t*)o_arrive, (int32_t*)o_from,
      (int32_t*)o_upto, (int32_t*)o_term, (int32_t*)o_commit,
      (int32_t*)o_work, N, msg_budget, max_ship, epm);
  return (int)cudaGetLastError();
}
