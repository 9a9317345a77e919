// The budgeted AppendEntries fan-out for Hopper (sm_90a) — the leader
// bottleneck of the BW-Raft tick.
//
// Replaces the Pallas kernel src/repro/kernels/leader_fanout/kernel.py
// (leader_fanout_kernel).  One block per batch member, one thread per
// node (N <= 1024), computing in registers and warp votes:
//   * the secretary / warned handoff mask and the relay vs direct split,
//   * the payload-scaled batch cost 1 + min(pending, max_ship) / epm,
//   * the exact int32 inclusive scan of the direct costs (the rank) cut
//     at msg_budget - n_sec,
//   * the delivery latency rtt[lid, relay] * (relay != lid) + rtt[relay, i],
//   * the five app_* rows and the leader-work delta.
// The leader's scalars (lid, has_leader, tick, log length, term, commit)
// are read from device memory, so the host never waits on the tick.
//
// What bounds it on the H100: ten (N,) rows, three rtt entries and three
// gathered entries a node, six scalars and five output rows, about 7 KB
// at N = 87 — a few nanoseconds of memory time.  What it costs beyond
// the launch is its chain of dependent round trips, barriers and
// instructions, so the design keeps all three short, with one thread per
// node, so each thread's chain is short too (one warp holding three
// nodes a lane measured slower than the kernel this one replaced):
//   * Two round trips, both before the block's only barrier.  At entry
//     every thread loads its node's ten row entries and the six scalars.
//     As soon as sec_of and lid are in, it gathers its secretary's
//     (alive, role, warn) and loads every rtt entry its latency can
//     need, whichever way the relay goes: rtt[lid, secc] + rtt[secc, i]
//     if node i relays, rtt[lid, i] if not, so the rtt loads do not wait
//     for the relay to be known.
//   * The rank is an inclusive warp scan by __shfl_up_sync.  Each warp
//     writes its total, its qualified secretaries (a ballot), its count
//     of direct nodes and whether any node relayed; after the one barrier
//     a warp's offset, the direct nodes before it, n_q and the relayed
//     flag are each one __reduce_*_sync over the <= 32 warps' slots.
//     (Sharing the qualified bits through shared memory instead of
//     gathering them measured no faster and took a second barrier.)
//   * Warps run in node order and a direct cost is at least 1, so the
//     direct nodes that ship are a prefix: the warp where the prefix
//     total first passes the budget (else the last warp) adds the direct
//     nodes before it to its own shipped count and writes the leader-work
//     delta, with no second barrier.
// Lanes past N count nothing, so every N up to 1024 works.
#include <cuda_runtime.h>
#include <stdint.h>

#define FOLLOWER 0
#define CANDIDATE 1
#define SECRETARY 3

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(1024) fanout_kernel(
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
  __shared__ unsigned s_q[32];  // per warp: its qualified secretaries
  __shared__ int s_cost[32];    // per warp: the sum of its direct costs
  __shared__ int s_flag[32];    // per warp: n_direct | (any relayed) << 16
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5, n_warps = blockDim.x >> 5;
  const bool in = i < N;
  const long long base = (long long)b * N;
  const long long e = base + i;
  const int32_t* rt = rtt + base * N;

  // round trip 1: the node's row entries and the leader's scalars
  const int lid = __ldg(lid_c + b);
  const bool has = __ldg(has_leader + b) != 0;
  const int now = __ldg(tick + b);
  const int l_len = __ldg(ldr_len + b);
  const int l_term = __ldg(ldr_term + b);
  const int l_commit = __ldg(ldr_commit + b);
  int r = -1, wt = 0, sec = -1, m = 0, arr = 0, fr = 0, up = 0, tm = 0;
  int cm = 0;
  bool al = false;
  if (in) {
    r = __ldg(role + e);
    al = __ldg(alive + e) != 0;
    wt = __ldg(warn + e);
    sec = __ldg(sec_of + e);
    m = __ldg(match + e);
    arr = __ldg(arrive + e);
    fr = __ldg(from + e);
    up = __ldg(upto + e);
    tm = __ldg(term + e);
    cm = __ldg(commit + e);
  }
  // round trip 2: the secretary's state, and every rtt entry the latency
  // can need, whichever way the relay goes
  const int secc = min(max(sec, 0), N - 1);      // clamped, as a gather is
  bool s_al = false;
  int s_r = -1, s_wt = 0, rt_ls = 0, rt_si = 0, rt_li = 0;
  if (in) {
    s_al = __ldg(alive + base + secc) != 0;
    s_r = __ldg(role + base + secc);
    s_wt = __ldg(warn + base + secc);
    rt_ls = __ldg(rt + (long long)lid * N + secc);
    rt_si = __ldg(rt + (long long)secc * N + i);
    rt_li = __ldg(rt + (long long)lid * N + i);
  }
  const int cost = 1 + min(max(l_len - m, 0), max_ship) / epm;

  // node i qualifies as a relay iff alive, a SECRETARY and unwarned
  const unsigned q_mask =
      __ballot_sync(FULL, al && r == SECRETARY && wt < 0);
  const bool sec_alive =
      sec >= 0 && s_al && s_r == SECRETARY && s_wt < 0;
  const bool to_sec = (sec_alive ? secc : lid) != lid;
  const bool target = (r == FOLLOWER || r == CANDIDATE) && al && i != lid;
  const bool want = has && target && arr < 0;
  const bool direct = want && !to_sec;
  const bool relayed = want && to_sec;
  const int dcost = direct ? cost : 0;

  // the rank: an inclusive warp scan, then the warps before this one
  int rank = dcost;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int add = __shfl_up_sync(FULL, rank, off);
    if (lane >= off) rank += add;
  }
  const int w_tot = __shfl_sync(FULL, rank, 31);
  const unsigned dir_mask = __ballot_sync(FULL, direct);
  const unsigned rel_mask = __ballot_sync(FULL, relayed);
  if (lane == 0) {
    s_q[warp] = q_mask;
    s_cost[warp] = w_tot;
    s_flag[warp] = __popc(dir_mask) | (rel_mask ? 1 << 16 : 0);
  }
  __syncthreads();
  const bool slot = lane < n_warps;
  const int flag = slot ? s_flag[lane] : 0;
  const int before =
      __reduce_add_sync(FULL, lane < warp ? s_cost[lane] : 0);
  const int d_before =
      __reduce_add_sync(FULL, lane < warp ? flag & 0xffff : 0);
  const int n_q = __reduce_add_sync(FULL, slot ? __popc(s_q[lane]) : 0);
  const bool any_rel = __reduce_or_sync(FULL, (unsigned)flag >> 16) != 0;
  rank += before;
  const int n_sec = any_rel ? n_q : 0;
  const int budget = max(msg_budget - n_sec, 0);
  const bool ship = relayed || (direct && rank <= budget);

  if (in) {
    if (ship) {
      o_arrive[e] = now + (to_sec ? rt_ls + rt_si : rt_li);
      o_from[e] = m;
      o_upto[e] = min(l_len, m + max_ship);
      o_term[e] = l_term;
      o_commit[e] = l_commit;
    } else {
      o_arrive[e] = arr;
      o_from[e] = fr;
      o_upto[e] = up;
      o_term[e] = tm;
      o_commit[e] = cm;
    }
  }
  // the leader-work delta, from the warp where the shipped prefix ends
  const bool ends_here = before <= budget &&
                         (before + w_tot > budget || warp == n_warps - 1);
  if (ends_here) {                               // warp-uniform
    const unsigned cut = __ballot_sync(FULL, direct && rank <= budget);
    if (lane == 0) o_work[b] = d_before + __popc(cut) + n_sec;
  }
}

extern "C" int leader_fanout(
    void* role, void* alive, void* warn, void* sec_of, void* match,
    void* arrive, void* from, void* upto, void* term, void* commit, void* rtt,
    void* lid_c, void* has_leader, void* tick, void* ldr_len, void* ldr_term,
    void* ldr_commit, void* o_arrive, void* o_from, void* o_upto,
    void* o_term, void* o_commit, void* o_work, int B, int N, int msg_budget,
    int max_ship, int epm, void* stream) {
  const int threads = ((N + 31) / 32) * 32;      // whole warps: all vote
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
