// The BW-Raft tick's three log kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/raft_tick/kernel.py:
//   log_match_append_kernel  -> lma_kernel      (follower log-match + append)
//   commit_majority_kernel   -> commit_kernel   (majority commit length)
//   apply_last_wins_kernel   -> apply_kernel    (last-wins KV apply)
//
// Every array carries a leading batch axis B: one launch serves every
// member of a fleet (B = 1 for one cluster), as the Pallas kernels did
// under vmap.
// bool arrays arrive as one byte per element.  Each C entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// What bounds them on the H100: at the paper's config (N = 87, L = 4096,
// K = 1024, W = 256, A = 8) each moves well under 1 MB, which is under a
// microsecond at 3.35 TB/s, so each is bound by its launch and by the
// chain of dependent memory round trips inside it.  The design therefore
// touches only what changes and keeps the chains short: the append loads
// the shipped window into registers beside the prev-term check and copies
// just that window in place (the TPU kernel streams all N x L), with no
// barrier; the commit runs one block per member and fetches the leader's term row into
// registers before it counts the votes, so the row's latency hides behind
// the count; the apply gives every entry a lane, so a row's A entries load
// in one round trip and last-wins is settled among the lanes before one
// store per surviving entry.
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------
// 1. log_match_append: LMA_THREADS threads per (batch, row), no shared
// memory and no barrier.  A row that is not due makes one round trip
// (from, upto, due and log_len, the same address across the block) and
// writes new_len = log_len, accept = 0.  A due row makes one more: every
// thread loads the follower's and the leader's terms at prev = from - 1
// itself (the same address again) while it loads its LMA_PF entries of
// the leader window [from, min(upto, from + W)), strided so the loads
// coalesce, from the three leader rows into registers.  Those are
// separate copies (the op refuses views of the logs), so they can be read
// before the accept is known.  A window wider than LMA_THREADS * LMA_PF
// copies the rest after the accept.
//
// The write-after-read order needs no barrier.  The follower's term at
// prev_c lies in the window only when from <= 0 (prev_c = 0 = the
// window's start); then position 0 is thread 0's first entry, and thread
// 0 is the one that writes new_len, which reads `same`, so it reads the
// term before it stores there.  Every other thread uses its read only
// for the accept, which is `due` whatever the term when prev < 0.
//
// A row takes four warps, two entries a thread at W = 256: one warp per
// row with eight entries a lane measured slower on the H100 than the
// kernel this one replaced (each lane's 24 loads and stores run in turn).
// ---------------------------------------------------------------------
constexpr int LMA_THREADS = 128;  // threads per row
constexpr int LMA_PF = 2;         // window entries a thread holds (W = 256)

__global__ void __launch_bounds__(LMA_THREADS)
lma_kernel(int32_t* __restrict__ term, int32_t* __restrict__ key,
           int32_t* __restrict__ val, const int32_t* __restrict__ lterm,
           const int32_t* __restrict__ lkey,
           const int32_t* __restrict__ lval,
           const int32_t* __restrict__ log_len,
           const int32_t* __restrict__ from,
           const int32_t* __restrict__ upto,
           const uint8_t* __restrict__ due, int32_t* __restrict__ new_len,
           uint8_t* __restrict__ accept, int N, int L, int W) {
  const int g = threadIdx.x;
  const long long b = blockIdx.y;
  const long long r = b * N + blockIdx.x;
  const int fr = __ldg(from + r);
  const int up = __ldg(upto + r);
  const bool is_due = __ldg(due + r) != 0;
  const int ln = __ldg(log_len + r);
  bool acc = false;
  int nl = ln;
  if (is_due) {                                   // block-uniform
    const int32_t* lt = lterm + b * L;
    const int32_t* lk = lkey + b * L;
    const int32_t* lv = lval + b * L;
    int32_t* dt = term + r * L;
    const int prev = fr - 1;
    const int prev_c = min(max(prev, 0), L - 1);
    const int hi = min(up, fr + W);
    const int lo = max(fr, 0);
    const int end = min(hi, L);
    const int my = dt[prev_c];       // a plain load: this row is written
    const int ld = __ldg(lt + prev_c);
    int t[LMA_PF], k[LMA_PF], v[LMA_PF];
#pragma unroll
    for (int j = 0; j < LMA_PF; ++j) {
      const int p = lo + g + LMA_THREADS * j;
      const bool on = p < end;
      t[j] = on ? __ldg(lt + p) : 0;
      k[j] = on ? __ldg(lk + p) : 0;
      v[j] = on ? __ldg(lv + p) : 0;
    }
    const bool same = my == ld;
    acc = prev < 0 || same;
    nl = acc ? hi : ln;
    // a matching follower whose log already runs past the window keeps it
    if (acc && ln > nl && same) nl = ln;
    if (acc) {
      int32_t* dk = key + r * L;
      int32_t* dv = val + r * L;
#pragma unroll
      for (int j = 0; j < LMA_PF; ++j) {
        const int p = lo + g + LMA_THREADS * j;
        if (p < end) {
          dt[p] = t[j];
          dk[p] = k[j];
          dv[p] = v[j];
        }
      }
      for (int p = lo + LMA_THREADS * LMA_PF + g; p < end;
           p += LMA_THREADS) {
        dt[p] = __ldg(lt + p);
        dk[p] = __ldg(lk + p);
        dv[p] = __ldg(lv + p);
      }
    }
  }
  if (g == 0) {
    new_len[r] = nl;
    accept[r] = acc ? 1 : 0;
  }
}

// ---------------------------------------------------------------------
// 2. commit_majority: one block per batch member, each with its own
// majority (fleets mix cluster sizes).  count(vmatch >= l) is
// non-increasing in l, so count >= majority exactly for l <= kth, the
// majority-th largest voter match (non-voters count -1); the answer is
// the largest l <= min(kth, L) whose leader entry is in the current term
// (terms need not be monotone, so every l up to the limit is a
// candidate).
//
// The chain is what costs here, so the kernel keeps it short.  Every
// thread issues its voter's (alive, match) loads (the launcher gives
// every voter a thread), then the loads of its COMMIT_PF entries of the
// leader's term row (l - 1 = t + j * blockDim, coalesced across the
// warp) into registers: the row does not depend on kth, so it is in
// flight while the voters pass through shared memory and the count runs.
// S = 2^lg_s adjacent lanes (S * N <= blockDim, S <= 8) count the voters
// above one voter between them, four per shared-memory read, and add up
// by shuffles, so kth needs no sort (N <= 1024).  Global loads into
// registers do not stall a barrier, only their first use, which comes
// after kth is known; the launch bound leaves the registers to hold them
// (a spill would store, and so wait for, each one before the count).
// Rows longer than COMMIT_PF * blockDim read the rest after the count.
// The block max is one redux per warp and one across the warps; the
// result stays on the device.
// ---------------------------------------------------------------------
constexpr int COMMIT_PF = 16;

__device__ __forceinline__ void count_ge(int w, int v, int& gt, int& ge) {
  gt += w > v;
  ge += w >= v;
}

template <int MAX_T>
__global__ void __launch_bounds__(MAX_T)
commit_kernel(const int32_t* __restrict__ match,
              const uint8_t* __restrict__ voter_alive,
              const int32_t* __restrict__ lterm,
              const int32_t* __restrict__ cur_term,
              const int32_t* __restrict__ majority_b,
              int32_t* __restrict__ out, int N, int L, int lg_s) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int32_t* lt = lterm + (long long)b * L;
  const long long r0 = (long long)b * N;
  int mine = -1;
  if (t < N) {                       // both loads issued, then the select
    const int m = __ldg(match + r0 + t);
    mine = __ldg(voter_alive + r0 + t) ? m : -1;
  }
  const int cur = __ldg(cur_term + b);
  const int majority = __ldg(majority_b + b);
  int term[COMMIT_PF];
#pragma unroll
  for (int j = 0; j < COMMIT_PF; ++j) {
    const int p = t + j * T;
    term[j] = p < L ? __ldg(lt + p) : 0;
  }
  __shared__ __align__(16) int s_v[1024];
  __shared__ int s_kth;
  __shared__ int s_best[32];
  if (t < N) s_v[t] = mine;
  // majority <= 0: every length has enough votes; > N: none has
  const bool counted = majority >= 1 && majority <= N;
  if (t == 0 && !counted) s_kth = majority <= 0 ? L : 0;
  __syncthreads();
  if (counted) {                     // block-uniform: every lane shuffles
    const int S = 1 << lg_s;
    const int i = t >> lg_s, part = t & (S - 1);
    const int v = i < N ? s_v[i] : 0;
    int gt = 0, ge = 0;
    if (i < N) {
      const int4* s4 = reinterpret_cast<const int4*>(s_v);
#pragma unroll 4
      for (int q = part; q < (N >> 2); q += S) {
        const int4 w = s4[q];
        count_ge(w.x, v, gt, ge);
        count_ge(w.y, v, gt, ge);
        count_ge(w.z, v, gt, ge);
        count_ge(w.w, v, gt, ge);
      }
      for (int j = (N & ~3) + part; j < N; j += S)
        count_ge(s_v[j], v, gt, ge);
    }
    for (int o = 1; o < S; o <<= 1) {
      gt += __shfl_xor_sync(0xffffffffu, gt, o);
      ge += __shfl_xor_sync(0xffffffffu, ge, o);
    }
    // v is the majority-th largest; every such voter writes the same v
    if (i < N && part == 0 && gt < majority && majority <= ge) s_kth = v;
  }
  __syncthreads();
  const int lim = min(s_kth, L);
  int best = 0;
#pragma unroll
  for (int j = 0; j < COMMIT_PF; ++j) {       // ascending: last hit is max
    const int l = t + j * T + 1;
    if (l <= lim && term[j] == cur) best = l;
  }
  for (int l = COMMIT_PF * T + t + 1; l <= lim; l += T)
    if (__ldg(lt + l - 1) == cur) best = l;
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) s_best[t >> 5] = best;
  __syncthreads();
  if (t < 32) {
    best = t < (T >> 5) ? s_best[t] : 0;
    best = __reduce_max_sync(0xffffffffu, best);
    if (t == 0) out[b] = best;
  }
}

// ---------------------------------------------------------------------
// 3. apply_last_wins: one lane per entry (b, i, a).  A row's A entries
// take A' = A rounded up to a power of two lanes (32 / A' rows to a
// warp), so every lane loads its (valid, key, val) at once, coalesced,
// and the row is settled in one round trip.  Negative keys wrap once
// (numpy indexing), keys still outside [0, K) are dropped.  The lanes of
// one row that write the same cell find each other with
// __match_any_sync on (row in warp, key), and only the highest, the
// last entry in log order, stores: the last valid entry per key wins
// with one store per surviving entry.  Lanes that do not write carry a
// tag of their own, so the whole warp takes part in every match.  Rows
// with A > 32 take a warp each and walk their entries in chunks of 32
// in ascending order, a __syncwarp between chunks ordering a later
// chunk's store after an earlier one's.  Updates kv in place.
// ---------------------------------------------------------------------
__device__ __forceinline__ void store_last(int32_t* __restrict__ kv,
                                           long long row, int K, bool ok,
                                           int k, int v, int sub, int lane) {
  const unsigned long long tag =
      ok ? ((unsigned long long)sub << 32) | (unsigned)k
         : (1ull << 63) | (unsigned)lane;
  const unsigned peers = __match_any_sync(0xffffffffu, tag);
  if (ok && 31 - __clz(peers) == lane) kv[row * K + k] = v;
}

__device__ __forceinline__ bool load_entry(const int32_t* __restrict__ keys,
                                           const int32_t* __restrict__ vals,
                                           const uint8_t* __restrict__ valid,
                                           long long e, int K, int& k,
                                           int& v) {
  const bool on = valid[e] != 0;
  k = keys[e];
  v = vals[e];
  if (k < 0) k += K;
  return on && k >= 0 && k < K;
}

__global__ void apply_kernel(int32_t* __restrict__ kv,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ vals,
                             const uint8_t* __restrict__ valid,
                             int rows, int K, int A, int lg_lanes) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int k = 0, v = 0;
  if (A <= 32) {
    const int sub = lane >> lg_lanes;             // row within the warp
    const int a = lane & ((1 << lg_lanes) - 1);
    const long long row0 = warp << (5 - lg_lanes);
    if (row0 >= rows) return;                     // the whole warp
    const long long row = row0 + sub;
    const bool ok = row < rows && a < A &&
                    load_entry(keys, vals, valid, row * A + a, K, k, v);
    store_last(kv, row, K, ok, k, v, sub, lane);
    return;
  }
  if (warp >= rows) return;                       // the whole warp
  for (int a0 = 0; a0 < A; a0 += 32) {
    const int a = a0 + lane;
    const bool ok = a < A &&
                    load_entry(keys, vals, valid, warp * A + a, K, k, v);
    store_last(kv, warp, K, ok, k, v, 0, lane);
    __syncwarp();
  }
}

extern "C" {

int raft_log_match_append(void* term, void* key, void* val, void* lterm,
                          void* lkey, void* lval, void* log_len, void* from,
                          void* upto, void* due, void* new_len, void* accept,
                          int B, int N, int L, int W, void* stream) {
  dim3 grid(N, B);                                // a block per row
  lma_kernel<<<grid, LMA_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)term, (int32_t*)key, (int32_t*)val, (const int32_t*)lterm,
      (const int32_t*)lkey, (const int32_t*)lval, (const int32_t*)log_len,
      (const int32_t*)from, (const int32_t*)upto, (const uint8_t*)due,
      (int32_t*)new_len, (uint8_t*)accept, N, L, W);
  return (int)cudaGetLastError();
}

int raft_commit_majority(void* match, void* voter_alive, void* lterm,
                         void* cur_term, void* majority, void* out, int B,
                         int N, int L, void* stream) {
  // a thread for every voter (N <= 1024, checked by the op) and enough
  // threads to prefetch the term row COMMIT_PF entries each
  const int want = max(max(N, (L + COMMIT_PF - 1) / COMMIT_PF), 32);
  const int threads = min((want + 31) / 32 * 32, 1024);
  // the paper's config takes 256 threads; that bound leaves the
  // prefetched row its registers
  int lg_s = 0;                         // 2^lg_s counting lanes a voter
  while (lg_s < 3 && (N << (lg_s + 1)) <= threads) ++lg_s;
  auto kernel = threads <= 256 ? commit_kernel<256> : commit_kernel<1024>;
  kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)match, (const uint8_t*)voter_alive,
      (const int32_t*)lterm, (const int32_t*)cur_term,
      (const int32_t*)majority, (int32_t*)out, N, L, lg_s);
  return (int)cudaGetLastError();
}

int raft_apply_last_wins(void* kv, void* keys, void* vals, void* valid,
                         int B, int N, int K, int A, void* stream) {
  const int rows = B * N;
  int lg = 0;                                     // A' = 2^lg lanes a row
  while (lg < 5 && (1 << lg) < A) ++lg;
  const long long warps = A <= 32 ? (rows + (32 >> lg) - 1) >> (5 - lg)
                                  : rows;
  const int threads = 128;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  apply_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)kv, (const int32_t*)keys, (const int32_t*)vals,
      (const uint8_t*)valid, rows, K, A, lg);
  return (int)cudaGetLastError();
}

}  // extern "C"
