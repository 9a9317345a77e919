// The BW-Raft tick's three log kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/raft_tick/kernel.py:
//   log_match_append_kernel  -> lma_kernel      (follower log-match + append)
//   commit_majority_kernel   -> commit_kernel   (majority commit length)
//   apply_last_wins_kernel   -> apply_kernel    (last-wins KV apply)
//
// Every array carries a leading batch axis B (B = 1 for one cluster).
// bool arrays arrive as one byte per element.  Each C entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// What bounds them on the H100: at the paper's config (N = 87, L = 4096,
// K = 1024, W = 256, A = 8) each moves well under 1 MB, which is under a
// microsecond at 3.35 TB/s, so each is bound by its launch.  The design
// therefore touches only what changes: the append copies just the shipped
// window in place (the TPU kernel streams all N x L), the apply writes A
// entries per row in place, and the commit runs in one block.
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------
// 1. log_match_append: one block per (row, batch).  Thread 0 reads the
// follower's and the leader's terms at prev = from - 1 before any write
// (the new-length rule reads them even when prev < 0, where position 0
// may be overwritten), then the block copies the accepted window
// [from, min(upto, from + W)) from the leader's rows.  The leader rows are
// separate copies, so a block writing row `lid` races no reader.
// ---------------------------------------------------------------------
__global__ void lma_kernel(int32_t* __restrict__ term,
                           int32_t* __restrict__ key,
                           int32_t* __restrict__ val,
                           const int32_t* __restrict__ lterm,
                           const int32_t* __restrict__ lkey,
                           const int32_t* __restrict__ lval,
                           const int32_t* __restrict__ log_len,
                           const int32_t* __restrict__ from,
                           const int32_t* __restrict__ upto,
                           const uint8_t* __restrict__ due,
                           int32_t* __restrict__ new_len,
                           uint8_t* __restrict__ accept,
                           int N, int L, int W) {
  const int row = blockIdx.x;
  const int b = blockIdx.y;
  const long long r = (long long)b * N + row;
  __shared__ int s_accept;
  const int fr = from[r];
  const int hi = min(upto[r], fr + W);
  if (threadIdx.x == 0) {
    const int prev = fr - 1;
    const int prev_c = min(max(prev, 0), L - 1);
    const int my = term[r * L + prev_c];
    const int ld = lterm[(long long)b * L + prev_c];
    const bool same = my == ld;
    const bool acc = due[r] != 0 && (prev < 0 || same);
    const int ln = log_len[r];
    int nl = acc ? hi : ln;
    // a matching follower whose log already runs past the window keeps it
    if (acc && ln > nl && same) nl = ln;
    new_len[r] = nl;
    accept[r] = acc ? 1 : 0;
    s_accept = acc ? 1 : 0;
  }
  __syncthreads();
  if (!s_accept) return;
  const int lo = max(fr, 0);
  const int end = min(hi, L);
  const int32_t* lt = lterm + (long long)b * L;
  const int32_t* lk = lkey + (long long)b * L;
  const int32_t* lv = lval + (long long)b * L;
  for (int p = lo + threadIdx.x; p < end; p += blockDim.x) {
    term[r * L + p] = lt[p];
    key[r * L + p] = lk[p];
    val[r * L + p] = lv[p];
  }
}

// ---------------------------------------------------------------------
// 2. commit_majority: one block per batch.  count(vmatch >= l) is
// non-increasing in l, so count >= majority exactly for l <= kth, the
// majority-th largest voter match (non-voters count -1).  A counting pass
// finds kth without a sort (N <= 1024); a block max-reduce then takes the
// largest l <= min(kth, L) whose leader entry is in the current term.
// The result stays on the device.
// ---------------------------------------------------------------------
__global__ void commit_kernel(const int32_t* __restrict__ match,
                              const uint8_t* __restrict__ voter_alive,
                              const int32_t* __restrict__ lterm,
                              const int32_t* __restrict__ cur_term,
                              int32_t* __restrict__ out,
                              int N, int L, int majority) {
  const int b = blockIdx.x;
  __shared__ int s_v[1024];
  __shared__ int s_kth;
  __shared__ int s_best;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    s_v[i] = voter_alive[(long long)b * N + i] ? match[(long long)b * N + i]
                                                : -1;
  if (threadIdx.x == 0) {
    // majority <= 0: every length has enough votes; > N: none has
    s_kth = majority <= 0 ? L : 0;
    s_best = 0;
  }
  __syncthreads();
  if (majority >= 1 && majority <= N) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int v = s_v[i];
      int gt = 0, ge = 0;
      for (int j = 0; j < N; ++j) {
        gt += s_v[j] > v;
        ge += s_v[j] >= v;
      }
      // v is the majority-th largest; every such i writes the same v
      if (gt < majority && majority <= ge) s_kth = v;
    }
  }
  __syncthreads();
  const int lim = min(s_kth, L);
  const int cur = cur_term[b];
  const int32_t* lt = lterm + (long long)b * L;
  int best = 0;
  for (int l = threadIdx.x + 1; l <= lim; l += blockDim.x)
    if (lt[l - 1] == cur) best = l;          // ascending: last hit is max
  if (best > 0) atomicMax(&s_best, best);
  __syncthreads();
  if (threadIdx.x == 0) out[b] = s_best;
}

// ---------------------------------------------------------------------
// 3. apply_last_wins: one thread per (batch, row) walks its A committed
// entries in log order, so the last valid entry per key wins by
// construction.  Negative keys wrap once (numpy indexing), keys still
// outside [0, K) are dropped.  Updates kv in place.
// ---------------------------------------------------------------------
__global__ void apply_kernel(int32_t* __restrict__ kv,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ vals,
                             const uint8_t* __restrict__ valid,
                             int rows, int K, int A) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  for (int a = 0; a < A; ++a) {
    const long long e = r * A + a;
    if (!valid[e]) continue;
    int k = keys[e];
    if (k < 0) k += K;
    if (k >= 0 && k < K) kv[r * K + k] = vals[e];
  }
}

extern "C" {

int raft_log_match_append(void* term, void* key, void* val, void* lterm,
                          void* lkey, void* lval, void* log_len, void* from,
                          void* upto, void* due, void* new_len, void* accept,
                          int B, int N, int L, int W, void* stream) {
  dim3 grid(N, B);
  lma_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)term, (int32_t*)key, (int32_t*)val, (const int32_t*)lterm,
      (const int32_t*)lkey, (const int32_t*)lval, (const int32_t*)log_len,
      (const int32_t*)from, (const int32_t*)upto, (const uint8_t*)due,
      (int32_t*)new_len, (uint8_t*)accept, N, L, W);
  return (int)cudaGetLastError();
}

int raft_commit_majority(void* match, void* voter_alive, void* lterm,
                         void* cur_term, void* out, int B, int N, int L,
                         int majority, void* stream) {
  commit_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)match, (const uint8_t*)voter_alive,
      (const int32_t*)lterm, (const int32_t*)cur_term, (int32_t*)out, N, L,
      majority);
  return (int)cudaGetLastError();
}

int raft_apply_last_wins(void* kv, void* keys, void* vals, void* valid,
                         int B, int N, int K, int A, void* stream) {
  const int rows = B * N;
  const int threads = 128;
  apply_kernel<<<(rows + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (int32_t*)kv, (const int32_t*)keys, (const int32_t*)vals,
      (const uint8_t*)valid, rows, K, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
