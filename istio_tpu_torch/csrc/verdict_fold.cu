// verdict_fold — the policy verdict of every request from its rule-match
// planes: namespace mask, deny fold, STRINGS list scan, quota rank /
// grant / commit, referenced attributes and the batch error count.
//
// Replaces the JAX package's istio_tpu/models/policy_engine.py:379-654,
// PolicyEngine.__init__.<locals>.step, for the deny, STRINGS-list and
// quota banks (REGEX / CIDR lists and RBAC are not ported yet). Three
// launches, one chain on the caller's stream:
//
//   1. row_fold      one block per request row b. Threads stride over the
//      R rules: active = matched & (rule_ns == default | rule_ns ==
//      req_ns); the deny fold keeps the LOWEST active deny rule (its
//      status) and the min TTL / use count over all active deny rules;
//      err & ns_ok (& the err-rule mask) is counted. Threads then stride
//      over the lists (membership = any entry id == the slot's id; an
//      absent value on an active list rule is INTERNAL); the winner is
//      the lowest (rule, list) pair and beats the deny only with a
//      strictly lower rule index. A block reduction combines them, the
//      row's status / TTLs / deny_rule are written, every active quota
//      writes its composite key q·NB + (hash mod nb, floor modulo) to
//      ckey[q, b] (-1 if inactive), the referenced row is copied from
//      the per-namespace table, and the block's error count is added to
//      the batch scalar with one int32 atomicAdd.
//   2. quota_rank    one thread per (b, q): rank = #{j < b : ckey[j, q] ==
//      ckey[b, q]} over shared-memory tiles of the key column — the
//      definition both of the reference's tiers compute (pairwise for
//      B ≤ 256, batch_rank's stable sort above) — then grant iff
//      counts[key] + rank < max. Every read of the counters happens in
//      this launch, before any commit.
//   3. quota_commit  one thread per row: int32 atomicAdd of each grant
//      into quota_counts [Q, NB] (in place), and RESOURCE_EXHAUSTED with
//      deny_rule = the lowest over-limit quota rule where any was over.
//
// What bounds it on an H100: memory. The fold reads the matched and err
// planes once (2·B·R bytes, 41 MB at B=2048, R=10,000) plus the R-long
// rule tables, and does a handful of compares per byte read; the quota
// rank is O(B²·Q) compares but from shared memory, on a few columns.
// The design reads each plane row by one block with consecutive threads
// on consecutive rules (coalesced), keeps the per-rule tables in L1/L2,
// and never materialises the [B, R] active plane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;
constexpr int32_t kIntMax = 2147483647;
constexpr float kBig = 3.4e38f;
constexpr int32_t kOK = 0, kInternal = 13, kResourceExhausted = 8;
constexpr float kDefaultDur = 5.0f;
constexpr int32_t kDefaultUses = 10000;

__device__ __forceinline__ int32_t floor_mod(int32_t k, int32_t m) {
  int32_t r = k % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__global__ void row_fold_kernel(
    const uint8_t* __restrict__ matched, const uint8_t* __restrict__ err,
    const int32_t* __restrict__ req_ns, int B, int R,
    const int32_t* __restrict__ rule_ns, int default_ns,
    const uint8_t* __restrict__ deny_mask,
    const int32_t* __restrict__ deny_status,
    const float* __restrict__ deny_dur, const int32_t* __restrict__ deny_uses,
    const uint8_t* __restrict__ err_rule_mask, int NL, int E,
    const int32_t* __restrict__ list_ids,
    const int32_t* __restrict__ list_rule,
    const int32_t* __restrict__ list_slot,
    const uint8_t* __restrict__ list_black,
    const int32_t* __restrict__ list_code,
    const float* __restrict__ list_dur, const int32_t* __restrict__ list_uses,
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ present,
    const int32_t* __restrict__ hash_ids, int C, int Q, int NB,
    const int32_t* __restrict__ q_rule, const int32_t* __restrict__ q_slot,
    const int32_t* __restrict__ q_nb, const uint8_t* __restrict__ table,
    int T_rows, int T_cols, int n_attr, int32_t* __restrict__ status,
    float* __restrict__ dur, int32_t* __restrict__ uses,
    int32_t* __restrict__ deny_rule, uint8_t* __restrict__ referenced,
    int32_t* __restrict__ err_count, int32_t* __restrict__ ckey) {
  __shared__ int32_t s_rule[kThreads];
  __shared__ float s_dur[kThreads];
  __shared__ int32_t s_uses[kThreads];
  __shared__ int32_t s_errs[kThreads];
  __shared__ unsigned long long s_lkey[kThreads];
  __shared__ float s_ldur[kThreads];
  __shared__ int32_t s_luses[kThreads];
  __shared__ int32_t s_lint[kThreads];
  __shared__ int32_t s_status;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t rns = req_ns[b];
  const uint8_t* m_row = matched + (long long)b * R;
  const uint8_t* e_row = err + (long long)b * R;
  const int32_t* id_row = ids + (long long)b * C;
  const uint8_t* pr_row = present + (long long)b * C;

  int32_t best = kIntMax, best_uses = kIntMax, errs = 0;
  float best_dur = kBig;
  for (int r = tid; r < R; r += blockDim.x) {
    const int32_t ns = rule_ns[r];
    const bool ns_ok = ns == default_ns || ns == rns;
    if (!ns_ok) continue;
    if (e_row[r] && (err_rule_mask == nullptr || err_rule_mask[r])) ++errs;
    if (m_row[r] && deny_mask[r]) {
      best = min(best, r);
      best_dur = fminf(best_dur, deny_dur[r]);
      best_uses = min(best_uses, deny_uses[r]);
    }
  }
  unsigned long long lkey = ~0ull;  // (rule << 32 | list), lowest wins
  float ldur = kBig;
  int32_t luses = kIntMax, lint = 0;
  for (int l = tid; l < NL; l += blockDim.x) {
    const int32_t rule = list_rule[l];
    const int32_t ns = rule_ns[rule];
    if (!(m_row[rule] && (ns == default_ns || ns == rns))) continue;
    const int slot = list_slot[l];
    bool hit;
    if (!pr_row[slot]) {
      hit = true;  // absent value on an active list rule → INTERNAL
      lint = 1;
    } else {
      const int32_t sym = id_row[slot];
      bool member = false;
      for (int e = 0; e < E && !member; ++e)
        member = list_ids[(long long)l * E + e] == sym;
      hit = member == (list_black[l] != 0);
      ldur = fminf(ldur, list_dur[l]);
      luses = min(luses, list_uses[l]);
    }
    if (hit) {
      const unsigned long long k =
          ((unsigned long long)(uint32_t)rule << 32) | (uint32_t)l;
      lkey = k < lkey ? k : lkey;
    }
  }
  s_rule[tid] = best;
  s_dur[tid] = best_dur;
  s_uses[tid] = best_uses;
  s_errs[tid] = errs;
  s_lkey[tid] = lkey;
  s_ldur[tid] = ldur;
  s_luses[tid] = luses;
  s_lint[tid] = lint;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      s_rule[tid] = min(s_rule[tid], s_rule[tid + s]);
      s_dur[tid] = fminf(s_dur[tid], s_dur[tid + s]);
      s_uses[tid] = min(s_uses[tid], s_uses[tid + s]);
      s_errs[tid] += s_errs[tid + s];
      s_lkey[tid] = s_lkey[tid] < s_lkey[tid + s] ? s_lkey[tid]
                                                   : s_lkey[tid + s];
      s_ldur[tid] = fminf(s_ldur[tid], s_ldur[tid + s]);
      s_luses[tid] = min(s_luses[tid], s_luses[tid + s]);
      s_lint[tid] |= s_lint[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    int32_t cand_rule = s_rule[0];
    int32_t cand_status = cand_rule < kIntMax ? deny_status[cand_rule] : kOK;
    float d = s_dur[0];
    int32_t u = s_uses[0];
    if (NL > 0) {
      if (s_lkey[0] != ~0ull) {
        const int32_t l_rule = (int32_t)(s_lkey[0] >> 32);
        const int l_arg = (int)(s_lkey[0] & 0xffffffffull);
        if (l_rule < cand_rule) {  // strict: deny wins ties
          cand_status = pr_row[list_slot[l_arg]] ? list_code[l_arg]
                                                 : kInternal;
          cand_rule = l_rule;
        }
      }
      d = fminf(d, s_ldur[0]);
      u = min(u, s_luses[0]);
      if (s_lint[0]) {  // INTERNAL carries the CheckResult defaults
        d = fminf(d, kDefaultDur);
        u = min(u, kDefaultUses);
      }
    }
    const int32_t st = cand_rule < kIntMax ? cand_status : kOK;
    status[b] = st;
    dur[b] = d;
    uses[b] = u;
    deny_rule[b] = st == kOK ? kIntMax : cand_rule;
    s_status = st;
    if (s_errs[0]) atomicAdd(err_count, s_errs[0]);
  }
  __syncthreads();
  for (int q = tid; q < Q; q += blockDim.x) {
    const int32_t rule = q_rule[q];
    const int32_t ns = rule_ns[rule];
    const int slot = q_slot[q];
    const bool act = s_status == kOK && m_row[rule] &&
                     (ns == default_ns || ns == rns) && pr_row[slot];
    ckey[(long long)q * B + b] =
        act ? q * NB + floor_mod(hash_ids[(long long)b * C + slot], q_nb[q])
            : -1;
  }
  const int t_row = (rns >= 0 && rns < T_rows - 1) ? rns + 1 : 0;
  for (int c = tid; c < n_attr; c += blockDim.x)
    referenced[(long long)b * n_attr + c] = table[(long long)t_row * T_cols + c];
}

__global__ void quota_rank_kernel(const int32_t* __restrict__ ckey, int B,
                                  const int32_t* __restrict__ q_max,
                                  const int32_t* __restrict__ counts,
                                  uint8_t* __restrict__ qstate) {
  __shared__ int32_t tile[kTile];
  const int q = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* col = ckey + (long long)q * B;
  const int32_t mine = b < B ? col[b] : -1;
  const int b_end = min(B, (int)((blockIdx.x + 1) * blockDim.x));
  int32_t rank = 0;
  for (int base = 0; base < b_end; base += kTile) {
    const int n = min(kTile, b_end - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = col[base + i];
    __syncthreads();
    if (mine >= 0) {
      const int lim = min(n, b - base);
      for (int i = 0; i < lim; ++i) rank += tile[i] == mine;
    }
    __syncthreads();
  }
  if (b < B) {
    uint8_t st = 0;  // 0 inactive, 1 granted, 2 over the limit
    if (mine >= 0) st = (counts[mine] + rank < q_max[q]) ? 1 : 2;
    qstate[(long long)q * B + b] = st;
  }
}

__global__ void quota_commit_kernel(const int32_t* __restrict__ ckey,
                                    const uint8_t* __restrict__ qstate, int B,
                                    int Q, const int32_t* __restrict__ q_rule,
                                    int32_t* __restrict__ counts,
                                    int32_t* __restrict__ status,
                                    int32_t* __restrict__ deny_rule) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t over_rule = kIntMax;
  bool any_over = false;
  for (int q = 0; q < Q; ++q) {
    const long long o = (long long)q * B + b;
    const uint8_t st = qstate[o];
    if (st == 1) {
      atomicAdd(counts + ckey[o], 1);
    } else if (st == 2) {
      any_over = true;
      over_rule = min(over_rule, q_rule[q]);
    }
  }
  if (any_over) {  // quota ran only where status was OK
    status[b] = kResourceExhausted;
    deny_rule[b] = over_rule;
  }
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int verdict_fold(
    const uint8_t* matched, const uint8_t* err, const int32_t* req_ns, int B,
    int R, const int32_t* rule_ns, int default_ns, const uint8_t* deny_mask,
    const int32_t* deny_status, const float* deny_dur,
    const int32_t* deny_uses, const uint8_t* err_rule_mask, int NL, int E,
    const int32_t* list_ids, const int32_t* list_rule,
    const int32_t* list_slot, const uint8_t* list_black,
    const int32_t* list_code, const float* list_dur,
    const int32_t* list_uses, const int32_t* ids, const uint8_t* present,
    const int32_t* hash_ids, int C, int Q, int NB, const int32_t* q_rule,
    const int32_t* q_slot, const int32_t* q_max, const int32_t* q_nb,
    int32_t* quota_counts, const uint8_t* table, int T_rows, int T_cols,
    int n_attr, int32_t* status, float* dur, int32_t* uses,
    int32_t* deny_rule, uint8_t* referenced, int32_t* err_count,
    int32_t* ckey, uint8_t* qstate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  row_fold_kernel<<<B, kThreads, 0, s>>>(
      matched, err, req_ns, B, R, rule_ns, default_ns, deny_mask, deny_status,
      deny_dur, deny_uses, err_rule_mask, NL, E, list_ids, list_rule,
      list_slot, list_black, list_code, list_dur, list_uses, ids, present,
      hash_ids, C, Q, NB, q_rule, q_slot, q_nb, table, T_rows, T_cols, n_attr,
      status, dur, uses, deny_rule, referenced, err_count, ckey);
  if (Q > 0) {
    const unsigned row_blocks = (unsigned)((B + kThreads - 1) / kThreads);
    quota_rank_kernel<<<dim3(row_blocks, (unsigned)Q), kThreads, 0, s>>>(
        ckey, B, q_max, quota_counts, qstate);
    quota_commit_kernel<<<row_blocks, kThreads, 0, s>>>(
        ckey, qstate, B, Q, q_rule, quota_counts, status, deny_rule);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? (Q > 0 ? 3 : 1) : -(int)e;
}
