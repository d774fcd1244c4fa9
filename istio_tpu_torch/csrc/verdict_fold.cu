// verdict_fold — the policy verdict of every request from its rule-match
// planes: namespace mask, deny fold, list fold, RBAC any-allow fold,
// quota rank / grant / commit, referenced attributes and the batch error
// count; unsharded (verdict_fold) and over a dp x mp mesh (mesh_partial,
// mesh_combine, mesh_quota). Both share one row-fold body over a window
// [r0, r0 + Rm) of the global rule axis, one RBAC decision, one
// lowest-index resolution and one quota rank / grant / commit; the
// unsharded fold is the window [0, R) of one shard, in one launch (and
// one more for its quotas).
//
// Replaces the JAX package's istio_tpu/models/policy_engine.py:379-654,
// PolicyEngine.__init__.<locals>.step, after the byte-level list banks
// (the list_banks kernel computes the REGEX and CIDR memberships), and
// the verdict-fold half of istio_tpu/parallel/mesh.py shard_engine_check
// (:146), where jax.jit partitions raw_step with batch rows over "dp"
// and the rule axis over "mp" (param_shardings, :63) and XLA inserts one
// reduction over "mp" where the fold contracts the rule axis.
//
// The rule tables the row fold reads are bit words (rule_words.cuh;
// models/policy_engine.fold_word_tables): vis_words, one row of the rules
// each request namespace sees (its row looked up once per request row
// from vis_ns), deny_words and err_words. No per-rule namespace, deny or
// err-mask byte is read.
//
// verdict_fold: two launches (one without quotas), one chain on the
// caller's stream.
//   1. row_fold      one warp per request row b, kFoldWarps rows a block.
//      The lanes walk the row's matched and err bytes in 16-byte words
//      (16 rules a load, every word of both rows: gating a load on the
//      table words, to skip words with no visible rule the fold reads,
//      was slower on the card, PERF.md §6):
//      errors += popc(e & vis & err_words); the candidates m & vis &
//      deny_words give the LOWEST active deny rule (its status) and the
//      min TTL / use count over all of them, one set bit at a time — the
//      err plane is the one the regex banks already OR'd their
//      undecidable rows into. The lanes then stride over the lists:
//      membership is the id scan (any entry id == the slot's id), or for
//      a REGEX / IP_ADDRESSES list its state byte from list_banks
//      (member, und, bad); an absent value, or a bad one, on an active
//      list rule is INTERNAL, and an und row is neither evaluated nor
//      INTERNAL. The list winner is the lowest (rule, list) pair and
//      beats the deny only with a strictly lower rule index. Then, per
//      RBAC spec, the lanes stride over its allow rows (columns of
//      matched; R is the FALSE sentinel, R + 1 the TRUE one) and a warp
//      vote gives allow; an active spec whose guard row is not matched
//      is INTERNAL, one whose guard holds and that no allow row matched
//      is PERMISSION_DENIED, and the lowest (rule, spec) of those beats
//      deny and list only with a strictly lower rule; the spec's TTL
//      mins into the row's wherever it is active with its guard holding.
//      Warp reductions (no shared memory, no block barrier) combine the
//      lanes, the row's status / TTLs / deny_rule are written, every
//      active quota writes its composite key q·NB + (hash mod nb, floor
//      modulo) to ckey[q, b] (-1 if inactive), the referenced row is
//      copied from the per-namespace table, and the warp's error count
//      is added to the batch scalar with one int32 atomicAdd.
//   2. quota_grant   the quota rank / grant / commit (below).
//
// The mesh (a shard holds matched and err [B/dp, R/mp]), each entry point
// launched on the stream of the virtual device it runs for:
//   mesh_partial  per (dp, mp) shard, one warp per row: the row fold on
//      the shard's rule slice (the word tables, list and quota tables are
//      indexed globally; the slice may start at any rule). It writes one
//      partial record per row: the lowest active deny rule, min TTL and
//      min use count over its deny rules and evaluated lists, its error
//      count, its list winner (rule, list, status), and one flag byte per
//      RBAC spec (bit 0: an allow row in the slice matched, bit 1: the
//      guard row is in the slice and matched, or is the TRUE sentinel;
//      bit 2: the spec's rule is in the slice and active) and per quota
//      (the quota's rule is in the slice and active). One spec's allow
//      rows, its guard row and its own rule may lie on different shards;
//      each bit is an OR, so the combine sees the unsharded values.
//   mesh_combine  per dp shard, on that shard's device, one warp per row
//      as in row_fold (kFoldWarps rows a block, no shared memory, no
//      block barrier): the lanes OR each RBAC spec's flag bytes over mp
//      and decide the specs as in row_fold, lane m reads mp record m, and
//      warp reductions give the min / sum / lowest (rule, list) over the
//      records; the same resolution (LOWEST INDEX wins, ties deny -> list
//      -> RBAC -> quota, never the highest status, so no per-shard max can
//      stand in for it), quota keys into the shard's ckey [Q, B/dp] and
//      the referenced rows by the warp's lanes, one error-count atomic a
//      warp.
//   mesh_quota    per dp replica, after the [Q, B/dp] keys of every dp
//      shard are gathered into [Q, B]: a quota rank spans the WHOLE batch,
//      so no dp shard can rank alone. Each replica runs quota_grant on
//      every row, commits every grant into ITS copy of the counters (the
//      counters stay replicated and equal to the unsharded step's), and
//      sets RESOURCE_EXHAUSTED only on its own rows [row0, row0 + Bd).
//
// quota_grant: rank[b, q] = #{j < b : ckey[j, q] == ckey[b, q]} (active
// keys), granted iff counts[key] + rank < q_max[q] in int32, every counter
// read before any grant of the batch is committed. A composite key holds
// q·NB, so the columns touch disjoint counters and rank independently: a
// block per column (grid.y) over consecutive rows, and where a column's
// rows exceed one block's, a thread-block cluster of up to 16 blocks
// (distributed shared memory), then three launches with the tables in a
// global scratch buffer — chosen by size in the host's quota plan
// (models/policy_engine.quota_plan). A block hashes its rows' keys into a
// shared-memory table with their counts (a warp's equal keys counted by
// one atomic of their leader), then decides each key once: its rows hold
// the group ranks [pre, pre + n), pre its rows in the column's earlier
// blocks (looked up in their tables), so with the counter c its rows are
// all granted (c + pre + n - 1 < q_max), all over (c + pre >= q_max), or
// — only where the limit falls inside the group, or the int32 sum wraps —
// ranked exactly by one warp walking the block's rows in 32-row windows
// in row order (__match_any_sync peers in the window plus the key's
// running count). Over-limit rows combine across columns by atomicMin of
// the rule into deny_rule and a store of RESOURCE_EXHAUSTED; each key
// commits its grants with one add (plain for a block's own column,
// atomic across a cluster's blocks), after every read of the counters.
// No sort, and no per-row work past the table for a decided key: the
// time is a few shared-memory passes over the rows and one global read
// and write per distinct key.
// Padding rows of the rule axis carry namespace -7: a request namespace
// of -7 sees them (its own vis row), and they match nothing.
//
// What bounds it on an H100: memory. The fold reads the matched and err
// planes once (2·B·R bytes, 41 MB at B=2048, R=10,008, over all shards)
// plus the word tables, which stay in L1 / L2, and does a few integer
// ops per 16 rules. The design gives each row one warp, so the
// 16-byte loads of a warp cover 512 contiguous bytes of a plane and each
// lane keeps kUnroll words of both planes in flight; the namespace, deny
// and err-mask tests are three AND-ed table words per 16 rules instead of
// a table read per rule; the row's reductions are warp shuffles, with no
// barrier. The RBAC fold re-reads only its specs' allow-row columns of
// the matched row, which the walk has just brought into L1 / L2. Under a
// mesh the per-row [R] work stays where the rules are and only the small
// records cross shards.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rule_words.cuh"

namespace cg = cooperative_groups;

// Request rows (warps) per block of the row folds; chosen by A/B on the
// card (PERF.md).
#ifndef FOLD_WARPS
#define FOLD_WARPS 4
#endif

namespace {

using rule_words::kFull;
using rule_words::kUnroll;

constexpr int kFoldWarps = FOLD_WARPS;
constexpr int kFoldThreads = 32 * kFoldWarps;
constexpr int kQuotaMaxRows = 4096;  // rows a quota block holds, at most
constexpr int32_t kIntMax = 2147483647;
constexpr float kBig = 3.4e38f;
constexpr int32_t kOK = 0, kPermissionDenied = 7, kInternal = 13,
                  kResourceExhausted = 8;
constexpr uint8_t kListMember = 1, kListUnd = 2, kListBad = 4;
constexpr float kDefaultDur = 5.0f;
constexpr int32_t kDefaultUses = 10000;
// the mesh's partial record rows
constexpr int kRecDeny = 0, kRecDur = 1, kRecUses = 2, kRecErr = 3,
              kRecLRule = 4, kRecLArg = 5, kRecLStatus = 6, kRecRows = 7;
constexpr uint8_t kRbAllow = 1, kRbGuard = 2, kRbActive = 4;

__device__ __forceinline__ int32_t floor_mod(int32_t k, int32_t m) {
  int32_t r = k % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ float warp_fmin(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// The rule-word tables of the fold (rule_words.cuh).
struct WordTables {
  const int32_t* vis_ns;  // [V] namespace values with a row of their own
  int V;
  const uint32_t* vis_words;  // [V + 1, NW]
  const uint32_t* deny_words;  // [NW]
  const uint32_t* err_words;   // [NW]
  int NW;
  const float* deny_dur;
  const int32_t* deny_uses;
};

// A rule of the window [r0, r1) of a row whose window columns are m_row:
// matched and visible to the request's namespace (vis: its row of
// vis_words, global rule bits).
struct Window {
  const uint8_t* m_row;
  const uint32_t* vis;
  int r0, r1, R;

  __device__ bool holds(int32_t r) const { return r >= r0 && r < r1; }
  __device__ bool visible(int32_t r) const {
    return (vis[r >> 5] >> (r & 31)) & 1u;
  }
  __device__ bool active(int32_t r) const {
    return holds(r) && visible(r) && m_row[r - r0];
  }
  // a column of matched, or the FALSE (R) / TRUE (R + 1) sentinel
  __device__ bool column(int32_t c) const {
    return holds(c) ? m_row[c - r0] != 0 : c == R + 1;
  }
};

// The window of request row b of planes whose rows are Rm bytes.
__device__ __forceinline__ Window row_window(const uint8_t* matched, int b,
                                             int Rm, int r0, int R,
                                             const WordTables& T,
                                             int32_t rns) {
  const int row = rule_words::vis_row(T.vis_ns, T.V, rns);
  return Window{matched + (long long)b * Rm,
                T.vis_words + (long long)row * T.NW, r0, r0 + Rm, R};
}

struct ListTables {
  int NL, E;
  const int32_t *ids, *rule, *slot, *code, *uses;
  const uint8_t *black, *kind;
  const float* dur;
};

// The warp's fold of one row over its window, the same in every lane.
struct RowPart {
  int32_t deny, uses, errs;
  float dur;
  unsigned long long lkey;  // (rule << 32 | list) of the list winner
};

// The rule and list passes of one row over the window: the lowest active
// deny rule, min TTL and use count over its active deny rules and
// evaluated lists (INTERNAL lists min in the CheckResult defaults), the
// error count and the lowest (rule, list) hit. Every lane of the warp
// calls it and gets the result.
__device__ RowPart fold_window(const Window& w, const uint8_t* e_row,
                               const WordTables& T, const ListTables& L,
                               const uint8_t* ls_row, const int32_t* id_row,
                               const uint8_t* pr_row) {
  const int lane = threadIdx.x & 31;
  const int n = w.r1 - w.r0;
  int32_t best = kIntMax, best_uses = kIntMax, errs = 0;
  float best_dur = kBig;
  // rules g.. of the window: matched bits m, err bits e, and the table
  // bits already AND-ed with vis (d: visible deny rules, ce: visible
  // rules the count covers)
  auto fold = [&](int g, uint32_t m, uint32_t e, uint32_t d, uint32_t ce) {
    errs += __popc(e & ce);
    for (uint32_t c = m & d; c; c &= c - 1) {
      const int r = g + __ffs(c) - 1;
      best = min(best, r);
      best_dur = fminf(best_dur, T.deny_dur[r]);
      best_uses = min(best_uses, T.deny_uses[r]);
    }
  };
  const rule_words::RowSplit s(w.m_row, n);
  const int j1 = s.single_byte(lane, n);
  if (j1 >= 0) {
    const int g = w.r0 + j1;
    const uint32_t v = rule_words::table_bits(w.vis, g, 1);
    fold(g, w.m_row[j1] != 0, e_row[j1] != 0,
         v & rule_words::table_bits(T.deny_words, g, 1),
         v & rule_words::table_bits(T.err_words, g, 1));
  }
  const uint4* m4 = reinterpret_cast<const uint4*>(w.m_row + s.head);
  const uint4* e4 = reinterpret_cast<const uint4*>(e_row + s.head);
  const int g0 = w.r0 + s.head;
  for (int c0 = lane; c0 < s.body; c0 += 32 * kUnroll) {
    uint4 mq[kUnroll], eq[kUnroll];
    uint32_t d[kUnroll], ce[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      mq[u] = eq[u] = make_uint4(0u, 0u, 0u, 0u);
      d[u] = ce[u] = 0u;
      if (c < s.body) {
        const int g = g0 + 16 * c;
        const uint32_t v = rule_words::table_bits(w.vis, g, 16);
        d[u] = v & rule_words::table_bits(T.deny_words, g, 16);
        ce[u] = v & rule_words::table_bits(T.err_words, g, 16);
        mq[u] = m4[c];  // not gated on d / ce: see the header
        eq[u] = e4[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      fold(g0 + 16 * (c0 + 32 * u), rule_words::nonzero16(mq[u]),
           rule_words::nonzero16(eq[u]), d[u], ce[u]);
  }
  unsigned long long lkey = ~0ull;  // (rule << 32 | list), lowest wins
  float ldur = kBig;
  int32_t luses = kIntMax;
  bool lint = false;
  auto fold_list = [&](int l, int32_t rule) {  // an active list's rule
    const int slot = L.slot[l];
    const bool byte = ls_row != nullptr && L.kind[l];
    const uint8_t st = byte ? ls_row[l] : 0;
    bool hit;
    if (!pr_row[slot] || (st & kListBad)) {
      hit = true;  // absent or unusable value on an active rule → INTERNAL
      lint = true;
    } else if (st & kListUnd) {
      hit = false;  // undecidable: the rule errs instead (list_banks)
    } else {
      bool member = false;
      if (byte) {
        member = st & kListMember;
      } else {
        const int32_t sym = id_row[slot];
        for (int e = 0; e < L.E && !member; ++e)
          member = L.ids[(long long)l * L.E + e] == sym;
      }
      hit = member == (L.black[l] != 0);
      ldur = fminf(ldur, L.dur[l]);
      luses = min(luses, L.uses[l]);
    }
    if (hit) {
      const unsigned long long k =
          ((unsigned long long)(uint32_t)rule << 32) | (uint32_t)l;
      lkey = k < lkey ? k : lkey;
    }
  };
  // kUnroll lists a lane at a time, so that their activity tests (rule,
  // vis word, matched byte) are loads in flight together; an inactive
  // list, or another shard's, is skipped
  for (int l0 = lane; l0 < L.NL; l0 += 32 * kUnroll) {
    int32_t rule[kUnroll];
    bool act[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = l0 + 32 * u;
      rule[u] = l < L.NL ? L.rule[l] : w.R;  // R: in no window
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) act[u] = w.active(rule[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (act[u]) fold_list(l0 + 32 * u, rule[u]);
  }
  RowPart p;
  p.deny = __reduce_min_sync(kFull, best);
  p.errs = __reduce_add_sync(kFull, errs);
  p.lkey = warp_min64(lkey);
  p.dur = fminf(warp_fmin(best_dur), warp_fmin(ldur));
  p.uses = min(__reduce_min_sync(kFull, best_uses),
               __reduce_min_sync(kFull, luses));
  if (__any_sync(kFull, lint)) {  // INTERNAL carries the CheckResult defaults
    p.dur = fminf(p.dur, kDefaultDur);
    p.uses = min(p.uses, kDefaultUses);
  }
  return p;
}

// The status of list l's win on this row: its code, or INTERNAL where the
// value is absent or unusable.
__device__ int32_t list_status(int l, const ListTables& L,
                               const uint8_t* ls_row, const uint8_t* pr_row) {
  const bool bad = ls_row != nullptr && L.kind[l] && (ls_row[l] & kListBad);
  return pr_row[L.slot[l]] && !bad ? L.code[l] : kInternal;
}

// RBAC spec i's flag bits over the window. Every lane of the warp calls
// it (the allow OR is a warp vote, 32·kUnroll allow rows a round, each
// lane's kUnroll column reads in flight together, ending at the first
// round that finds one); every lane gets the bits.
__device__ uint8_t rbac_bits(const Window& w, int i, int KA,
                             const int32_t* rb_rule, const int32_t* rb_guard,
                             const int32_t* rb_allow) {
  const int32_t* row = rb_allow + (long long)i * KA;
  const int lane = threadIdx.x & 31;
  bool allow = false;
  for (int k0 = 0; k0 < KA && !allow; k0 += 32 * kUnroll) {
    int32_t cols[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + 32 * u + lane;
      cols[u] = k < KA ? row[k] : w.R;  // the FALSE sentinel
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) any |= w.column(cols[u]);
    allow = __any_sync(kFull, any);
  }
  return (allow ? kRbAllow : 0) | (w.column(rb_guard[i]) ? kRbGuard : 0) |
         (w.active(rb_rule[i]) ? kRbActive : 0);
}

// Spec i decided from its (unsharded) flag bits: INTERNAL where active
// and the guard fails, PERMISSION_DENIED where active, guarded and no
// allow row matched; the lowest (rule, spec) of those is kept, and the
// spec's TTL mins in where it is active and guarded.
struct RbacWin {
  unsigned long long key = ~0ull;  // (rule << 32 | spec), lowest wins
  bool deny = false;
  float dur = kBig;

  __device__ void take(uint8_t f, int i, const int32_t* rb_rule,
                       const float* rb_dur) {
    const bool allow = f & kRbAllow, guard_ok = f & kRbGuard,
               act = f & kRbActive;
    const bool d = act && guard_ok && !allow;
    if (d || (act && !guard_ok)) {
      const unsigned long long k =
          ((unsigned long long)(uint32_t)rb_rule[i] << 32) | (uint32_t)i;
      if (k < key) {
        key = k;
        deny = d;
      }
    }
    if (act && guard_ok) dur = fminf(dur, rb_dur[i]);
  }
};

// The row's status and deny rule: the lowest deny rule, beaten by the
// list winner, then the RBAC winner, each only with a strictly lower rule
// index (the lowest index wins; ties go deny -> list -> RBAC).
__device__ int32_t resolve(int32_t deny, const int32_t* deny_status,
                           unsigned long long lkey, int32_t l_status,
                           const RbacWin& rb, int32_t* deny_rule) {
  int32_t cand_rule = deny;
  int32_t cand_status = deny < kIntMax ? deny_status[deny] : kOK;
  if (lkey != ~0ull && (int32_t)(lkey >> 32) < cand_rule) {
    cand_status = l_status;
    cand_rule = (int32_t)(lkey >> 32);
  }
  if (rb.key != ~0ull && (int32_t)(rb.key >> 32) < cand_rule) {
    cand_status = rb.deny ? kPermissionDenied : kInternal;
    cand_rule = (int32_t)(rb.key >> 32);
  }
  const int32_t st = cand_rule < kIntMax ? cand_status : kOK;
  *deny_rule = st == kOK ? kIntMax : cand_rule;
  return st;
}

// The quota keys of row b (ckey [Q, ld]) and its referenced row, by the
// threads t = t0, t0 + nt, ... (a warp's lanes, or a block's threads).
// act(q) says whether quota q's rule is active on the row; a key is
// written only where the row's status is OK and the quota's slot present.
template <typename Act>
__device__ void row_tail(int t0, int nt, int b, int ld, int32_t status,
                         Act act, int Q, int NB, const int32_t* q_slot,
                         const int32_t* q_nb, const uint8_t* pr_row,
                         const int32_t* hash_row, int32_t* ckey, int32_t rns,
                         const uint8_t* table, int T_rows, int T_cols,
                         int n_attr, uint8_t* referenced) {
  for (int q = t0; q < Q; q += nt) {
    const int slot = q_slot[q];
    const bool a = status == kOK && act(q) && pr_row[slot];
    ckey[(long long)q * ld + b] =
        a ? q * NB + floor_mod(hash_row[slot], q_nb[q]) : -1;
  }
  const int t_row = (rns >= 0 && rns < T_rows - 1) ? rns + 1 : 0;
  for (int c = t0; c < n_attr; c += nt)
    referenced[(long long)b * n_attr + c] = table[(long long)t_row * T_cols + c];
}

__global__ void __launch_bounds__(kFoldThreads) row_fold_kernel(
    const uint8_t* __restrict__ matched, const uint8_t* __restrict__ err,
    const int32_t* __restrict__ req_ns, int B, int R, WordTables T,
    const int32_t* __restrict__ deny_status, ListTables L,
    const uint8_t* __restrict__ lstate, int NRB, int KA,
    const int32_t* __restrict__ rb_rule, const float* __restrict__ rb_dur,
    const int32_t* __restrict__ rb_guard,
    const int32_t* __restrict__ rb_allow,
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ present,
    const int32_t* __restrict__ hash_ids, int C, int Q, int NB,
    const int32_t* __restrict__ q_rule, const int32_t* __restrict__ q_slot,
    const int32_t* __restrict__ q_nb, const uint8_t* __restrict__ table,
    int T_rows, int T_cols, int n_attr, int32_t* __restrict__ status,
    float* __restrict__ dur, int32_t* __restrict__ uses,
    int32_t* __restrict__ deny_rule, uint8_t* __restrict__ referenced,
    int32_t* __restrict__ err_count, int32_t* __restrict__ ckey) {
  const int b = blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int32_t rns = req_ns[b];
  const Window w = row_window(matched, b, R, 0, R, T, rns);
  const uint8_t* ls_row = lstate != nullptr ? lstate + (long long)b * L.NL
                                            : nullptr;
  const uint8_t* pr_row = present + (long long)b * C;
  const RowPart p = fold_window(w, err + (long long)b * R, T, L, ls_row,
                                ids + (long long)b * C, pr_row);
  RbacWin rb;
  for (int i = 0; i < NRB; ++i)
    rb.take(rbac_bits(w, i, KA, rb_rule, rb_guard, rb_allow), i, rb_rule,
            rb_dur);
  const int32_t l_status =
      p.lkey != ~0ull
          ? list_status((int)(p.lkey & 0xffffffffull), L, ls_row, pr_row)
          : kOK;
  int32_t drule;
  const int32_t st = resolve(p.deny, deny_status, p.lkey, l_status, rb,
                             &drule);
  if (lane == 0) {
    status[b] = st;
    dur[b] = fminf(p.dur, rb.dur);  // caching TTL; RBAC never touches uses
    uses[b] = p.uses;
    deny_rule[b] = drule;
    if (p.errs) atomicAdd(err_count, p.errs);
  }
  row_tail(lane, 32, b, B, st, [&](int q) { return w.active(q_rule[q]); }, Q,
           NB, q_slot, q_nb, pr_row, hash_ids + (long long)b * C, ckey, rns,
           table, T_rows, T_cols, n_attr, referenced);
}

__global__ void __launch_bounds__(kFoldThreads) partial_kernel(
    const uint8_t* __restrict__ matched, const uint8_t* __restrict__ err,
    const int32_t* __restrict__ req_ns, int Bd, int Rm, int r0, int R,
    WordTables T, ListTables L, const uint8_t* __restrict__ lstate, int NRB,
    int KA, const int32_t* __restrict__ rb_rule,
    const int32_t* __restrict__ rb_guard,
    const int32_t* __restrict__ rb_allow, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ present, int C, int Q,
    const int32_t* __restrict__ q_rule, int32_t* __restrict__ rec,
    uint8_t* __restrict__ flags) {
  const int b = blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (b >= Bd) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const Window w = row_window(matched, b, Rm, r0, R, T, req_ns[b]);
  const uint8_t* ls_row = lstate != nullptr ? lstate + (long long)b * L.NL
                                            : nullptr;
  const uint8_t* pr_row = present + (long long)b * C;
  const RowPart p = fold_window(w, err + (long long)b * Rm, T, L, ls_row,
                                ids + (long long)b * C, pr_row);
  if (lane == 0) {
    int32_t l_rule = kIntMax, l_arg = 0, l_status = kOK;
    if (p.lkey != ~0ull) {
      l_rule = (int32_t)(p.lkey >> 32);
      l_arg = (int32_t)(p.lkey & 0xffffffffull);
      l_status = list_status(l_arg, L, ls_row, pr_row);
    }
    rec[kRecDeny * Bd + b] = p.deny;
    rec[kRecDur * Bd + b] = __float_as_int(p.dur);
    rec[kRecUses * Bd + b] = p.uses;
    rec[kRecErr * Bd + b] = p.errs;
    rec[kRecLRule * Bd + b] = l_rule;
    rec[kRecLArg * Bd + b] = l_arg;
    rec[kRecLStatus * Bd + b] = l_status;
  }
  uint8_t* f_row = flags + (long long)b * (NRB + Q);
  for (int i = 0; i < NRB; ++i) {
    const uint8_t f = rbac_bits(w, i, KA, rb_rule, rb_guard, rb_allow);
    if (lane == 0) f_row[i] = f;
  }
  for (int q = lane; q < Q; q += 32)
    f_row[NRB + q] = w.active(q_rule[q]) ? 1 : 0;
}

// One warp per dp-shard row b, kFoldWarps rows a block (no shared memory,
// no block barrier): the lanes stride over the RBAC specs, each spec's
// flag bytes OR'd over the MP records, then lane m < MP reads record m;
// warp reductions give the lowest (rule, spec) and (rule, list) keys (on a
// tie of list keys the lowest record, as the plain argmin), the min TTL,
// use count and deny rule and the error sum; then resolve and row_tail on
// the warp's lanes.
__global__ void __launch_bounds__(kFoldThreads) combine_kernel(
    int MP, const int32_t* __restrict__ rec, const uint8_t* __restrict__ flags,
    int Bd, const int32_t* __restrict__ req_ns,
    const int32_t* __restrict__ deny_status, int NRB,
    const int32_t* __restrict__ rb_rule, const float* __restrict__ rb_dur,
    const uint8_t* __restrict__ present,
    const int32_t* __restrict__ hash_ids, int C, int Q, int NB,
    const int32_t* __restrict__ q_slot, const int32_t* __restrict__ q_nb,
    const uint8_t* __restrict__ table, int T_rows, int T_cols, int n_attr,
    int32_t* __restrict__ status, float* __restrict__ dur,
    int32_t* __restrict__ uses, int32_t* __restrict__ deny_rule,
    uint8_t* __restrict__ referenced, int32_t* __restrict__ err_count,
    int32_t* __restrict__ ckey) {
  const int b = blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (b >= Bd) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int NF = NRB + Q;
  const long long rec_stride = (long long)kRecRows * Bd;
  const long long flag_stride = (long long)Bd * NF;
  const uint8_t* f_row = flags + (long long)b * NF;
  // RBAC specs over the lanes: each spec's flag bytes OR'd over mp
  RbacWin rb;
  for (int i = lane; i < NRB; i += 32) {
    uint8_t f = 0;
    for (int m = 0; m < MP; ++m) f |= f_row[m * flag_stride + i];
    rb.take(f, i, rb_rule, rb_dur);
  }
  RbacWin all;
  all.key = warp_min64(rb.key);
  all.deny = __any_sync(kFull, rb.key == all.key && rb.deny);
  all.dur = warp_fmin(rb.dur);
  // the records: lane m reads record m (and m + 32, ...)
  int32_t deny = kIntMax, u = kIntMax, errs = 0, l_status = kOK;
  int l_rec = kIntMax;
  float d = kBig;
  unsigned long long lkey = ~0ull;
  for (int m = lane; m < MP; m += 32) {
    const int32_t* r = rec + m * rec_stride + b;
    deny = min(deny, r[kRecDeny * Bd]);
    d = fminf(d, __int_as_float(r[kRecDur * Bd]));
    u = min(u, r[kRecUses * Bd]);
    errs += r[kRecErr * Bd];
    const int32_t l_rule = r[kRecLRule * Bd];
    if (l_rule != kIntMax) {
      const unsigned long long k =
          ((unsigned long long)(uint32_t)l_rule << 32) |
          (uint32_t)r[kRecLArg * Bd];
      if (k < lkey) {
        lkey = k;
        l_status = r[kRecLStatus * Bd];
        l_rec = m;
      }
    }
  }
  deny = __reduce_min_sync(kFull, deny);
  u = __reduce_min_sync(kFull, u);
  errs = __reduce_add_sync(kFull, errs);
  d = warp_fmin(d);
  const unsigned long long lmin = warp_min64(lkey);
  const int m_win = __reduce_min_sync(
      kFull, lkey == lmin ? l_rec : kIntMax);  // the lowest record
  l_status = lmin != ~0ull ? __shfl_sync(kFull, l_status, m_win & 31) : kOK;
  int32_t drule;
  const int32_t st = resolve(deny, deny_status, lmin, l_status, all, &drule);
  if (lane == 0) {
    status[b] = st;
    dur[b] = fminf(d, all.dur);  // caching TTL; RBAC never touches uses
    uses[b] = u;
    deny_rule[b] = drule;
    if (errs) atomicAdd(err_count, errs);
  }
  auto act = [&](int q) {
    for (int m = 0; m < MP; ++m)
      if (f_row[m * flag_stride + NRB + q]) return true;
    return false;
  };
  row_tail(lane, 32, b, Bd, st, act, Q, NB, q_slot, q_nb,
           present + (long long)b * C, hash_ids + (long long)b * C, ckey,
           req_ns[b], table, T_rows, T_cols, n_attr, referenced);
}

// ---------------------------------------------------------------------------
// the quota rank / grant / commit: one launch, a block (or a cluster of
// blocks) per quota column
// ---------------------------------------------------------------------------

// The quota launch plan (models/policy_engine.quota_plan): `blocks` blocks
// a quota column, each over `rows` consecutive rows with `threads`
// threads and a hash table of `slots` (a power of two >= 2 rows), and
// `launches` 1 (one block, or one cluster of `blocks`) or 3 (the
// multi-launch path: build, decide, commit).
struct QuotaArgs {
  const int32_t* ckey;  // [Q, B]; < 0 inactive
  int B, Q, row0, Bd;
  const int32_t* q_max;
  const int32_t* q_rule;
  int32_t* counts;
  int32_t* status;     // the Bd rows from row0
  int32_t* deny_rule;
  int blocks, rows, slots;
  int32_t* scratch;    // multi-launch: [Q][blocks][3][slots]
};

// the kernel's paths: one block a column, one cluster a column, and the
// three launches of the multi-launch path
enum QuotaPath : int { kQOne, kQCluster, kQBuild, kQDecide, kQCommit };
constexpr int kQuotaMaxThreads = 1024;

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Fibonacci hashing: the top log2(S) bits of key * 2^32 / phi
__device__ __forceinline__ uint32_t key_slot(int32_t key, int S) {
  return ((uint32_t)key * 2654435769u) >> (__clz(S) + 1);
}

// The slot of key in the open-addressed table tkey [S] (-1 empty),
// claimed if absent. S >= 2 x the keys inserted, so a probe ends.
__device__ __forceinline__ int table_insert(int32_t* tkey, int S,
                                            int32_t key) {
  uint32_t h = key_slot(key, S);
  for (;;) {
    const int32_t old = atomicCAS(tkey + h, -1, key);
    if (old == -1 || old == key) return (int)h;
    h = (h + 1) & (S - 1);
  }
}

// The slot of key in tkey [S], or -1.
__device__ __forceinline__ int table_find(const int32_t* tkey, int S,
                                          int32_t key) {
  uint32_t h = key_slot(key, S);
  for (;;) {
    const int32_t k = tkey[h];
    if (k == key) return (int)h;
    if (k < 0) return -1;
    h = (h + 1) & (S - 1);
  }
}

// A block's shared state: per slot the key, the block's count of it (the
// walk's running count once decided), its base prior + pre (the counter
// plus the key's rows in earlier blocks, int32-wrapped), its grant (n: all
// granted, 0: all over, < 0: the walk decides, -1 - its grants so far);
// per row its slot (-1 inactive).
struct QuotaSmem {
  int32_t *tkey, *tcnt, *tbase, *tgr, *rslot;
  __device__ QuotaSmem(int32_t* base, int S)
      : tkey(base), tcnt(base + S), tbase(base + 2 * S), tgr(base + 3 * S),
        rslot(base + 4 * S) {}
};

__host__ __device__ constexpr size_t quota_smem_bytes(int slots, int rows) {
  return ((size_t)4 * slots + rows) * 4;
}

// Build: every active row of the block's range into the table, a warp's
// equal keys (__match_any_sync) counted by one atomic of their leader.
__device__ void quota_build(const int32_t* col, int r0, int n,
                            const QuotaSmem& m, int S) {
  for (int h = threadIdx.x; h < S; h += blockDim.x) {
    m.tkey[h] = -1;
    m.tcnt[h] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t key = i < n ? col[r0 + i] : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    int s = -1;
    if (key >= 0 && lane == leader) {
      s = table_insert(m.tkey, S, key);
      atomicAdd(m.tcnt + s, __popc(peers));
    }
    s = __shfl_sync(kFull, s, leader);
    if (i < n) m.rslot[i] = key >= 0 ? s : -1;
  }
}

// An over-limit row: RESOURCE_EXHAUSTED with the lowest over-limit quota
// rule, on the Bd rows from row0 only. Quota keys exist only on rows whose
// status was OK, whose deny_rule is kIntMax (resolve), so the min over
// the columns' atomics is the lowest over-limit rule.
__device__ __forceinline__ void quota_over(const QuotaArgs& a, int q, int b) {
  if (b >= a.row0 && b < a.row0 + a.Bd) {
    atomicMin(a.deny_rule + (b - a.row0), a.q_rule[q]);
    a.status[b - a.row0] = kResourceExhausted;
  }
}

// Decide every key of the block: its rows hold the group ranks [pre, pre
// + n) (pre: its rows in earlier blocks, `peer_count(k2, key)`), granted
// while counts[key] + rank < q_max in int32 — all of them, none, or
// (where the threshold falls inside, or the sum wraps) the walk decides
// row by row. → whether any key needs the walk (block-wide).
template <typename PeerCount>
__device__ bool quota_decide(const QuotaArgs& a, int q, int k,
                             const QuotaSmem& m, int S,
                             PeerCount peer_count) {
  bool walk = false;
  const int32_t qm = a.q_max[q];
  for (int h = threadIdx.x; h < S; h += blockDim.x) {
    const int32_t x = m.tkey[h];
    if (x < 0) continue;
    long long pre = 0;
    for (int k2 = 0; k2 < k; ++k2) pre += peer_count(k2, x);
    const int32_t n = m.tcnt[h];
    const long long lo = (long long)a.counts[x] + pre;
    int32_t g = -1;
    if (lo + n - 1 <= kIntMax) {
      const long long avail = qm - lo;
      g = avail >= n ? n : (avail <= 0 ? 0 : -1);
    }
    m.tbase[h] = (int32_t)(uint32_t)(unsigned long long)lo;
    m.tgr[h] = g;
    walk |= g < 0;
  }
  return __syncthreads_or(walk) != 0;
}

// The rows of decided keys; then, where a key needs it, one warp walks the
// block's rows in 32-row windows in row order: __match_any_sync gives a
// row's earlier peers in its window, the slot's running count those of
// earlier windows, so each row of a walked key gets its exact rank.
__device__ void quota_rows(const QuotaArgs& a, int q, int r0, int n,
                           const QuotaSmem& m, int S, bool walk) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = m.rslot[i];
    if (s >= 0 && m.tgr[s] == 0) quota_over(a, q, r0 + i);
  }
  if (!walk) return;
  for (int h = threadIdx.x; h < S; h += blockDim.x)
    if (m.tkey[h] >= 0 && m.tgr[h] < 0) m.tcnt[h] = 0;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int32_t qm = a.q_max[q];
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int s = i < n ? m.rslot[i] : -1;
    const bool w = s >= 0 && m.tgr[s] < 0;
    if (!__any_sync(kFull, w)) continue;
    const unsigned peers = __match_any_sync(kFull, w ? s : -1);
    int32_t run = 0;
    bool granted = false;
    if (w) {
      run = m.tcnt[s];
      const uint32_t r = (uint32_t)(run + __popc(peers & lanemask_lt()));
      granted = (int32_t)((uint32_t)m.tbase[s] + r) < qm;
    }
    const unsigned gm = __ballot_sync(kFull, granted);
    __syncwarp();
    if (w && lane == __ffs(peers) - 1) {
      m.tcnt[s] = run + __popc(peers);
      m.tgr[s] -= __popc(gm & peers);
    }
    __syncwarp();
    if (w && !granted) quota_over(a, q, r0 + i);
  }
}

__device__ __forceinline__ int32_t grants_of(int32_t g) {
  return g >= 0 ? g : -1 - g;
}

__global__ void __launch_bounds__(kQuotaMaxThreads)
    quota_grant_kernel(QuotaArgs a, int path) {
  extern __shared__ int32_t qsm[];
  const int k = blockIdx.x, q = blockIdx.y, S = a.slots;
  const int r0 = k * a.rows;
  const int n = max(0, min(a.rows, a.B - r0));
  const int32_t* col = a.ckey + (long long)q * a.B;
  int32_t* pub = a.scratch + ((long long)q * a.blocks + k) * 3 * S;
  if (path == kQCommit) {  // multi-launch: every block's grants, atomics
    for (int h = threadIdx.x; h < S; h += blockDim.x) {
      const int32_t x = pub[h], g = grants_of(pub[2 * S + h]);
      if (x >= 0 && g) atomicAdd(a.counts + x, g);
    }
    return;
  }
  const QuotaSmem m(qsm, S);
  if (path == kQDecide) {  // multi-launch: the table the build published
    for (int h = threadIdx.x; h < S; h += blockDim.x) {
      m.tkey[h] = pub[h];
      m.tcnt[h] = pub[S + h];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t key = col[r0 + i];
      m.rslot[i] = key >= 0 ? table_find(m.tkey, S, key) : -1;
    }
  } else {
    quota_build(col, r0, n, m, S);
  }
  if (path == kQBuild) {
    __syncthreads();
    for (int h = threadIdx.x; h < S; h += blockDim.x) {
      pub[h] = m.tkey[h];
      pub[S + h] = m.tcnt[h];
    }
    return;
  }
  bool walk;
  if (path == kQCluster) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's table built
    walk = quota_decide(a, q, k, m, S, [&](int k2, int32_t x) {
      const int32_t* tk = cl.map_shared_rank(m.tkey, k2);
      const int h = table_find(tk, S, x);
      return h < 0 ? 0 : cl.map_shared_rank(m.tcnt, k2)[h];
    });
    cl.sync();  // every counter read, no table read remotely any more
  } else {
    __syncthreads();
    const int32_t* base = a.scratch + (long long)q * a.blocks * 3 * S;
    walk = quota_decide(a, q, k, m, S, [&](int k2, int32_t x) {
      const int32_t* tk = base + (long long)k2 * 3 * S;
      const int h = table_find(tk, S, x);
      return h < 0 ? 0 : tk[S + h];
    });
  }
  quota_rows(a, q, r0, n, m, S, walk);
  __syncthreads();
  for (int h = threadIdx.x; h < S; h += blockDim.x) {
    const int32_t x = m.tkey[h];
    if (x < 0) continue;
    if (path == kQDecide) {
      pub[2 * S + h] = m.tgr[h];
    } else if (const int32_t g = grants_of(m.tgr[h])) {
      // one block a column: this thread read counts[x] in quota_decide,
      // and no other block holds x; a cluster: every block's read
      // precedes the cluster barrier above
      if (path == kQOne) a.counts[x] += g;
      else atomicAdd(a.counts + x, g);
    }
  }
}

// The quota launches of one plan → launches, or -cudaError_t.
int launch_quota(const QuotaArgs& a, int threads, int launches,
                 cudaStream_t s) {
  const size_t smem = quota_smem_bytes(a.slots, a.rows);
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        quota_grant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)quota_smem_bytes(2 * kQuotaMaxRows, kQuotaMaxRows));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(quota_grant_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return -(int)e;
    ready = true;
  }
  const dim3 grid((unsigned)a.blocks, (unsigned)a.Q);
  if (launches == 3) {
    quota_grant_kernel<<<grid, threads, smem, s>>>(a, kQBuild);
    quota_grant_kernel<<<grid, threads, smem, s>>>(a, kQDecide);
    quota_grant_kernel<<<grid, threads, 0, s>>>(a, kQCommit);
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess ? 3 : -(int)e;
  }
  if (a.blocks == 1) {
    quota_grant_kernel<<<grid, threads, smem, s>>>(a, kQOne);
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess ? 1 : -(int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, quota_grant_kernel, a, (int)kQCluster);
  return e == cudaSuccess ? 1 : -(int)e;
}

int launched(int n) {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
}

// The word tables of a fold over R rules (rule_words.cuh).
WordTables word_tables(int R, const int32_t* vis_ns, int V,
                       const int32_t* vis_words, const int32_t* deny_words,
                       const int32_t* err_words, const float* deny_dur,
                       const int32_t* deny_uses) {
  return WordTables{vis_ns,
                    V,
                    reinterpret_cast<const uint32_t*>(vis_words),
                    reinterpret_cast<const uint32_t*>(deny_words),
                    reinterpret_cast<const uint32_t*>(err_words),
                    (R + 31) / 32,
                    deny_dur,
                    deny_uses};
}

unsigned fold_blocks(int rows) {
  return (unsigned)((rows + kFoldWarps - 1) / kFoldWarps);
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
// vis_ns [V], vis_words [V + 1, ceil(R / 32)], deny_words and err_words
// [ceil(R / 32)]: models/policy_engine.fold_word_tables. matched and err
// start at addresses equal modulo 16.
extern "C" int verdict_fold(
    const uint8_t* matched, const uint8_t* err, const int32_t* req_ns, int B,
    int R, const int32_t* vis_ns, int V, const int32_t* vis_words,
    const int32_t* deny_words, const int32_t* err_words,
    const int32_t* deny_status, const float* deny_dur,
    const int32_t* deny_uses, int NL, int E,
    const int32_t* list_ids, const int32_t* list_rule,
    const int32_t* list_slot, const uint8_t* list_black,
    const int32_t* list_code, const float* list_dur,
    const int32_t* list_uses, const uint8_t* list_kind, const uint8_t* lstate,
    int NRB, int KA, const int32_t* rb_rule, const float* rb_dur,
    const int32_t* rb_guard, const int32_t* rb_allow, const int32_t* ids,
    const uint8_t* present,
    const int32_t* hash_ids, int C, int Q, int NB, const int32_t* q_rule,
    const int32_t* q_slot, const int32_t* q_max, const int32_t* q_nb,
    int32_t* quota_counts, const uint8_t* table, int T_rows, int T_cols,
    int n_attr, int32_t* status, float* dur, int32_t* uses,
    int32_t* deny_rule, uint8_t* referenced, int32_t* err_count,
    int32_t* ckey, int q_blocks, int q_rows, int q_threads, int q_slots,
    int q_launches, int32_t* q_scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const ListTables L{NL,        E,         list_ids,  list_rule, list_slot,
                     list_code, list_uses, list_black, list_kind, list_dur};
  const WordTables T = word_tables(R, vis_ns, V, vis_words, deny_words,
                                   err_words, deny_dur, deny_uses);
  row_fold_kernel<<<fold_blocks(B), kFoldThreads, 0, s>>>(
      matched, err, req_ns, B, R, T, deny_status, L, lstate, NRB, KA,
      rb_rule, rb_dur, rb_guard, rb_allow, ids, present, hash_ids, C, Q, NB,
      q_rule, q_slot, q_nb, table, T_rows, T_cols, n_attr, status, dur, uses,
      deny_rule, referenced, err_count, ckey);
  if (Q == 0) return launched(1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return -(int)e;
  const QuotaArgs qa{ckey,    B,      Q,      0,       B,       q_max,
                     q_rule,  quota_counts,   status,  deny_rule, q_blocks,
                     q_rows,  q_slots, q_scratch};
  const int n = launch_quota(qa, q_threads, q_launches, s);
  return n < 0 ? n : 1 + n;
}

// The partial record of one (dp, mp) shard over the rules [r0, r0 + Rm)
// of R: rec int32 [7, Bd], flags uint8 [Bd, NRB + Q]; the word tables as
// verdict_fold's, over all R rules. Returns the number of kernels
// launched, or -cudaError_t on failure.
extern "C" int mesh_partial(
    const uint8_t* matched, const uint8_t* err, const int32_t* req_ns, int Bd,
    int Rm, int r0, int R, const int32_t* vis_ns, int V,
    const int32_t* vis_words, const int32_t* deny_words,
    const int32_t* err_words, const float* deny_dur, const int32_t* deny_uses,
    int NL, int E, const int32_t* list_ids,
    const int32_t* list_rule, const int32_t* list_slot,
    const uint8_t* list_black, const int32_t* list_code,
    const float* list_dur, const int32_t* list_uses,
    const uint8_t* list_kind, const uint8_t* lstate, int NRB, int KA,
    const int32_t* rb_rule, const int32_t* rb_guard, const int32_t* rb_allow,
    const int32_t* ids, const uint8_t* present, int C, int Q,
    const int32_t* q_rule, int32_t* rec, uint8_t* flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bd == 0) return 0;
  const ListTables L{NL,        E,         list_ids,  list_rule, list_slot,
                     list_code, list_uses, list_black, list_kind, list_dur};
  const WordTables T = word_tables(R, vis_ns, V, vis_words, deny_words,
                                   err_words, deny_dur, deny_uses);
  partial_kernel<<<fold_blocks(Bd), kFoldThreads, 0, s>>>(
      matched, err, req_ns, Bd, Rm, r0, R, T, L, lstate, NRB, KA, rb_rule,
      rb_guard, rb_allow, ids, present, C, Q, q_rule, rec, flags);
  return launched(1);
}

// The combine of one dp shard over its MP records rec int32 [MP, 7, Bd]
// and flags uint8 [MP, Bd, NRB + Q]. Returns the number of kernels
// launched, or -cudaError_t on failure.
extern "C" int mesh_combine(
    int MP, const int32_t* rec, const uint8_t* flags, int Bd,
    const int32_t* req_ns, const int32_t* deny_status, int NRB,
    const int32_t* rb_rule, const float* rb_dur, const uint8_t* present,
    const int32_t* hash_ids, int C, int Q, int NB, const int32_t* q_slot,
    const int32_t* q_nb, const uint8_t* table, int T_rows, int T_cols,
    int n_attr, int32_t* status, float* dur, int32_t* uses,
    int32_t* deny_rule, uint8_t* referenced, int32_t* err_count,
    int32_t* ckey, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bd == 0) return 0;
  combine_kernel<<<fold_blocks(Bd), kFoldThreads, 0, s>>>(
      MP, rec, flags, Bd, req_ns, deny_status, NRB, rb_rule, rb_dur, present,
      hash_ids, C, Q, NB, q_slot, q_nb, table, T_rows, T_cols, n_attr, status,
      dur, uses, deny_rule, referenced, err_count, ckey);
  return launched(1);
}

// One dp replica's quota rank, grant and commit over the gathered keys
// ckey int32 [Q, B] under the quota plan (q_blocks .. q_launches; q_scratch
// int32 [Q, q_blocks, 3, q_slots] on the multi-launch path, else unused);
// status / deny_rule are the replica's own Bd rows, from global row row0.
// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int mesh_quota(const int32_t* ckey, int B, int Q, int row0,
                          int Bd, const int32_t* q_max,
                          const int32_t* q_rule, int32_t* counts,
                          int32_t* status, int32_t* deny_rule, int q_blocks,
                          int q_rows, int q_threads, int q_slots,
                          int q_launches, int32_t* q_scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Q == 0) return 0;
  const QuotaArgs qa{ckey,   B,      Q,      row0,    Bd,      q_max,
                     q_rule, counts, status, deny_rule, q_blocks,
                     q_rows, q_slots, q_scratch};
  return launch_quota(qa, q_threads, q_launches, s);
}
