// verdict_fold — the policy verdict of every request from its rule-match
// planes: namespace mask, deny fold, list fold, RBAC any-allow fold,
// quota rank / grant / commit, referenced attributes and the batch error
// count; unsharded (verdict_fold) and over a dp x mp mesh (mesh_partial,
// mesh_combine, mesh_quota). Both share one row-fold body over a window
// [r0, r0 + Rm) of the global rule axis, one RBAC decision, one
// lowest-index resolution and one quota rank / commit pair; the
// unsharded fold is the window [0, R) of one shard, in one launch.
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
// verdict_fold: three launches, one chain on the caller's stream.
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
//      so no dp shard can rank alone. Each replica runs quota_rank and
//      quota_commit on every row, commits every grant into ITS copy of the
//      counters (the counters stay replicated and equal to the unsharded
//      step's), and sets RESOURCE_EXHAUSTED only on its own rows [row0,
//      row0 + Bd).
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "rule_words.cuh"

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
constexpr int kThreads = 256;
constexpr int kTile = 4096;
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

// Every grant of the B rows is committed; status / deny_rule are the Bd
// rows from row0 (the whole batch unsharded, a dp replica's own rows).
__global__ void quota_commit_kernel(const int32_t* __restrict__ ckey,
                                    const uint8_t* __restrict__ qstate, int B,
                                    int Q, int row0, int Bd,
                                    const int32_t* __restrict__ q_rule,
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
  if (any_over && b >= row0 && b < row0 + Bd) {  // quota ran only where OK
    status[b - row0] = kResourceExhausted;
    deny_rule[b - row0] = over_rule;
  }
}

// quota_rank then quota_commit over ckey [Q, B]; → launches.
int launch_quota(const int32_t* ckey, int B, int Q, int row0, int Bd,
                 const int32_t* q_max, const int32_t* q_rule, int32_t* counts,
                 uint8_t* qstate, int32_t* status, int32_t* deny_rule,
                 cudaStream_t s) {
  const unsigned row_blocks = (unsigned)((B + kThreads - 1) / kThreads);
  quota_rank_kernel<<<dim3(row_blocks, (unsigned)Q), kThreads, 0, s>>>(
      ckey, B, q_max, counts, qstate);
  quota_commit_kernel<<<row_blocks, kThreads, 0, s>>>(
      ckey, qstate, B, Q, row0, Bd, q_rule, counts, status, deny_rule);
  return 2;
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
    int32_t* ckey, uint8_t* qstate, void* stream) {
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
  int n = 1;
  if (Q > 0)
    n += launch_quota(ckey, B, Q, 0, B, q_max, q_rule, quota_counts, qstate,
                      status, deny_rule, s);
  return launched(n);
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

// One dp replica's quota rank and commit over the gathered keys ckey int32
// [Q, B] (qstate uint8 [Q, B] scratch); status / deny_rule are the
// replica's own Bd rows, from global row row0. Returns the number of
// kernels launched, or -cudaError_t on failure.
extern "C" int mesh_quota(const int32_t* ckey, int B, int Q, int row0,
                          int Bd, const int32_t* q_max,
                          const int32_t* q_rule, int32_t* counts,
                          uint8_t* qstate, int32_t* status,
                          int32_t* deny_rule, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Q == 0) return 0;
  return launched(launch_quota(ckey, B, Q, row0, Bd, q_max, q_rule, counts,
                               qstate, status, deny_rule, s));
}
