// rule_match — every rule's 3-valued match verdict for every request.
//
// Replaces the JAX package's istio_tpu/compiler/ruleset.py:798-860,
// compile_ruleset.<locals>.run, the rule-match part of the fused Check()
// step. Three launches, one chain on the caller's stream:
//
//   1. lit_plane  (only when the snapshot has legacy conjunctions)
//      lit[b, :] = [m ‖ n ‖ TRUE], width 2·n_live+1. Columns of m / n in
//      the reference's order: eq-live EQ atoms ((ids[b,col]==cid)^neg,
//      masked by present), slot-vs-slot EQ atoms, then the X columns the
//      caller computed (DFA groups from dfa_scan, generic atoms incl. the
//      byte_pred groups), copied from ext_m / ext_n.
//   2. sat        sat[b, c] for c < n_sat: fused all-EQ conjunctions
//      (c < F) AND over their Lf literals ((ids[b,col]==cid)^xor)&present
//      | pad; legacy conjunctions AND over lit[b, lit_idx[c-F, :]]; then
//      the two sentinels sat[b, n_sat] = 0 (CONJ_FALSE, OR identity) and
//      sat[b, n_sat+1] = 1 (CONJ_TRUE, read by rule-axis padding rows).
//   3. rule_or    matched = OR over sat[b, conj_m_idx[r, :]], not_matched
//      likewise over conj_n_idx, err = ~matched & ~not_matched.
//
// What bounds it on an H100: memory. It does a few compares per output
// byte; what must move is the three bool [B, R] verdict planes it
// writes (61 MB at B=2048, R=10,000) plus the [B, n_conj] sat plane it
// writes and gathers back, and the index tables. The design: a 2-D grid
// with one block row per request row (blockIdx.y) and threads along the
// conjunction / rule axis, so the index tables are read coalesced and
// each block's row of ids / present / sat stays hot in L1; bools are
// bytes, written contiguously per row. Keeping sat out of device memory
// (one fused sat+OR kernel) and packing it to bits is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// One literal of the m / n blocks: m = value ∧ decided, n = ¬value ∧
// decided. ext columns arrive already as m / n.
__device__ __forceinline__ bool literal(
    const int32_t* row_ids, const uint8_t* row_pres, int a, bool is_n, int E,
    const int32_t* eq_cols, const int32_t* eq_cids, const uint8_t* eq_neg,
    int S, const int32_t* ss_a, const int32_t* ss_b, const uint8_t* ss_neg,
    int X, const uint8_t* ext_m_row, const uint8_t* ext_n_row) {
  bool val, ok;
  if (a < E) {
    const int col = eq_cols[a];
    val = (row_ids[col] == eq_cids[a]) != (eq_neg[a] != 0);
    ok = row_pres[col] != 0;
  } else if (a < E + S) {
    const int s = a - E;
    const int ca = ss_a[s], cb = ss_b[s];
    val = (row_ids[ca] == row_ids[cb]) != (ss_neg[s] != 0);
    ok = row_pres[ca] && row_pres[cb];
  } else if (a < E + S + X) {
    const int x = a - E - S;
    return (is_n ? ext_n_row[x] : ext_m_row[x]) != 0;
  } else {
    return false;  // the empty literal block of an atom-less snapshot
  }
  return ok && (is_n ? !val : val);
}

__global__ void lit_plane_kernel(const int32_t* __restrict__ ids,
                                 const uint8_t* __restrict__ present, int B,
                                 int C, int E,
                                 const int32_t* __restrict__ eq_cols,
                                 const int32_t* __restrict__ eq_cids,
                                 const uint8_t* __restrict__ eq_neg, int S,
                                 const int32_t* __restrict__ ss_a,
                                 const int32_t* __restrict__ ss_b,
                                 const uint8_t* __restrict__ ss_neg, int X,
                                 const uint8_t* __restrict__ ext_m,
                                 const uint8_t* __restrict__ ext_n,
                                 int n_live, uint8_t* __restrict__ lit) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int width = 2 * n_live + 1;
  if (j >= width) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    bool v = true;  // column 2·n_live is LIT_TRUE, the AND identity
    if (j < 2 * n_live) {
      const bool is_n = j >= n_live;
      v = literal(ids + (long long)b * C, present + (long long)b * C,
                  is_n ? j - n_live : j, is_n, E, eq_cols, eq_cids, eq_neg,
                  S, ss_a, ss_b, ss_neg, X, ext_m + (long long)b * X,
                  ext_n + (long long)b * X);
    }
    lit[(long long)b * width + j] = v ? 1 : 0;
  }
}

__global__ void sat_kernel(const int32_t* __restrict__ ids,
                           const uint8_t* __restrict__ present, int B, int C,
                           int F, int Lf, const int32_t* __restrict__ eqc_col,
                           const int32_t* __restrict__ eqc_cid,
                           const uint8_t* __restrict__ eqc_xor,
                           const uint8_t* __restrict__ eqc_pad, int NL,
                           int Ll, const int32_t* __restrict__ lit_idx,
                           const uint8_t* __restrict__ lit, int lit_w,
                           int n_sat, uint8_t* __restrict__ sat) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int width = n_sat + 2;
  if (c >= width) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    bool v;
    if (c == n_sat) {
      v = false;  // CONJ_FALSE
    } else if (c == n_sat + 1) {
      v = true;   // CONJ_TRUE
    } else if (c < F) {
      const int32_t* row_ids = ids + (long long)b * C;
      const uint8_t* row_pres = present + (long long)b * C;
      v = true;
      const long long base = (long long)c * Lf;
      for (int s = 0; v && s < Lf; ++s) {
        if (eqc_pad[base + s]) continue;
        const int col = eqc_col[base + s];
        const bool eq = row_ids[col] == eqc_cid[base + s];
        v = (eq != (eqc_xor[base + s] != 0)) && row_pres[col];
      }
    } else {
      const int jj = c - F;  // legacy conjunction row (< NL)
      const uint8_t* row_lit = lit + (long long)b * lit_w;
      v = true;
      const long long base = (long long)jj * Ll;
      for (int s = 0; v && s < Ll; ++s) v = row_lit[lit_idx[base + s]] != 0;
    }
    sat[(long long)b * width + c] = v ? 1 : 0;
  }
}

__global__ void rule_or_kernel(const uint8_t* __restrict__ sat, int B,
                               int sat_w, int R, int K,
                               const int32_t* __restrict__ conj_m_idx,
                               const int32_t* __restrict__ conj_n_idx,
                               uint8_t* __restrict__ matched,
                               uint8_t* __restrict__ not_matched,
                               uint8_t* __restrict__ err) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long base = (long long)r * K;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* row = sat + (long long)b * sat_w;
    bool m = false, n = false;
    for (int k = 0; k < K; ++k) {
      m = m || row[conj_m_idx[base + k]];
      n = n || row[conj_n_idx[base + k]];
    }
    const long long o = (long long)b * R + r;
    matched[o] = m ? 1 : 0;
    not_matched[o] = n ? 1 : 0;
    err[o] = (!m && !n) ? 1 : 0;
  }
}

inline dim3 grid_for(long long cols, int B) {
  return dim3((unsigned)((cols + kThreads - 1) / kThreads),
              (unsigned)(B < kMaxGridY ? B : kMaxGridY));
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int rule_match(
    const int32_t* ids, const uint8_t* present, int B, int C,
    // fused all-EQ conjunctions
    int F, int Lf, const int32_t* eqc_col, const int32_t* eqc_cid,
    const uint8_t* eqc_xor, const uint8_t* eqc_pad,
    // legacy literal plane
    int use_legacy, int E, const int32_t* eq_cols, const int32_t* eq_cids,
    const uint8_t* eq_neg, int S, const int32_t* ss_a, const int32_t* ss_b,
    const uint8_t* ss_neg, int X, const uint8_t* ext_m, const uint8_t* ext_n,
    int n_live, int NL, int Ll, const int32_t* lit_idx, uint8_t* lit,
    // conjunctions and rules
    int n_sat, uint8_t* sat, int R, int K, const int32_t* conj_m_idx,
    const int32_t* conj_n_idx, uint8_t* matched, uint8_t* not_matched,
    uint8_t* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const int lit_w = 2 * n_live + 1;
  int n = 1;
  if (use_legacy) {
    ++n;
    lit_plane_kernel<<<grid_for(lit_w, B), kThreads, 0, s>>>(
        ids, present, B, C, E, eq_cols, eq_cids, eq_neg, S, ss_a, ss_b,
        ss_neg, X, ext_m, ext_n, n_live, lit);
  } else {
    NL = 0;
  }
  sat_kernel<<<grid_for(n_sat + 2, B), kThreads, 0, s>>>(
      ids, present, B, C, F, Lf, eqc_col, eqc_cid, eqc_xor, eqc_pad, NL, Ll,
      lit_idx, lit, lit_w, n_sat, sat);
  if (R > 0) {
    ++n;
    rule_or_kernel<<<grid_for(R, B), kThreads, 0, s>>>(
        sat, B, n_sat + 2, R, K, conj_m_idx, conj_n_idx, matched,
        not_matched, err);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
}
