// rule_match — every rule's 3-valued match verdict for every request.
//
// Replaces the JAX package's istio_tpu/compiler/ruleset.py:798-860,
// compile_ruleset.<locals>.run, the rule-match part of the fused Check()
// step: the fused all-EQ gather-compare, the legacy literal plane (EQ,
// slot-EQ, then the ext columns from dfa_scan / byte_pred / atom_eval),
// the literal AND over each conjunction and the rule OR over conj_m_idx /
// conj_n_idx, err = ~matched & ~not_matched.
//
// Bit-sliced over requests: a group of 32 requests is one 32-bit word,
// bit i for request 32w + i. A literal, a conjunction and a rule are one
// word per 32 requests, so an AND or an OR does 32 requests' work in one
// integer operation and every index table is read once per word group,
// not once per request row. The host compile (compiler/ruleset.py
// word_tables) gives each distinct EQ compare (col, cid), slot pair and
// ext column ONE literal with an m word (value and present) and an n word
// (not value and present), and writes every conjunction as the literal
// words it ANDs (ascending, TRUE-padded; CONJ_FALSE and CONJ_TRUE are two
// more rows), in the reference's conjunction order, so conj_m_idx /
// conj_n_idx are read as the reference emits them. Two launches, one
// chain on the caller's stream, no atomics:
//
//   1. lit_words   grid (literal tiles of 2,048, request groups of
//      kWords words; 1,024 threads). Compares are looked up, not swept:
//      a request's value in a compare column equals at most one cid of
//      that column, so each lane (a request) looks (col, value) up in an
//      open-addressing table the compiler built (one 16-byte load a
//      probe), and the lanes that name the same literal
//      (__match_any_sync) form its m word, stored by the first of them
//      in shared memory: C lookups per request instead of one compare
//      per literal, and no two lanes write one word. A compare's n word
//      is its column's present word (a ballot) and not m. The tile's
//      first block also builds the slot pairs (a compare per lane, a
//      ballot) and the ext columns (the 64 rows of both planes staged in
//      shared memory by one coalesced copy, then a ballot per column).
//      Each literal's m / n words go to an L2-resident scratch
//      [groups][2Q + 2][kWords] (5.2 MB at 10,000 rules and B = 2,048:
//      10k literals, 64 words). Word 2Q is FALSE, 2Q + 1 TRUE.
//   2. rule_words  grid (rule tiles, request groups). A slot of TPR lanes
//      (1 to 8, chosen from the rules' conjunction count K) owns four
//      consecutive rules; each lane ANDs the literal words of its share
//      of their conjunctions (8-byte loads from the scratch, four
//      literals of eight conjunctions in flight) and ORs them into m
//      (conj_m_idx) and n (conj_n_idx, only when not_matched or err is
//      asked for); shuffles OR the slot's lanes. Then, request by
//      request, the four rules' bits as one 4-byte store (byte stores
//      when R is not a multiple of 4), err = ~m & ~n. Only the planes
//      whose pointer is not null are stored.
//
// Why an L2 scratch for literal words and no stored conjunction words: a
// literal is read by many conjunctions of many rule tiles, so it is
// computed once per request group and read from L2 (the scratch is
// under 50 MB up to ~1.5M literal-groups); a conjunction is referenced
// by 1.3 rules on average at 10,000 rules, so ANDing it where a rule
// reads it costs less than a third launch and a [n_conj, B/32] store.
//
// What bounds it on an H100: memory. The floor is the bool [B, R] planes
// it stores (two of 20.5 MB at B = 2,048, R = 10,008 on the served
// path), the ids / present / ext columns read once and the tables; the
// compares (one per distinct literal per request) and the word ANDs /
// ORs are a few µs of integer work. The design keeps the [B, n_conj]
// sat plane and the [B, 2·n_live+1] literal plane of the reference out
// of device memory altogether, and stores no plane the caller does not
// read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 2;               // request words per group
constexpr int kReq = 32 * kWords;       // requests per group
constexpr int kLitThreads = 1024;
constexpr int kLitsPerBlock = 2048;     // the literal tile a block writes
constexpr int kRuleThreads = 128;
constexpr int kRulesPerSlot = 4;        // consecutive rules of one slot
constexpr int kLitChunk = 4;            // conjunction literals in flight
constexpr int kMaxGridY = 65535;
// shared memory a stage-1 block may use (the card allows 227 KB)
constexpr size_t kSmemLimit = 200 * 1024;

// Home slot of (col, value) in the compare table: compiler/ruleset.py
// cmp_slot computes the same mix.
__device__ __forceinline__ uint32_t cmp_slot(int col, int32_t value,
                                             uint32_t mask) {
  uint32_t x = (uint32_t)value * 2654435761u;
  x ^= (uint32_t)col * 40503u;
  x ^= x >> 15;
  x *= 2246822519u;
  x ^= x >> 13;
  return x & mask;
}

// The compare literal q of (col, value), or -1: rows (col, cid, q, 0),
// q -1 for an empty slot, one 16-byte load a probe.
__device__ __forceinline__ int cmp_lookup(const int4* __restrict__ tab,
                                          uint32_t mask, int probe, int col,
                                          int32_t value) {
  uint32_t s = cmp_slot(col, value, mask);
  for (int d = 0; d < probe; ++d) {
    const int4 row = __ldg(tab + s);
    if (row.z < 0) return -1;
    if (row.x == col && row.y == value) return row.z;
    s = (s + 1) & mask;
  }
  return -1;
}

// Byte offset of the ext tile in a stage-1 block's shared memory: after
// the present and compare words, rounded up to 16 bytes.
__host__ __device__ __forceinline__ size_t ext_tile_offset(int C) {
  return (((size_t)C + kLitsPerBlock) * kWords * sizeof(uint32_t) + 15) &
         ~(size_t)15;
}

// Copy n bytes from global to shared memory with the whole block: 16
// bytes a load where both ends are 16-byte aligned (ext rows of a group
// start at a multiple of 64 rows), several loads in flight a thread.
__device__ __forceinline__ void stage_rows(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int n) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int t = threadIdx.x; t < n16; t += blockDim.x) d16[t] = s16[t];
    head = n16 * 16;
  }
  for (int t = head + threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

__global__ void __launch_bounds__(kLitThreads)
lit_words_kernel(const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ present, int B, int C,
                 const uint8_t* __restrict__ ext_m,
                 const uint8_t* __restrict__ ext_n, int X, int n_cmp,
                 int n_ss, const int32_t* __restrict__ lit_a,
                 const int32_t* __restrict__ lit_b, int n_cols,
                 const int32_t* __restrict__ cmp_cols, int hash_size,
                 const int32_t* __restrict__ cmp_hash, int probe,
                 int stage_ext, uint32_t* __restrict__ words) {
  extern __shared__ uint32_t smem[];
  uint32_t* pres_w = smem;                          // [C][kWords]
  uint32_t* hit = pres_w + (size_t)C * kWords;      // [tile cmps][kWords]
  // the first block's ext rows [kReq][X] of each plane, when staged
  uint8_t* ext_tile = reinterpret_cast<uint8_t*>(smem) +
                      ext_tile_offset(C);                // 16-byte aligned
  const int Q = n_cmp + n_ss + X;
  const int n_cs = n_cmp + n_ss;
  const long long group_words = 2LL * (Q + 1) * kWords;
  const int groups = (B + kReq - 1) / kReq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int q_lo = blockIdx.x * kLitsPerBlock;
  const int q_hi = min(Q + 1, q_lo + kLitsPerBlock);
  const int h_hi = min(n_cmp, q_hi);   // the tile's compares: [q_lo, h_hi)
  const uint32_t mask = (uint32_t)hash_size - 1;
  // the first block of a group writes the slot pairs and ext columns
  const int n_pair = blockIdx.x == 0 ? n_ss : 0;
  const int n_ext = blockIdx.x == 0 ? X : 0;
  // the columns of this thread's compares in the tile, read once
  static_assert(kLitsPerBlock == 2 * kLitThreads, "two literals a thread");
  static_assert(kWords == 2, "one 16-byte store per literal");
  int my_col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q_lo + threadIdx.x + h * kLitThreads;
    my_col[h] = q < n_cmp ? lit_a[q] : 0;
  }
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int b0 = g * kReq;
    const int nreq = min(kReq, B - b0);
    uint32_t* gwords = words + g * group_words;
    __syncthreads();  // the previous group's readers are done
    // ext columns: the rows are staged in shared memory (one coalesced
    // copy of both planes), then column x's own thread packs its words
    const uint8_t* em = ext_m + (long long)b0 * X;
    const uint8_t* en = ext_n + (long long)b0 * X;
    if (n_ext && stage_ext) {
      stage_rows(ext_tile, em, nreq * X);
      stage_rows(ext_tile + kReq * X, en, nreq * X);
      em = ext_tile;
      en = ext_tile + kReq * X;
    }
    for (int t = threadIdx.x; t < (h_hi - q_lo) * kWords; t += blockDim.x)
      hit[t] = 0u;
    for (int t = threadIdx.x; t < (h_hi - q_lo) * kWords; t += blockDim.x)
      hit[t] = 0u;
    // present word of every (column, request word): a ballot over lanes
    for (int pc = warp; pc < C * kWords; pc += n_warps) {
      const int c = pc / kWords, k = pc % kWords;
      const int b = b0 + 32 * k + lane;
      const bool v = b < B && present[(long long)b * C + c] != 0;
      const uint32_t w = __ballot_sync(0xffffffffu, v);
      if (lane == 0) pres_w[pc] = w;
    }
    __syncthreads();
    // ext column words: lane i reads request i's byte, a ballot per
    // plane and request word
#pragma unroll 4
    for (int t = warp; t < n_ext * kWords; t += n_warps) {
      const int x = t / kWords, k = t % kWords;
      const int i = 32 * k + lane;
      const bool live = i < nreq;
      const uint32_t wm = __ballot_sync(0xffffffffu,
                                        live && em[(long long)i * X + x]);
      const uint32_t wn = __ballot_sync(0xffffffffu,
                                        live && en[(long long)i * X + x]);
      if (lane == 0) {
        gwords[2LL * (n_cs + x) * kWords + k] = wm;
        gwords[(2LL * (n_cs + x) + 1) * kWords + k] = wn;
      }
    }
    // compares: each request's value in each compare column names at
    // most one literal; the lanes naming the same one form its m word,
    // written by the first of them (no two lanes write one word). Slot
    // pairs: lane i compares request i, a ballot makes the word.
#pragma unroll 2
    for (int t = warp; t < (n_cols + n_pair) * kWords; t += n_warps) {
      const int task = t / kWords, k = t % kWords;
      const long long b = b0 + 32 * k + lane;
      const bool live = b < B;
      if (task < n_cols) {
        const int col = cmp_cols[task];
        int q = -1;
        // present and the value in one round trip, then one probe
        const bool pres = live && present[b * C + col] != 0;
        const int32_t value = live ? ids[b * C + col] : 0;
        if (pres)
          q = cmp_lookup(reinterpret_cast<const int4*>(cmp_hash), mask,
                         probe, col, value);
        if (q < q_lo || q >= h_hi) q = -1;
        const uint32_t same = __match_any_sync(0xffffffffu, q);
        if (q >= 0 && lane == __ffs(same) - 1)
          hit[(q - q_lo) * kWords + k] = same;
        continue;
      }
      const int q = n_cmp + task - n_cols;
      const int ca = lit_a[q], cb = lit_b[q];
      const bool v = live && ids[b * C + ca] == ids[b * C + cb];
      const uint32_t e = __ballot_sync(0xffffffffu, v);
      const uint32_t p = pres_w[ca * kWords + k] & pres_w[cb * kWords + k];
      if (lane == 0) {
        gwords[2LL * q * kWords + k] = e & p;
        gwords[(2LL * q + 1) * kWords + k] = ~e & p;
      }
    }
    __syncthreads();
    // each thread finishes its compares (n = present and not m) and the
    // sentinel pair, word 2Q FALSE and 2Q + 1 TRUE
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q_lo + threadIdx.x + h * kLitThreads;
      if (q >= q_hi || (q >= n_cmp && q < Q)) continue;  // written above
      uint32_t m[kWords] = {0u, 0u}, n[kWords] = {~0u, ~0u};
      if (q < n_cmp) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          m[k] = hit[(q - q_lo) * kWords + k];
          n[k] = pres_w[my_col[h] * kWords + k] & ~m[k];
        }
      }
      *reinterpret_cast<uint4*>(gwords + 2LL * q * kWords) =
          make_uint4(m[0], m[1], n[0], n[1]);
    }
  }
}

// The AND of each conjunction c[j]'s literal words for one request
// group (all ones for none). kLitChunk literals of every conjunction
// are loaded before any of their words, so N * kLitChunk loads are in
// flight together; a CONJ_FALSE pad reads nothing and gives 0, a TRUE
// pad is skipped.
template <int N>
__device__ __forceinline__ void conj_words(
    const uint2* __restrict__ gw, const int32_t* __restrict__ conj_lit,
    int L, int conj_false, int lit_true, const int (&c)[N],
    uint2 (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc[j] = c[j] == conj_false ? make_uint2(0u, 0u) : make_uint2(~0u, ~0u);
  for (int l0 = 0; l0 < L; l0 += kLitChunk) {
    int li[N][kLitChunk];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < kLitChunk; ++u)
        li[j][u] = c[j] != conj_false && l0 + u < L
                       ? __ldg(conj_lit + (long long)c[j] * L + l0 + u)
                       : lit_true;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < kLitChunk; ++u)
        if (li[j][u] != lit_true) {
          const uint2 w = gw[li[j][u]];
          acc[j].x &= w.x;
          acc[j].y &= w.y;
        }
  }
}

// Request rows i = first, first + step, ... of one plane: the slot's
// four rules' bits as one 4-byte store where R allows it, else bytes.
__device__ __forceinline__ void store_plane(uint8_t* __restrict__ out,
                                            const uint2 (&w)[kRulesPerSlot],
                                            int b0, int nreq, int first,
                                            int step, int R, int r0,
                                            bool vec) {
  static_assert(kRulesPerSlot == 4, "one 4-byte store per request row");
  for (int i = first; i < nreq; i += step) {
    const int s = i & 31;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < kRulesPerSlot; ++j)
      packed |= (((i < 32 ? w[j].x : w[j].y) >> s) & 1u) << (8 * j);
    uint8_t* row = out + (long long)(b0 + i) * R + r0;
    if (vec) {
      *reinterpret_cast<uint32_t*>(row) = packed;
    } else {
#pragma unroll
      for (int j = 0; j < kRulesPerSlot; ++j)
        if (r0 + j < R) row[j] = (uint8_t)(packed >> (8 * j));
    }
  }
}

// A slot of TPR lanes owns four consecutive rules: lane sub takes their
// conjunctions k = sub, sub + TPR, ... (m from conj_m_idx, n from
// conj_n_idx when not_matched or err is asked for), the slot ORs its
// lanes' words with shuffles, then lane sub stores request rows sub,
// sub + TPR, ... of each plane asked for (err = ~m & ~n). More lanes per
// rule for more conjunctions per rule keeps every lane's chain of
// dependent loads short.
template <int TPR>
__global__ void __launch_bounds__(kRuleThreads)
rule_words_kernel(const uint32_t* __restrict__ words, int Q, int B, int R,
                  int K, int L, const int32_t* __restrict__ conj_lit,
                  int conj_false, const int32_t* __restrict__ conj_m_idx,
                  const int32_t* __restrict__ conj_n_idx,
                  uint8_t* __restrict__ matched,
                  uint8_t* __restrict__ not_matched,
                  uint8_t* __restrict__ err) {
  constexpr int N = 2 * kRulesPerSlot;   // m then n conjunctions
  const int lit_true = 2 * Q + 1;
  const long long group_words = 2LL * (Q + 1) * kWords;
  const int groups = (B + kReq - 1) / kReq;
  const int sub = threadIdx.x % TPR;
  const int r0 =
      (blockIdx.x * (kRuleThreads / TPR) + threadIdx.x / TPR) * kRulesPerSlot;
  const bool need_n = not_matched != nullptr || err != nullptr;
  const bool vec = (R % kRulesPerSlot) == 0;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const uint2* gw = reinterpret_cast<const uint2*>(words + g * group_words);
    uint2 acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = make_uint2(0u, 0u);
    for (int k = sub; k < K; k += TPR) {
      int c[N];
      uint2 w[N];
#pragma unroll
      for (int j = 0; j < kRulesPerSlot; ++j) {
        const bool in = r0 + j < R;
        const long long o = (long long)(r0 + j) * K + k;
        c[j] = in ? __ldg(conj_m_idx + o) : conj_false;
        c[kRulesPerSlot + j] =
            in && need_n ? __ldg(conj_n_idx + o) : conj_false;
      }
      conj_words(gw, conj_lit, L, conj_false, lit_true, c, w);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        acc[j].x |= w[j].x;
        acc[j].y |= w[j].y;
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        acc[j].x |= __shfl_xor_sync(0xffffffffu, acc[j].x, off);
        acc[j].y |= __shfl_xor_sync(0xffffffffu, acc[j].y, off);
      }
    if (r0 >= R) continue;
    uint2 m[kRulesPerSlot], n[kRulesPerSlot];
#pragma unroll
    for (int j = 0; j < kRulesPerSlot; ++j) {
      m[j] = acc[j];
      n[j] = acc[kRulesPerSlot + j];
    }
    const int b0 = g * kReq;
    const int nreq = min(kReq, B - b0);
    if (matched) store_plane(matched, m, b0, nreq, sub, TPR, R, r0, vec);
    if (not_matched)
      store_plane(not_matched, n, b0, nreq, sub, TPR, R, r0, vec);
    if (err) {
      uint2 e[kRulesPerSlot];
#pragma unroll
      for (int j = 0; j < kRulesPerSlot; ++j)
        e[j] = make_uint2(~m[j].x & ~n[j].x, ~m[j].y & ~n[j].y);
      store_plane(err, e, b0, nreq, sub, TPR, R, r0, vec);
    }
  }
}

template <int TPR>
void launch_rule_words(dim3 grid, cudaStream_t s, const uint32_t* words,
                       int Q, int B, int R, int K, int L,
                       const int32_t* conj_lit, int conj_false,
                       const int32_t* conj_m_idx, const int32_t* conj_n_idx,
                       uint8_t* matched, uint8_t* not_matched, uint8_t* err) {
  grid.x = (unsigned)((R + kRulesPerSlot * (kRuleThreads / TPR) - 1) /
                      (kRulesPerSlot * (kRuleThreads / TPR)));
  rule_words_kernel<TPR><<<grid, kRuleThreads, 0, s>>>(
      words, Q, B, R, K, L, conj_lit, conj_false, conj_m_idx, conj_n_idx,
      matched, not_matched, err);
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
// words: the literal-word scratch, ceil(B / kReq) * 2 * (Q + 1) * kWords
// uint32 (Q = n_cmp + n_ss + X). matched / not_matched / err may be null:
// that plane is not stored.
extern "C" int rule_match(
    const int32_t* ids, const uint8_t* present, int B, int C,
    const uint8_t* ext_m, const uint8_t* ext_n, int X,
    int n_cmp, int n_ss, const int32_t* lit_a, const int32_t* lit_b,
    int n_cols, const int32_t* cmp_cols, int hash_size,
    const int32_t* cmp_hash, int probe,
    int n_conj_rows, int L, const int32_t* conj_lit,
    int R, int K, const int32_t* conj_m_idx, const int32_t* conj_n_idx,
    uint32_t* words, uint8_t* matched, uint8_t* not_matched, uint8_t* err,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const int Q = n_cmp + n_ss + X;
  const int groups = (B + kReq - 1) / kReq;
  // shared memory: present words, the tile's compare words, and the
  // ext rows of both planes when they fit
  const size_t words_smem = ext_tile_offset(C);
  const size_t ext_smem = 2 * (size_t)kReq * X;
  const int stage_ext = words_smem + ext_smem <= kSmemLimit;
  const size_t smem = words_smem + (stage_ext ? ext_smem : 0);
  if (smem > kSmemLimit) return -(int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lit_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  const unsigned gy = (unsigned)(groups < kMaxGridY ? groups : kMaxGridY);
  const dim3 g1((unsigned)((Q + 1 + kLitsPerBlock - 1) / kLitsPerBlock), gy);
  lit_words_kernel<<<g1, kLitThreads, smem, s>>>(
      ids, present, B, C, ext_m, ext_n, X, n_cmp, n_ss, lit_a, lit_b, n_cols,
      cmp_cols, hash_size, cmp_hash, probe, stage_ext, words);
  // lanes per slot: up to two conjunctions a lane, up to 8 lanes
  const dim3 g2(1, gy);
  const int cf = n_conj_rows - 2;
  if (K <= 1)
    launch_rule_words<1>(g2, s, words, Q, B, R, K, L, conj_lit, cf,
                         conj_m_idx, conj_n_idx, matched, not_matched, err);
  else if (K <= 4)
    launch_rule_words<2>(g2, s, words, Q, B, R, K, L, conj_lit, cf,
                         conj_m_idx, conj_n_idx, matched, not_matched, err);
  else if (K <= 8)
    launch_rule_words<4>(g2, s, words, Q, B, R, K, L, conj_lit, cf,
                         conj_m_idx, conj_n_idx, matched, not_matched, err);
  else
    launch_rule_words<8>(g2, s, words, Q, B, R, K, L, conj_lit, cf,
                         conj_m_idx, conj_n_idx, matched, not_matched, err);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 2 : -(int)e;
}
