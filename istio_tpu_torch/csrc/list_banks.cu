// list_banks — membership of the byte-level list banks: REGEX lists over
// the DFA acceptance of their patterns, and IP_ADDRESSES lists as CIDR
// prefix compares in v6-mapped space, in ONE launch for both banks.
//
// Replaces the JAX package's istio_tpu/models/policy_engine.py:439-502,
// the REGEX bank fold (the M / M_def int8 products after the DFA scan)
// and the CIDR compare of PolicyEngine.__init__.<locals>.step. Both banks
// write one state byte per (request row b, list position) into lstate
// [B, NL] (bit 0 member, bit 1 und, bit 2 bad), which the verdict_fold
// kernel reads for every REGEX / IP_ADDRESSES list in place of its id
// scan. One grid, split by block range: the first blocks take the REGEX
// (row, list) pairs, the rest the CIDR pairs; a bank with no list takes
// no block, and a step with neither launches nothing.
//
//   REGEX  a group of rx_lanes lanes per (b, REGEX list j). The list's
//      patterns are a CSR row (ptr / pat: columns of the DFA acceptance
//      plane acc [B, N], the dfa_scan kernel's output over every bank),
//      split over the lanes; each lane ORs hit = acc over its patterns and
//      dec = the same over its $-free ones (pdef), and warp votes over the
//      group combine them. trunc = the value's byte length >= max_len;
//      member = trunc ? dec : hit, und = trunc & !dec (a truncated value
//      whose match is not decided by a $-free prefix hit). Where und holds
//      the list's rule row of the err plane [B, R] is set to 1 in place,
//      as the reference's err.at[:, list_rule].max(und) does; lists may
//      share a rule, and an idempotent store of 1 is safe there.
//   CIDR   a group of c_lanes lanes per (b, CIDR list k). The entry tables
//      are built on the host (ops/bytes_ops.CidrLists.words) in 32-bit
//      words: each list's valid entries in CSR order, its v4 nets (as
//      ::ffff:a.b.c.d/96+len) in one run and its v6 nets in another. A
//      value is read as one 16-byte load where its address allows, else
//      byte by byte; length 4, or 16 with the ::ffff:0:0/96 prefix, is
//      v4, and its first 12 mapped bytes match every v4 entry, so a v4
//      value tests the v4 run with one masked word compare an entry; a
//      v6 value tests the v6 run with four. Membership is version-strict,
//      as `addr in net` is; a value whose length is neither 4 nor 16 is
//      bad (member false). The lanes stride over the run and stop at the
//      first round in which any lane hit (__any_sync over the group).
//
// What bounds it on an H100: neither bytes nor operations at the served
// sizes. It reads B·nnz acceptance bytes and B 16-byte values per list,
// the entry tables (a blocklist of a thousand nets is 8 KB of v4 words)
// from L1, and does one compare per (value, entry) up to the first hit:
// a launch and a chain of dependent loads per group. The lanes a pair
// (host plan, bytes_ops.list_plan) cut that chain for long lists: a
// thousand-entry blocklist is 32 rounds of a warp, not a 1,000-entry
// chain on one thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kMapped2 = 0xffff0000u;  // bytes 8..11 = 00 00 ff ff

struct RegexBank {
  const uint8_t* acc;
  int N, max_len, J;
  const int32_t *pos, *rule, *bslot, *ptr, *pat;
  const uint8_t* pdef;
  uint8_t* err;
  int R, lanes;
};

struct CidrBank {
  const uint8_t* bytes;
  long long sb_b, sb_s;
  int K;
  const int32_t *pos, *bslot, *v4_ptr, *v6_ptr;
  const uint2* v4;  // [N4] (mask, prefix) of word 3
  const uint4* v6;  // [N6, 2] (mask words, prefix words)
  int lanes;
};

// the lanes of this thread's group of `lanes` (a power of two <= 32)
__device__ __forceinline__ unsigned group_mask(int lanes) {
  if (lanes == 32) return kFull;
  const int lane = threadIdx.x & 31;
  return ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
}

__device__ void regex_pair(const RegexBank& x, int B,
                           const int32_t* str_lens, long long sl_b,
                           long long sl_s, uint8_t* lstate, int NL,
                           long long t) {
  const long long p = t / x.lanes;
  if (p >= (long long)B * x.J) return;  // the whole group
  const int gl = (int)(t % x.lanes);
  const unsigned gm = group_mask(x.lanes);
  const int b = (int)(p / x.J);
  const int j = (int)(p % x.J);
  const uint8_t* a_row = x.acc + (long long)b * x.N;
  bool hit = false, dec = false;
  const int i1 = __ldg(x.ptr + j + 1);
  for (int i = __ldg(x.ptr + j) + gl; i < i1; i += x.lanes) {
    const int c = __ldg(x.pat + i);
    if (a_row[c]) {
      hit = true;
      dec |= __ldg(x.pdef + c) != 0;
    }
  }
  hit = __any_sync(gm, hit);
  dec = __any_sync(gm, dec);
  if (gl != 0) return;
  const bool trunc =
      str_lens[b * sl_b + __ldg(x.bslot + j) * sl_s] >= x.max_len;
  const bool member = trunc ? dec : hit;
  const bool und = trunc && !dec;
  lstate[(long long)b * NL + __ldg(x.pos + j)] =
      (uint8_t)(member | (und << 1));
  if (und) x.err[(long long)b * x.R + __ldg(x.rule + j)] = 1;
}

// the value's first 16 bytes as 4 little-endian words
__device__ __forceinline__ uint4 value_words(const uint8_t* vb, int len) {
  if ((reinterpret_cast<uintptr_t>(vb) & 15) == 0)
    return *reinterpret_cast<const uint4*>(vb);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int n = len == 4 ? 4 : 16;
  for (int i = 0; i < n; ++i) w[i >> 2] |= (uint32_t)vb[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ void cidr_pair(const CidrBank& x, int B, const int32_t* str_lens,
                          long long sl_b, long long sl_s, uint8_t* lstate,
                          int NL, long long t) {
  const long long p = t / x.lanes;
  if (p >= (long long)B * x.K) return;  // the whole group
  const int gl = (int)(t % x.lanes);
  const unsigned gm = group_mask(x.lanes);
  const int b = (int)(p / x.K);
  const int k = (int)(p % x.K);
  const int slot = __ldg(x.bslot + k);
  const int32_t len = str_lens[b * sl_b + slot * sl_s];
  const bool ok = len == 4 || len == 16;
  bool member = false;
  if (ok) {
    const uint4 v = value_words(x.bytes + b * x.sb_b + slot * x.sb_s, len);
    // a length-4 value is its word 0, mapped to word 3
    const bool v4 = len == 4 || (v.x == 0u && v.y == 0u && v.z == kMapped2);
    const uint32_t w3 = len == 4 ? v.x : v.w;
    if (v4) {
      const int e1 = __ldg(x.v4_ptr + k + 1);
      for (int e0 = __ldg(x.v4_ptr + k); e0 < e1; e0 += x.lanes) {
        const int e = e0 + gl;
        bool hit = false;
        if (e < e1) {
          const uint2 mp = __ldg(x.v4 + e);
          hit = (w3 & mp.x) == mp.y;
        }
        if (__any_sync(gm, hit)) {
          member = true;
          break;
        }
      }
    } else {
      const int e1 = __ldg(x.v6_ptr + k + 1);
      for (int e0 = __ldg(x.v6_ptr + k); e0 < e1; e0 += x.lanes) {
        const int e = e0 + gl;
        bool hit = false;
        if (e < e1) {
          const uint4 m = __ldg(x.v6 + 2 * e), q = __ldg(x.v6 + 2 * e + 1);
          hit = (v.x & m.x) == q.x && (v.y & m.y) == q.y &&
                (v.z & m.z) == q.z && (v.w & m.w) == q.w;
        }
        if (__any_sync(gm, hit)) {
          member = true;
          break;
        }
      }
    }
  }
  if (gl == 0)
    lstate[(long long)b * NL + __ldg(x.pos + k)] =
        (uint8_t)(member | ((!ok) << 2));
}

__global__ void __launch_bounds__(kThreads)
    list_banks_kernel(RegexBank rx, CidrBank cidr, unsigned rx_blocks, int B,
                      const int32_t* __restrict__ str_lens, long long sl_b,
                      long long sl_s, uint8_t* __restrict__ lstate, int NL) {
  if (blockIdx.x < rx_blocks) {
    regex_pair(rx, B, str_lens, sl_b, sl_s, lstate, NL,
               (long long)blockIdx.x * kThreads + threadIdx.x);
  } else {
    cidr_pair(cidr, B, str_lens, sl_b, sl_s, lstate, NL,
              (long long)(blockIdx.x - rx_blocks) * kThreads + threadIdx.x);
  }
}

unsigned blocks_for(long long pairs, int lanes) {
  return (unsigned)((pairs * lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Both banks' state bytes of B rows in one launch → 1, 0 where neither
// bank has a list or B is 0, or -cudaError_t on failure. REGEX: J lists
// (pos, rule, bslot, ptr [J + 1], pat, pdef [N]) over acc [B, N], err
// [B, R]; CIDR: K lists (pos, bslot) over the byte plane (strides sb_b,
// sb_s, each value's 16 bytes readable), v4_ptr / v6_ptr [K + 1] into v4
// uint32 [N4, 2] and v6 uint32 [N6, 8]; rx_lanes / c_lanes: the lanes a
// pair, powers of two <= 32 (bytes_ops.list_plan).
extern "C" int list_banks(
    const uint8_t* acc, int N, int max_len, int J, const int32_t* rx_pos,
    const int32_t* rx_rule, const int32_t* rx_bslot, const int32_t* rx_ptr,
    const int32_t* rx_pat, const uint8_t* pdef, uint8_t* err, int R,
    int rx_lanes, const uint8_t* str_bytes, long long sb_b, long long sb_s,
    int K, const int32_t* c_pos, const int32_t* c_bslot,
    const int32_t* v4_ptr, const uint32_t* v4, const int32_t* v6_ptr,
    const uint32_t* v6, int c_lanes, int B, const int32_t* str_lens,
    long long sl_b, long long sl_s, uint8_t* lstate, int NL, void* stream) {
  const RegexBank rx{acc,    N,     max_len, J,   rx_pos, rx_rule, rx_bslot,
                     rx_ptr, rx_pat, pdef,   err, R,      rx_lanes};
  const CidrBank cidr{str_bytes, sb_b, sb_s, K, c_pos, c_bslot, v4_ptr,
                      v6_ptr,    reinterpret_cast<const uint2*>(v4),
                      reinterpret_cast<const uint4*>(v6), c_lanes};
  const unsigned rx_blocks = blocks_for((long long)B * J, rx_lanes);
  const unsigned c_blocks = blocks_for((long long)B * K, c_lanes);
  if (rx_blocks + c_blocks == 0) return 0;
  list_banks_kernel<<<rx_blocks + c_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rx, cidr, rx_blocks, B, str_lens, sl_b, sl_s, lstate, NL);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
