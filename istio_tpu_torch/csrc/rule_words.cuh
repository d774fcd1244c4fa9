// rule_words.cuh — one warp's walk of a request row of a [B, R] byte plane
// (matched, err) beside rule tables held as 32-rule bit words, shared by
// verdict_fold.cu and check_pack.cu.
//
// Table words are int32 lanes in pack_bits order: bit k of word w is rule
// 32w + k of the GLOBAL rule axis, ceil(R / 32) words a row. A row of the
// plane is read in 16-byte words, each of which becomes 16 rule bits; the
// table bits of the same 16 rules are a funnel shift of two table words,
// so a row may start at any byte address and its window at any rule r0 (a
// mesh shard's slice of the rule axis). The split of a row: single bytes
// up to the first 16-byte boundary (the head), 16-byte words (the body),
// single bytes after the last whole word (the tail).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace rule_words {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // 16-byte words a lane loads before it folds

// n bits (1 <= n <= 16) of the bit string W from bit g, in the low bits.
__device__ __forceinline__ uint32_t table_bits(const uint32_t* W, int g,
                                               int n) {
  const int w = g >> 5, sh = g & 31;
  const uint32_t lo = W[w];
  const uint32_t hi = sh + n > 32 ? W[w + 1] : 0u;
  return __funnelshift_r(lo, hi, sh) & ((1u << n) - 1u);
}

// 4 bits of 4 plane bytes: bit k set iff byte k is nonzero (any nonzero
// byte reads true, as in the plain versions). __vcmpne4 makes each
// nonzero byte 0xff; byte k keeps bit k, and the multiply sums the four
// bytes into the top one without a carry.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// 16 rule bits of one 16-byte word of a plane row (little-endian: byte k
// is the word's k-th rule).
__device__ __forceinline__ uint32_t nonzero16(uint4 q) {
  return nonzero4(q.x) | nonzero4(q.y) << 4 | nonzero4(q.z) << 8 |
         nonzero4(q.w) << 12;
}

// The head / body / tail split of a row of n bytes at p. The head and the
// tail are under 16 bytes each: lanes 0-15 take the head's bytes, lanes
// 16-31 the tail's, one byte a lane (single_byte).
struct RowSplit {
  int head, body, tail0;  // body: 16-byte words from byte head
  __device__ RowSplit(const uint8_t* p, int n) {
    head = min(n, (int)((16u - (unsigned)((uintptr_t)p & 15u)) & 15u));
    body = (n - head) >> 4;
    tail0 = head + (body << 4);
  }
  // this lane's single byte of the head or the tail, or -1
  __device__ int single_byte(int lane, int n) const {
    if (lane < 16) return lane < head ? lane : -1;
    const int j = tail0 + lane - 16;
    return j < n ? j : -1;
  }
};

// The row of a namespace table for request namespace ns: the index of ns
// in vis_ns [V], or V where it is none of them. Every lane of the warp
// calls it and gets the same row.
__device__ __forceinline__ int vis_row(const int32_t* vis_ns, int V,
                                       int32_t ns) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < V; k0 += 32) {
    const int k = k0 + lane;
    const unsigned hit = __ballot_sync(kFull, k < V && vis_ns[k] == ns);
    if (hit) return k0 + __ffs(hit) - 1;
  }
  return V;
}

}  // namespace rule_words
