// seq_match — one DFA over long strings as per-chunk transition maps.
//
// Replaces the JAX package's istio_tpu/parallel/seq_match.py:
// chunk_transition_map (:34), compose_maps (:61) and the per-device body
// of _runner (:80) under sharded_dfa_match (:118). A chunk of input
// induces a map f: S -> S ("enter the chunk in state s, leave in f[s]");
// maps compose, so each shard of a sequence-parallel mesh walks only its
// own chunks, for every entry state at once, and one gather of the small
// [B, S] shard maps plus a composition replaces a walk of the whole row.
// Two entry points, each one launch on the caller's stream:
//
//   chunk_map     the maps[c, b, s] of the chunk's local_len =
//      clip(lens[b] - (c0 + c) * Lc, 0, Lc) bytes from every entry state
//      s (a chunk past the row's end is the identity map). The launch
//      plan comes from the wrapper (parallel/seq_match.chunk_plan); a
//      block is kThreads (128) threads.
//      * S <= 32 (`regs`): one thread per (chunk, row, sub-chunk) walks
//        every entry state at once. Walks converge (Mytkowicz,
//        Musuvathi, Schulte, "Data-parallel finite-state machines",
//        ASPLOS 2014): after the first byte x they stand on the distinct
//        values of the table's column x, which each block works out for
//        all 256 columns while it stages the table, a thread a column
//        (`stage_columns`). Where those are at most kNarrow (8) — the
//        headline needle's pre- and post-match components, an anchored
//        pattern's dead state — the thread walks just them
//        (`NarrowWalk`: the live chains first, 2, 4 or 8 of them stepped
//        a byte with no predicate, independent of each other); else all
//        S walks in registers (`RegWalk`, kS = 8, 16 or 32). At a check
//        a narrow chain on an earlier chain's state merges into it, and a
//        walk on an absorbing state (every byte leads back to it: a dead
//        state) is not walked on; the thread stops when none is left.
//        A chunk longer than the plan's sub_len is split over `subs`
//        threads of one block whose maps the first composes in shared
//        memory; a block's maps go out a warp a map. The [S, 256]
//        table is read state-major from shared memory, tab[st * 256 +
//        byte]: the S-way conflict of walks that read one byte in lanes
//        side by side is gone, but the lanes of a warp walk different
//        rows, so bank conflicts are left that depend on the data. Two
//        lanes share a bank (byte mod 32) on different words wherever
//        their bytes are equal mod 32 and differ, or are equal with the
//        states different: lowercase letters alone never meet, but
//        digits and 'p'..'y', '-' and 'm', an upper- and lowercase pair,
//        or random bytes do (PERF.md §6 times random bytes beside
//        lowercase text).
//      * S > 32 (`lanes`): one thread per (chunk, row, entry state), the
//        table transposed byte-major ([256, S]) into shared memory while
//        it is staged, so that the walks of one (chunk, row), which read
//        the same byte, read consecutive words; tables over the 227 KB a
//        block may use are read through L1. A walk stops at an absorbing
//        state.
//      Subject bytes come in 16-byte loads of the aligned words that hold
//      them, one word ahead of the walk (`feed`): rows and chunks may
//      start at any address and Lc need not be a multiple of 16. Work
//      items are indexed in 32 bits (the wrapper refuses C * B *
//      max(S, subs) >= 2^31).
//   compose_maps  one warp per row b, 4 rows a block, folding the row's
//      maps LEFT TO RIGHT in chunk order, acc = maps[c, b, acc] (the JAX
//      package's take_along_axis(nxt, acc)), and writing out[b, s]; given
//      `accept`, accept[final] from entry state `entry`
//      (sharded_dfa_match's last gather, fused). For S <= 32 lane s holds
//      maps[c, b, s] of 8 chunks at a time, loaded together, and each
//      chunk is one shuffle, acc = shfl(m_c, acc); for more states the
//      row's maps are staged in shared memory slices of ~1,024 words and
//      the lanes fold one entry state each.
//
// What bounds it on an H100: neither bytes nor operations. Each walk is a
// dependent chain of table lookups (state -> next state), so the kernel
// is latency-bound. The function's work is one lookup a byte for each
// distinct live state a chunk's walks stand on (chip_smoke.chunk_map_work
// counts them for the bound; S a byte is what walks that never meet
// make); a narrow walk steps 2, 4 or 8 chains, a few more. The bytes it
// must move are the B * L subject bytes once, plus the C * B * S int32
// maps written and the table. At the headline's 16,384
// chunk walks a launch, one thread each, an SM holds 4 warps: the
// staging, the column tables and the map stores are latency the walks
// cannot hide (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // chunk_map: threads a block
constexpr int kComposeWarps = 4;
constexpr int kSliceWords = 1024;       // compose: words of maps a slice
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90
constexpr size_t kDefaultSmem = 49152;  // without cudaFuncSetAttribute
constexpr int kLaneBlocksPerSm = 2;     // lanes path: grid cap (table/block)
constexpr int kNarrow = 8;  // walks a thread follows one by one (NarrowWalk)
constexpr unsigned kFull = 0xffffffffu;

// The plan's path values (parallel/seq_match.py PATH_*).
constexpr int kPathLanesSmem = 0, kPathLanesL1 = -1;

__device__ __forceinline__ bool bit(const uint32_t* bits, int s) {
  return (bits[s >> 5] >> (s & 31)) & 1u;
}

// Stages the [S, 256] table into shared memory byte-major (tab[x * S + s]).
__device__ void stage_byte_major(const int32_t* __restrict__ trans, int S,
                                 int32_t* s_tab) {
  for (int i = threadIdx.x; i < S * 256; i += blockDim.x)
    s_tab[(i & 255) * S + (i >> 8)] = trans[i];
}

// absorb[s / 32] bit s: every byte leads state s back to s. One warp a
// state; `at(s, x)` reads the table. The words must be zero before.
template <class At>
__device__ void mark_absorbing(int S, At at, uint32_t* absorb) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int s = threadIdx.x >> 5; s < S; s += warps) {
    bool self = true;
    for (int x = lane; x < 256; x += 32) self &= at(s, x) == s;
    if (__all_sync(kFull, self) && lane == 0)
      atomicOr(absorb + (s >> 5), 1u << (s & 31));
  }
}

// Byte k (0..15) of a 16-byte word.
__device__ __forceinline__ uint32_t byte_at(uint4 q, int k) {
  const uint32_t w = k < 8 ? (k < 4 ? q.x : q.y) : (k < 12 ? q.z : q.w);
  return (w >> (8 * (k & 3))) & 255u;
}

// Feeds the n bytes at p to walker w, all in 16-byte loads of the aligned
// words that hold them (the next one loaded before the current one is
// walked): the head, the bytes up to the first 16-byte boundary (w.step),
// then whole words, then the tail. w.check() runs after the head, after
// every 4-byte word of the first whole word (w.word) and after every later
// whole word (w.block16); the walk stops, at the next head or tail byte or
// whole word, once w.done().
template <class W>
__device__ __forceinline__ void feed(const uint8_t* __restrict__ p, int n,
                                     W& w) {
  if (n <= 0) return;
  const int off = (int)(reinterpret_cast<uintptr_t>(p) & 15u);
  const uint4* q = reinterpret_cast<const uint4*>(p - off);
  const int head = min(n, (16 - off) & 15);
  const int words = (n - head) >> 4;
  const int tail = n - head - (words << 4);
  int k = 0;  // the aligned word next to load
  uint4 v = __ldg(q);
  if (head > 0) {
    const uint4 h = v;
    k = 1;
    if (words + (tail > 0) > 0) v = __ldg(q + 1);
    for (int i = 0; i < head && !w.done(); ++i) w.step(byte_at(h, off + i));
    w.check();
  }
  if (words > 0 && !w.done()) {
    const uint4 first = v;
    if (words > 1 || tail > 0) v = __ldg(q + k + 1);
    ++k;
    w.word(first.x);
    w.check();
    w.word(first.y);
    w.check();
    w.word(first.z);
    w.check();
    w.word(first.w);
    w.check();
    for (int m = 1; m < words && !w.done(); ++m) {
      const uint4 cur = v;
      if (m + 1 < words || tail > 0) v = __ldg(q + k + 1);
      ++k;
      w.block16(cur);
      w.check();
    }
  }
  for (int i = 0; i < tail && !w.done(); ++i) w.step(byte_at(v, i));
}

// The S <= kS walks of one thread, in registers: the fallback of the regs
// path for a first byte whose column holds more than kNarrow states. A
// walk on an absorbing state is not walked on.
template <int kS>
struct RegWalk {
  const int32_t* tab;  // [S, 256], shared memory
  uint32_t absorb;     // bit s: state s is absorbing
  int32_t st[kS];      // where entry state k's walk stands
  uint32_t live;       // walks not on an absorbing state
  bool fin;

  __device__ __forceinline__ void init(const int32_t* t, uint32_t a, int S) {
    tab = t;
    absorb = a;
    const uint32_t all = S >= 32 ? kFull : ((1u << S) - 1u);
#pragma unroll
    for (int k = 0; k < kS; ++k) st[k] = k;
    live = all & ~absorb;
    fin = live == 0u;
  }
  __device__ __forceinline__ bool done() const { return fin; }
  __device__ __forceinline__ void step(uint32_t byte) {
#pragma unroll
    for (int k = 0; k < kS; ++k)
      if ((live >> k) & 1u) st[k] = tab[st[k] * 256 + byte];
  }
  __device__ __forceinline__ void check() {
#pragma unroll
    for (int k = 0; k < kS; ++k)
      if ((absorb >> st[k]) & 1u) live &= ~(1u << k);
    fin = live == 0u;
  }
  __device__ __forceinline__ void word(uint32_t u) {
    step(u & 255u);
    step((u >> 8) & 255u);
    step((u >> 16) & 255u);
    step(u >> 24);
  }
  __device__ __forceinline__ void block16(uint4 q) {
    word(q.x);
    word(q.y);
    word(q.z);
    word(q.w);
  }
};

// Stages the [S, 256] table (S <= kS <= 32) into shared memory, one thread
// a column x (its S entries loaded together), and with it the column's
// first-byte tables: the distinct values of column x are where a walk's
// entry states stand after byte x. dist[x] is the number of distinct
// values (kNarrow + 1 for more), vals[2x], vals[2x + 1] the kNarrow lowest
// of them, 8 bits each in ascending order, idx[x * S + s] the slot of
// tab[s][x] among them; absorb (all ones before) is ANDed with the states
// the column leads back to themselves.
template <int kS>
__device__ void stage_columns(const int32_t* __restrict__ trans, int S,
                              int32_t* s_tab, uint8_t* dist, uint32_t* vals,
                              uint8_t* idx, uint32_t* absorb) {
  uint32_t self_all = kFull;
  for (int x = threadIdx.x; x < 256; x += blockDim.x) {
    int32_t col[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      col[s] = s < S ? __ldg(trans + s * 256 + x) : 0;
    uint32_t seen = 0u, self = 0u;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      if (s < S) {
        s_tab[s * 256 + x] = col[s];
        seen |= 1u << col[s];
        self |= (uint32_t)(col[s] == s) << s;
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (s < S)
        idx[x * S + s] = (uint8_t)__popc(seen & ((1u << col[s]) - 1u));
    uint32_t lo = 0u, hi = 0u, rest = seen;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      const uint32_t st = rest ? __ffs(rest) - 1 : 0;
      rest &= rest - 1u;
      if (j < 4) lo |= st << (8 * j); else hi |= st << (8 * (j - 4));
    }
    const int d = __popc(seen);
    dist[x] = (uint8_t)(d > kNarrow ? kNarrow + 1 : d);
    vals[2 * x] = lo;
    vals[2 * x + 1] = hi;
    self_all &= self;
  }
  self_all = __reduce_and_sync(kFull, self_all);
  if ((threadIdx.x & 31) == 0) atomicAnd(absorb, self_all);
}

// The walks of one thread after its first byte when they stand on at most
// kNarrow states, one chain a state in v[] (the first byte's column slot
// j starts on chain j): the live chains v[0 .. L) first, then the chains
// on absorbing states, v[L .. K). A check merges a chain into the lowest
// chain on the same state, moves chains that reached an absorbing state
// behind the live ones and renumbers them; pos holds each column slot's
// chain. A 16-byte word steps the first 2, 4 or 8 chains, whichever hold
// the live ones, with no predicate.
struct NarrowWalk {
  const int32_t* tab;  // [S, 256], shared memory
  uint32_t absorb;     // bit s: state s is absorbing
  int32_t v[kNarrow];  // chain states
  uint32_t pos;        // column slot j's chain: (pos >> 3j) & 7
  int L, K;
  bool fin;

  __device__ __forceinline__ void init(const int32_t* t, uint32_t a,
                                       uint32_t lo, uint32_t hi, int d) {
    tab = t;
    absorb = a;
    pos = 0u;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      v[j] = ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 255u;
      pos |= (uint32_t)j << (3 * j);
    }
    L = K = d;
    fin = false;
    check();
  }
  __device__ __forceinline__ bool done() const { return fin; }
  // kW chains stepped over the bytes of u, low byte first
  template <int kW, int kBytes>
  __device__ __forceinline__ void steps(uint32_t u) {
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      const uint32_t byte = (u >> (8 * i)) & 255u;
#pragma unroll
      for (int j = 0; j < kW; ++j) v[j] = tab[v[j] * 256 + byte];
    }
  }
  // the first 2, 4 or 8 chains, whichever hold the live ones
  template <int kBytes>
  __device__ __forceinline__ void stepw(uint32_t u) {
    if (L <= 2) steps<2, kBytes>(u);
    else if (L <= 4) steps<4, kBytes>(u);
    else steps<kNarrow, kBytes>(u);
  }
  __device__ __forceinline__ void step(uint32_t byte) { stepw<1>(byte); }
  __device__ __forceinline__ void word(uint32_t u) { stepw<4>(u); }
  __device__ __forceinline__ void block16(uint4 q) {
    if (L <= 2) {
      steps<2, 4>(q.x); steps<2, 4>(q.y); steps<2, 4>(q.z); steps<2, 4>(q.w);
    } else if (L <= 4) {
      steps<4, 4>(q.x); steps<4, 4>(q.y); steps<4, 4>(q.z); steps<4, 4>(q.w);
    } else {
      steps<kNarrow, 4>(q.x); steps<kNarrow, 4>(q.y);
      steps<kNarrow, 4>(q.z); steps<kNarrow, 4>(q.w);
    }
  }
  // K <= 2 chains: chain 1 merges into chain 0 on one state, and a live
  // chain 1 moves before an absorbed chain 0
  __device__ __forceinline__ void check2() {
    const bool merge = K == 2 && v[1] == v[0];
    if (merge) K = 1;
    const bool a0 = (absorb >> v[0]) & 1u;
    const bool a1 = K < 2 || ((absorb >> v[1]) & 1u);
    const bool swap = a0 && !a1;
    if (merge || swap) {
      uint32_t npos = 0u;
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) {
        uint32_t f = (pos >> (3 * j)) & 7u;
        if (merge && f == 1u) f = 0u;
        if (swap && f < 2u) f ^= 1u;
        npos |= f << (3 * j);
      }
      pos = npos;
      if (swap) {
        const int32_t t = v[0];
        v[0] = v[1];
        v[1] = t;
      }
    }
    L = (int)!a0 + (int)!a1;
    fin = L == 0;
  }
  __device__ __forceinline__ void check() {
    if (K <= 2) {
      check2();
      return;
    }
    // each chain's lowest twin (a chain on the same state)
    uint32_t tgt = 0u, twin = 0u;
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      uint32_t t = (uint32_t)c;
#pragma unroll
      for (int e = c - 1; e >= 0; --e) t = v[e] == v[c] ? (uint32_t)e : t;
      twin |= (uint32_t)(t != (uint32_t)c) << c;
      tgt |= t << (3 * c);
    }
    const uint32_t lead = ((1u << K) - 1u) & ~twin;
    uint32_t live = 0u;
#pragma unroll
    for (int c = 0; c < kNarrow; ++c)
      live |= (uint32_t)(((lead >> c) & 1u) && !((absorb >> v[c]) & 1u))
              << c;
    const int nl = __popc(live);
    if (lead == (1u << K) - 1u && live == (1u << L) - 1u) return;
    const uint32_t rest = lead & ~live;
    // each leading chain's new place: the live ones first, in order, then
    // the absorbed ones; a twin goes where its leader goes
    uint32_t np = 0u;
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      const uint32_t below = (1u << c) - 1u;
      const uint32_t place = ((live >> c) & 1u)
                                 ? (uint32_t)__popc(live & below)
                                 : (uint32_t)(nl + __popc(rest & below));
      np |= (place & 7u) << (3 * c);
    }
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      const uint32_t t = (tgt >> (3 * c)) & 7u;
      const uint32_t place = (np >> (3 * t)) & 7u;
      np = (np & ~(7u << (3 * c))) | (place << (3 * c));
    }
    int32_t nv[kNarrow];
#pragma unroll
    for (int t = 0; t < kNarrow; ++t) {
      nv[t] = v[t];
#pragma unroll
      for (int c = kNarrow - 1; c >= 0; --c)
        nv[t] = (((lead >> c) & 1u) && ((np >> (3 * c)) & 7u) == (uint32_t)t)
                    ? v[c] : nv[t];
    }
    uint32_t npos = 0u;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      const uint32_t c = (pos >> (3 * j)) & 7u;
      npos |= ((np >> (3 * c)) & 7u) << (3 * j);
    }
#pragma unroll
    for (int t = 0; t < kNarrow; ++t) v[t] = nv[t];
    pos = npos;
    L = nl;
    K = __popc(lead);
    fin = nl == 0;
  }
  // Every column slot's final state, 8 bits each: slots 0-3 in lo, 4-7 in
  // hi.
  __device__ __forceinline__ void finals(uint32_t& lo, uint32_t& hi) const {
    lo = hi = 0u;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      const uint32_t c = (pos >> (3 * j)) & 7u;
      int32_t f = v[0];
#pragma unroll
      for (int i = 1; i < kNarrow; ++i) f = c == (uint32_t)i ? v[i] : f;
      if (j < 4) lo |= ((uint32_t)f & 255u) << (8 * j);
      else hi |= ((uint32_t)f & 255u) << (8 * (j - 4));
    }
  }
};

// regs path: one thread per (chunk c, row b, sub-chunk j), j fastest. The
// first byte's column gives the walks' states; where they are at most
// kNarrow the thread walks those (NarrowWalk), else all S (RegWalk).
template <int kS>
__global__ void __launch_bounds__(kThreads) map_regs_kernel(
    const uint8_t* __restrict__ data, long long row_stride, int Lc,
    const int32_t* __restrict__ lens, int B, int C, int c0,
    const int32_t* __restrict__ trans, int S, int subs, int sub_len,
    int32_t* __restrict__ maps) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int nt = kThreads;
  uint32_t* s_absorb = reinterpret_cast<uint32_t*>(smem);  // 4 words
  uint32_t* s_vals = s_absorb + 4;                         // [2 * 256]
  int32_t* s_tab = smem + 4 + 512;                         // [S, 256]
  int32_t* s_map = s_tab + S * 256;  // [S, threads]: each thread's map
  uint8_t* s_idx = reinterpret_cast<uint8_t*>(s_map + S * nt);  // [256, S]
  uint8_t* s_dist = s_idx + 256 * S;                            // [256]
  // the work item's first byte is loaded before the table is staged, so
  // that its latency hides behind the staging
  const uint32_t t = blockIdx.x * nt + threadIdx.x;
  const uint32_t total = (uint32_t)C * (uint32_t)B * (uint32_t)subs;
  const bool on = t < total;
  const uint32_t g = t / (uint32_t)subs;  // (c, b)
  const int j = (int)(t - g * (uint32_t)subs);
  int32_t* col = s_map + threadIdx.x;
  int n = 0;
  const uint8_t* p = data;
  if (on) {
    const uint32_t c = g / (uint32_t)B;
    const uint32_t b = g - c * (uint32_t)B;
    const long long len = (long long)lens[b] - (long long)(c0 + (int)c) * Lc;
    const int nc = len < 0 ? 0 : (len > Lc ? Lc : (int)len);
    const int lo = min(nc, j * sub_len);
    n = min(nc, lo + sub_len) - lo;
    p = data + (long long)b * row_stride + (long long)c * Lc + lo;
  }
  const int x0 = n > 0 ? __ldg(p) : 0;
  if (threadIdx.x == 0) s_absorb[0] = S >= 32 ? kFull : (1u << S) - 1u;
  __syncthreads();
  stage_columns<kS>(trans, S, s_tab, s_dist, s_vals, s_idx, s_absorb);
  __syncthreads();
  const uint32_t absorb = s_absorb[0];
  const int d = s_dist[x0];
  if (n == 0) {  // the identity map
#pragma unroll
    for (int k = 0; k < kS; ++k)
      if (k < S) col[k * nt] = k;
  } else if (d <= kNarrow) {
    NarrowWalk w;
    w.init(s_tab, absorb, s_vals[2 * x0], s_vals[2 * x0 + 1], d);
    feed(p + 1, n - 1, w);
    uint32_t lo, hi;
    w.finals(lo, hi);
    const uint8_t* ix = s_idx + x0 * S;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      if (k < S) {
        const uint32_t slot = ix[k];
        col[k * nt] = ((slot < 4 ? lo : hi) >> (8 * (slot & 3u))) & 255u;
      }
    }
  } else {
    RegWalk<kS> w;
    w.init(s_tab, absorb, S);
    w.step(x0);
    w.check();
    feed(p + 1, n - 1, w);
#pragma unroll
    for (int k = 0; k < kS; ++k)
      if (k < S) col[k * nt] = w.st[k];
  }
  __syncthreads();
  if (subs > 1 && on && j == 0) {  // compose the group's sub-chunk maps
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      if (k < S) {
        int32_t a = col[k * nt];
        for (int i = 1; i < subs; ++i) a = col[a * nt + i];
        col[k * nt] = a;
      }
    }
  }
  if (subs > 1) __syncthreads();
  // the block's maps are contiguous in maps: a warp a map, a lane a state
  const uint32_t groups = nt / subs;
  const uint32_t g0 = blockIdx.x * groups;
  const uint32_t n_g = (uint32_t)C * (uint32_t)B;
  const uint32_t nv = g0 >= n_g ? 0u : min(groups, n_g - g0);
  const int lane = threadIdx.x & 31;
  for (uint32_t q = threadIdx.x >> 5; q < nv; q += nt >> 5)
    if (lane < S)
      maps[(g0 + q) * (uint32_t)S + lane] = s_map[lane * nt + q * subs];
}

// One walk of the lanes path; done on an absorbing state.
template <bool kSmem>
struct OneWalk {
  const int32_t* tab;  // byte-major [256, S] in shared memory, or the
                       // state-major global table
  const uint32_t* absorb;
  int S;
  int32_t x;
  bool fin;

  __device__ __forceinline__ bool done() const { return fin; }
  __device__ __forceinline__ void step(uint32_t byte) {
    x = kSmem ? tab[byte * S + x] : __ldg(tab + x * 256 + byte);
  }
  __device__ __forceinline__ void check() { fin = bit(absorb, x); }
  __device__ __forceinline__ void word(uint32_t u) {
    step(u & 255u);
    step((u >> 8) & 255u);
    step((u >> 16) & 255u);
    step(u >> 24);
  }
  __device__ __forceinline__ void block16(uint4 q) {
    word(q.x);
    word(q.y);
    word(q.z);
    word(q.w);
  }
};

// lanes path: one thread per (chunk c, row b, entry state s), s fastest;
// a grid of a few blocks an SM strides over the work (each block stages
// the table once).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads) map_lanes_kernel(
    const uint8_t* __restrict__ data, long long row_stride, int Lc,
    const int32_t* __restrict__ lens, int B, int C, int c0,
    const int32_t* __restrict__ trans, int S, int32_t* __restrict__ maps) {
  extern __shared__ __align__(16) int32_t smem[];
  const int aw = (S + 31) >> 5;
  uint32_t* s_absorb = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_tab = smem + ((aw + 3) & ~3);
  for (int i = threadIdx.x; i < aw; i += blockDim.x) s_absorb[i] = 0u;
  if (kSmem) stage_byte_major(trans, S, s_tab);
  __syncthreads();
  if (kSmem)
    mark_absorbing(S, [&](int s, int x) { return s_tab[x * S + s]; },
                   s_absorb);
  else
    mark_absorbing(S, [&](int s, int x) { return __ldg(trans + s * 256 + x); },
                   s_absorb);
  __syncthreads();
  const uint32_t total = (uint32_t)C * (uint32_t)B * (uint32_t)S;
  const uint32_t step = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += step) {
    const uint32_t g = t / (uint32_t)S;
    const int s = (int)(t - g * (uint32_t)S);
    const uint32_t c = g / (uint32_t)B;
    const uint32_t b = g - c * (uint32_t)B;
    const long long len = (long long)lens[b] - (long long)(c0 + (int)c) * Lc;
    const int n = len < 0 ? 0 : (len > Lc ? Lc : (int)len);
    OneWalk<kSmem> w{kSmem ? s_tab : trans, s_absorb, S, s, false};
    w.check();
    feed(data + (long long)b * row_stride + (long long)c * Lc, n, w);
    maps[t] = w.x;
  }
}

// One warp per row b, kComposeWarps rows a block; `accept` == nullptr ->
// out int32 [B, S], else out uint8 [B] = accept[composed[b, entry]].
// S <= 32: lane s holds maps[c, b, s] of kGroup chunks at a time (their
// loads issued together) and the fold is a shuffle a chunk, acc =
// shfl(m_c, acc). Larger S: the row's maps staged in shared memory slices
// of `slice` words, the lanes folding one entry state each.
constexpr int kGroup = 8;

__global__ void __launch_bounds__(32 * kComposeWarps) compose_kernel(
    const int32_t* __restrict__ maps, int C, int B, int S, int slice,
    const uint8_t* __restrict__ accept, int entry, void* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kComposeWarps + warp;
  if (b >= B) return;  // the whole warp
  const bool one = accept != nullptr;
  const uint32_t row = (uint32_t)B * (uint32_t)S;
  const int32_t* src = maps + (uint32_t)b * (uint32_t)S;
  if (S <= 32) {
    int32_t acc = lane;
    const bool in = lane < S;
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      int32_t m[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        m[i] = in && c0 + i < C ? __ldg(src + (uint32_t)(c0 + i) * row + lane)
                                : lane;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc = __shfl_sync(kFull, m[i], acc);
    }
    if (one) {
      const int32_t fin = __shfl_sync(kFull, acc, entry);
      if (lane == 0) static_cast<uint8_t*>(out)[b] = accept[fin] != 0;
    } else if (in) {
      static_cast<int32_t*>(out)[(uint32_t)b * (uint32_t)S + lane] = acc;
    }
    return;
  }
  int32_t* s_map = smem + warp * (slice + S);
  int32_t* acc = s_map + slice;
  const int n_acc = one ? 1 : S;
  for (int s = lane; s < n_acc; s += 32) acc[s] = one ? entry : s;
  const int per = slice / S;  // chunks a slice
  for (int c0 = 0; c0 < C; c0 += per) {
    const int n = min(per, C - c0);
    for (int i = 0; i < n; ++i)
      for (int s = lane; s < S; s += 32)
        s_map[i * S + s] = __ldg(src + (uint32_t)(c0 + i) * row + s);
    __syncwarp();
    for (int s = lane; s < n_acc; s += 32) {
      int32_t a = acc[s];
      for (int i = 0; i < n; ++i) a = s_map[i * S + a];
      acc[s] = a;
    }
    __syncwarp();
  }
  if (one) {
    if (lane == 0) static_cast<uint8_t*>(out)[b] = accept[acc[0]] != 0;
  } else {
    int32_t* o = static_cast<int32_t*>(out) + (uint32_t)b * (uint32_t)S;
    for (int s = lane; s < S; s += 32) o[s] = acc[s];
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Raises kernel's dynamic shared memory limit to `bytes` where it is over
// the default; → cudaSuccess or the error.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Shared memory of a regs-path block: the absorbing-state words, the
// column tables' values, the table, each thread's map column, and the
// column tables' slot bytes and counts (map_regs_kernel's layout).
size_t regs_smem(int S) {
  return (size_t)(4 + 512 + S * 256 + S * kThreads) * sizeof(int32_t) +
         (size_t)256 * S + 256;
}

template <int kS>
cudaError_t launch_regs(const uint8_t* data, long long row_stride, int Lc,
                        const int32_t* lens, int B, int C, int c0,
                        const int32_t* trans, int S, int subs, int sub_len,
                        int32_t* maps, cudaStream_t st) {
  const size_t smem = regs_smem(S);
  const cudaError_t e = allow_smem(map_regs_kernel<kS>, smem);
  if (e != cudaSuccess) return e;
  const long long total = (long long)C * B * subs;
  map_regs_kernel<kS><<<(unsigned)((total + kThreads - 1) / kThreads),
                        kThreads, smem, st>>>(data, row_stride, Lc, lens, B,
                                              C, c0, trans, S, subs, sub_len,
                                              maps);
  return cudaSuccess;
}

}  // namespace

// maps [C, B, S] int32 of the C chunks data[b, c0 + c, :Lc] (row b at
// data + b * row_stride, chunk c at + c * Lc) under the launch plan
// (path: kS = 8 / 16 / 32 for the regs path, 0 / -1 the lanes path with
// the table in shared memory / read through L1; subs sub-chunks of
// sub_len bytes a chunk). Returns the number of kernels launched (1), or
// -cudaError_t on failure.
extern "C" int chunk_map(const uint8_t* data, long long row_stride, int Lc,
                         const int32_t* lens, int B, int C, int c0,
                         const int32_t* trans, int S, int32_t* maps,
                         int path, int subs, int sub_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)C * B * S == 0) return 0;
  if (subs < 1 || kThreads % subs || sub_len < 1)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (path == 8 && S <= 8) {
    e = launch_regs<8>(data, row_stride, Lc, lens, B, C, c0, trans, S, subs,
                       sub_len, maps, st);
  } else if (path == 16 && S <= 16) {
    e = launch_regs<16>(data, row_stride, Lc, lens, B, C, c0, trans, S, subs,
                        sub_len, maps, st);
  } else if (path == 32 && S <= 32) {
    e = launch_regs<32>(data, row_stride, Lc, lens, B, C, c0, trans, S, subs,
                        sub_len, maps, st);
  } else if (path == kPathLanesSmem || path == kPathLanesL1) {
    const bool in_smem = path == kPathLanesSmem;
    const int aw = ((S + 31) / 32 + 3) & ~3;
    const size_t smem =
        (size_t)(aw + (in_smem ? S * 256 : 0)) * sizeof(int32_t);
    if (smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
    const long long total = (long long)C * B * S;
    long long blocks = (total + kThreads - 1) / kThreads;
    const long long cap = (long long)sm_count() * kLaneBlocksPerSm;
    if (blocks > cap) blocks = cap;
    if (in_smem) {
      e = allow_smem(map_lanes_kernel<true>, smem);
      if (e == cudaSuccess)
        map_lanes_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(
            data, row_stride, Lc, lens, B, C, c0, trans, S, maps);
    } else {
      map_lanes_kernel<false><<<(unsigned)blocks, kThreads, smem, st>>>(
          data, row_stride, Lc, lens, B, C, c0, trans, S, maps);
    }
  } else {
    return -(int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return -(int)e;
  e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

// Left-to-right composition of maps [C, B, S]: accept == nullptr -> out
// int32 [B, S]; else out uint8 [B] = accept[composed[b, entry]]. Returns
// the number of kernels launched (1), or -cudaError_t on failure.
extern "C" int compose_maps(const int32_t* maps, int C, int B, int S,
                            const uint8_t* accept, int entry, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return 0;
  const int slice = S > kSliceWords ? S : kSliceWords;
  const size_t smem =
      S <= 32 ? 0 : (size_t)kComposeWarps * (slice + S) * sizeof(int32_t);
  if (smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(compose_kernel, smem);
  if (e != cudaSuccess) return -(int)e;
  compose_kernel<<<(unsigned)((B + kComposeWarps - 1) / kComposeWarps),
                   32 * kComposeWarps, smem, st>>>(maps, C, B, S, slice,
                                                   accept, entry, out);
  e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
