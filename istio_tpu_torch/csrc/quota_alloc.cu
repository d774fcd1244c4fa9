// quota_alloc — memquota's rolling-window allocation for one batch of quota
// rows against the pool's resident counter plane, in place.
//
// Replaces the JAX package's istio_tpu/models/quota_alloc.py:
// make_alloc_step (:48-114, fixed counters: K = 1, no row rolling) and
// make_rolling_alloc_step (:134-337) — _roll_and_used (:162), _commit
// (:173), step (the sequential scan, :195), step_fast (:177), step_unit
// (:313) and step_seg (:230, with seg_scan :117) — and, with the gate
// inputs, the in-step alloc of runtime/fused.py:467-492 (packq), which runs
// step_seg inside the check trip with its amounts gated on the device's
// own verdict.
//
// State: slots int32 [n_buckets, K], updated in place. Per row b < B (all
// int32; flags are 0 / non-zero): bucket, amount, best_effort, max,
// active, tick, last, rolling. Outputs: granted[b], and gate[b] when the
// gate inputs are given. Every row of the batch, in every mode:
//
//   roll   (active & rolling): delta = clip(tick - last, 0, K); slot p of
//          the row's bucket is zeroed when ((p - last - 1) mod K) < delta
//          (floor modulo, int32 wrap, as jnp computes it);
//   used   = the sum of the bucket's K slots after every roll of the batch;
//   grant  memquota.go:118 alloc under the mode's order (below);
//   commit slot (rolling ? tick mod K : 0) += granted.
//
// Modes (the caller picks one per batch, as runtime/device_quota.py
// does):
//   0 scan  sequential oracle: rows in (bucket, row index) order, one
//           thread walks each bucket run with a consumed carry;
//   1 fast  every active bucket at most once in the batch: elementwise,
//           one thread per row, many blocks;
//   2 unit  every active amount is 1: grant iff the row's stable rank
//           within its bucket run is < max - used;
//   3 seg   contended mixed amounts: rows in (bucket, all-or-nothing before
//           best-effort, amount clamped to [0, DOMAIN_MAX], row index)
//           order; all-or-nothing rows grant while their segmented amount
//           cumsum stays <= avail (over-domain rows denied and left out of
//           the cumsum), best-effort rows take what is left after the
//           running max of the granted all-or-nothing cumsum, every
//           intermediate clamped at 0 before a subtraction.
// All arithmetic is int32 with two's-complement wrap, as the reference's
// (jax runs without x64). Rows whose bucket lies outside [0, n_buckets)
// are treated as inactive (the caller's contract excludes them; the guard
// only keeps the kernel inside the plane).
//
// Gate (in-step): gate = active & rule_idx >= 0 & ns_ok & status == 0 &
// matched[b, clip(rule_idx, 0, R-1)], ns_ok = rule_ns[rule] == default_ns
// | rule_ns[rule] == req_ns[b]. A gated-off row keeps its roll and
// allocates amount 0.
//
// What bounds it on an H100: neither bytes nor operations. A batch is a
// few thousand rows (tens of thousands at most) touching as many 40-byte
// counter rows, a few microseconds of memory traffic at most; the
// contended modes are a chain of dependent steps (sort, three segmented
// scans), in one block or in one launch per step. The
// design: fast is one thread per row. The contended modes run in ONE
// block of 1024 threads with every row in shared memory: a bitonic sort
// of (64-bit key, row index) pairs (the index breaks ties, so the order is
// the reference's stable lexsort), block-wide segmented scans (a
// sequential pass over each thread's chunk, a Hillis-Steele scan of the
// chunk totals, a fix-up pass), and __syncthreads between the roll, the
// reads of `used` and the commits, so each bucket is rolled before any
// row reads it and read before any row commits to it. Duplicate rolls
// write the same zeros (the reference's idempotent multiply-scatter);
// commits are integer atomics, which commute. That one block holds up to
// 8,192 rows (26 bytes per row at the next power of two, in the 227 KB
// of shared memory a block may use).
//
// Above 8,192 rows the contended modes run on many blocks, with their
// state in a global scratch buffer the wrapper allocates
// (quota_alloc_scratch_bytes) and kernel boundaries in place of the
// __syncthreads: one launch gates, rolls and keys every row; a bitonic
// sort of the power-of-two padded (key, row) pairs runs the steps whose
// stride is at least kSortTile as global compare-exchange launches and
// every other step inside kSortTile-element tiles in shared memory; a
// segmented scan runs per kScanTile tile (the one-block scan), then one
// thread chains the tile carries (each with its "a segment began here"
// flag, so a bucket run that spans several tiles carries its sum or
// running max across every seam), then the tiles' leading runs are
// fixed up; the grant, scan-walk (one thread per bucket run) and commit
// steps are one launch each, one thread per sorted position.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // the contended modes' one block
constexpr int kFastThreads = 256;
constexpr int kMaxRows = 8192;    // the one-block path's limit
constexpr int kSortTile = 2048;   // multi-block sort: elements per tile
constexpr int kScanTile = 4096;   // multi-block scan: elements per tile
constexpr int32_t kDomainMax = 1 << 21;
enum Mode { kScan = 0, kFast = 1, kUnit = 2, kSeg = 3 };

struct Args {
  int32_t* slots;
  int n_buckets, K;
  const int32_t *buckets, *amounts, *be, *mx, *active, *ticks, *lasts,
      *rolling;
  int B;
  // gate (status == nullptr: no gate)
  const int32_t* status;
  const uint8_t* matched;
  int R;
  const int32_t *rule_idx, *rule_ns, *req_ns;
  int default_ns;
  int32_t* granted;
  int32_t* gate_out;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int floor_mod(int32_t x, int K) {
  const int r = x % K;
  return r < 0 ? r + K : r;
}

// active and inside the plane
__device__ __forceinline__ bool live(const Args& a, int r) {
  const int32_t b = a.buckets[r];
  return a.active[r] != 0 && b >= 0 && b < a.n_buckets;
}

// the amount the row allocates: gated to 0 in-step; writes gate_out
__device__ __forceinline__ int32_t gated_amount(const Args& a, int r) {
  if (a.status == nullptr) return a.amounts[r];
  bool g = false;
  if (a.active[r] != 0 && a.R > 0) {
    const int ri = a.rule_idx[r];
    const int rule = ri < 0 ? 0 : (ri >= a.R ? a.R - 1 : ri);
    const int rn = a.rule_ns[rule];
    const bool ns_ok = rn == a.default_ns || rn == a.req_ns[r];
    g = ri >= 0 && ns_ok && a.status[r] == 0 &&
        a.matched[(long long)r * a.R + rule] != 0;
  }
  a.gate_out[r] = g ? 1 : 0;
  return g ? a.amounts[r] : 0;
}

__device__ __forceinline__ void roll(const Args& a, int r) {
  if (a.rolling[r] == 0) return;
  const int32_t last = a.lasts[r];
  int32_t delta = wsub(a.ticks[r], last);
  delta = delta < 0 ? 0 : (delta > a.K ? a.K : delta);
  if (delta == 0) return;
  int32_t* row = a.slots + (long long)a.buckets[r] * a.K;
  for (int p = 0; p < a.K; ++p)
    if (floor_mod(wsub(wsub(p, last), 1), a.K) < delta) row[p] = 0;
}

__device__ __forceinline__ int32_t used_of(const Args& a, int r) {
  const int32_t* row = a.slots + (long long)a.buckets[r] * a.K;
  int32_t used = 0;
  for (int p = 0; p < a.K; ++p) used = wadd(used, row[p]);
  return used;
}

__device__ __forceinline__ int32_t avail_of(const Args& a, int r) {
  return wsub(a.mx[r], used_of(a, r));
}

__device__ __forceinline__ void commit(const Args& a, int r, int32_t g) {
  if (g == 0) return;
  const int col = a.rolling[r] != 0 ? floor_mod(a.ticks[r], a.K) : 0;
  atomicAdd(a.slots + (long long)a.buckets[r] * a.K + col, g);
}

// memquota alloc of one row against `avail` (scan and fast)
__device__ __forceinline__ int32_t alloc_one(bool best_effort, int32_t amt,
                                             int32_t avail) {
  if (best_effort) {
    const int32_t m = amt < avail ? amt : avail;
    return m < 0 ? 0 : m;
  }
  return (avail >= amt && amt > 0) ? amt : 0;
}

__global__ void __launch_bounds__(kFastThreads) fast_kernel(Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.B) return;
  const int32_t amt = gated_amount(a, r);
  int32_t g = 0;
  if (live(a, r)) {
    roll(a, r);
    g = alloc_one(a.be[r] != 0, amt, avail_of(a, r));
    commit(a, r, g);
  }
  a.granted[r] = g;
}

template <bool kMax>
__device__ __forceinline__ int32_t scan_op(int32_t x, int32_t y) {
  return kMax ? (x > y ? x : y) : wadd(x, y);
}

// Inclusive segmented scan of v[0, n) in place (f[i] != 0 starts a
// segment; f == nullptr: one segment). Each thread owns a contiguous
// chunk; t_v / t_f hold one entry per thread.
template <bool kMax>
__device__ void block_scan(int32_t* v, const uint8_t* f, int n, int32_t* t_v,
                           uint8_t* t_f) {
  const int T = blockDim.x, t = threadIdx.x;
  const int per = (n + T - 1) / T;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int32_t acc = 0;
  uint8_t any = 0;
  for (int i = lo; i < hi; ++i) {
    const uint8_t fi = f != nullptr ? f[i] : 0;
    acc = (i == lo || fi) ? v[i] : scan_op<kMax>(acc, v[i]);
    any |= fi;
    v[i] = acc;
  }
  t_v[t] = acc;
  t_f[t] = any;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    int32_t pv = 0;
    uint8_t pf = 0;
    if (t >= off) {
      pv = t_v[t - off];
      pf = t_f[t - off];
    }
    __syncthreads();
    if (t >= off) {
      if (!t_f[t]) t_v[t] = scan_op<kMax>(pv, t_v[t]);
      t_f[t] |= pf;
    }
    __syncthreads();
  }
  if (t > 0 && lo < hi) {
    const int32_t pre = t_v[t - 1];
    for (int i = lo; i < hi; ++i) {
      if (f != nullptr && f[i]) break;
      v[i] = scan_op<kMax>(pre, v[i]);
    }
  }
  __syncthreads();
}

// ascending (key, idx); every pair is distinct, so the order is total
__device__ void bitonic_sort(uint64_t* key, uint32_t* idx, int n) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int l = i ^ j;
        if (l <= i) continue;
        const uint64_t ki = key[i], kl = key[l];
        const uint32_t ii = idx[i], il = idx[l];
        const bool gt = ki > kl || (ki == kl && ii > il);
        if (gt == ((i & k) == 0)) {
          key[i] = kl;
          key[l] = ki;
          idx[i] = il;
          idx[l] = ii;
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads) contended_kernel(Args a, int mode,
                                                             int n_pad) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_key = smem;
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_key + n_pad);
  int32_t* s_amt = reinterpret_cast<int32_t*>(s_idx + n_pad);  // by row
  int32_t* s_v1 = s_amt + n_pad;                               // by position
  int32_t* s_v2 = s_v1 + n_pad;
  int32_t* t_v = s_v2 + n_pad;
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(t_v + blockDim.x);
  uint8_t* s_grant = s_seg + n_pad;
  uint8_t* t_f = s_grant + n_pad;
  const int B = a.B, T = blockDim.x, t = threadIdx.x;

  // gate, roll and sort key of every row; pads sort after every row
  for (int r = t; r < n_pad; r += T) {
    if (r >= B) {
      s_key[r] = ~0ull;
      s_idx[r] = 0xffffffffu;
      continue;
    }
    const int32_t amt = gated_amount(a, r);
    s_amt[r] = amt;
    const bool act = live(a, r);
    if (act) roll(a, r);
    // key_bucket = active ? bucket : INT32_MAX, as an unsigned order
    const uint32_t kb = act ? ((uint32_t)a.buckets[r] ^ 0x80000000u)
                            : 0xffffffffu;
    uint32_t lo = 0;
    if (mode == kSeg) {
      const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
      lo = ((a.be[r] != 0 ? 1u : 0u) << 22) | (uint32_t)a_pos;
    }
    s_key[r] = ((uint64_t)kb << 32) | lo;
    s_idx[r] = (uint32_t)r;
  }
  __syncthreads();  // every roll done: `used` is final from here on
  bitonic_sort(s_key, s_idx, n_pad);
  for (int q = t; q < B; q += T)
    s_seg[q] = q == 0 || (s_key[q] >> 32) != (s_key[q - 1] >> 32);
  __syncthreads();

  if (mode == kUnit) {
    for (int q = t; q < B; q += T) s_v1[q] = s_seg[q] ? q : 0;
    __syncthreads();
    block_scan<true>(s_v1, nullptr, B, t_v, t_f);  // run start
    for (int q = t; q < B; q += T) {
      const int r = s_idx[q];
      int32_t g = 0;
      if (live(a, r)) g = (q - s_v1[q]) < avail_of(a, r) ? 1 : 0;
      a.granted[r] = g;
      s_v2[q] = g;
    }
    __syncthreads();  // every read of `used` done before any commit
    for (int q = t; q < B; q += T) commit(a, s_idx[q], s_v2[q]);
    return;
  }

  if (mode == kScan) {
    for (int q = t; q < B; q += T) {
      const int r0 = s_idx[q];
      if (!live(a, r0)) {  // inactive rows sort into their own run
        a.granted[r0] = 0;
        s_v1[q] = 0;
        continue;
      }
      if (!s_seg[q]) continue;
      const int32_t used = used_of(a, r0);  // the run shares a bucket
      int32_t consumed = 0;
      for (int z = q; z < B && (z == q || !s_seg[z]); ++z) {
        const int r = s_idx[z];
        const int32_t g = alloc_one(a.be[r] != 0, s_amt[r],
                                    wsub(wsub(a.mx[r], used), consumed));
        consumed = wadd(consumed, g);
        a.granted[r] = g;
        s_v1[z] = g;
      }
    }
    __syncthreads();
    for (int q = t; q < B; q += T) commit(a, s_idx[q], s_v1[q]);
    return;
  }

  // kSeg. v1 = all-or-nothing amounts -> cum_ao
  for (int q = t; q < B; q += T) {
    const int r = s_idx[q];
    const int32_t amt = s_amt[r];
    const bool ao = live(a, r) && a.be[r] == 0 && amt <= kDomainMax;
    s_v1[q] = ao ? (amt < 0 ? 0 : amt) : 0;
  }
  __syncthreads();
  block_scan<false>(s_v1, s_seg, B, t_v, t_f);
  // grant_ao; v2 = granted cum_ao -> consumed_ao (segmented running max)
  for (int q = t; q < B; q += T) {
    const int r = s_idx[q];
    const int32_t amt = s_amt[r];
    const bool g = live(a, r) && a.be[r] == 0 && amt <= kDomainMax &&
                   amt > 0 && s_v1[q] <= avail_of(a, r);
    s_grant[q] = g;
    s_v2[q] = g ? s_v1[q] : 0;
  }
  __syncthreads();
  block_scan<true>(s_v2, s_seg, B, t_v, t_f);
  // v1 = best-effort amounts -> their inclusive cumsum
  for (int q = t; q < B; q += T) {
    const int r = s_idx[q];
    const int32_t amt = s_amt[r];
    const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
    s_v1[q] = (live(a, r) && a.be[r] != 0) ? a_pos : 0;
  }
  __syncthreads();
  block_scan<false>(s_v1, s_seg, B, t_v, t_f);
  for (int q = t; q < B; q += T) {
    const int r = s_idx[q];
    const int32_t amt = s_amt[r];
    const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
    int32_t g = 0;
    if (s_grant[q]) {
      g = a_pos;
    } else if (live(a, r) && a.be[r] != 0) {
      const int32_t before = wsub(s_v1[q], a_pos);
      int32_t av = avail_of(a, r);
      av = av < 0 ? 0 : av;
      int32_t rem = wsub(av, s_v2[q]);
      rem = rem < 0 ? 0 : rem;
      const int32_t left = wsub(rem, before);
      g = a_pos < left ? a_pos : left;
      g = g < 0 ? 0 : g;
    }
    a.granted[r] = g;
    s_v1[q] = g;
  }
  __syncthreads();
  for (int q = t; q < B; q += T) commit(a, s_idx[q], s_v1[q]);
}


// ---------------------------------------------------------------------------
// the multi-block path (B > kMaxRows)
// ---------------------------------------------------------------------------

// The scratch buffer, carved in this order (8-byte arrays first).
struct Scratch {
  uint64_t* key;     // [n_pad] sort keys, sorted in place
  uint32_t* idx;     // [n_pad] row of each sorted position
  int32_t* amt;      // [n_pad] gated amount, by row
  int32_t* v1;       // [n_pad] by position
  int32_t* v2;       // [n_pad]
  int32_t* tile_v;   // [n_tiles] scan carries, then prefixes
  int32_t* tile_f;   // [n_tiles] a segment began in the tile
  int32_t* tile_first;  // [n_tiles] first segment start in the tile
  int32_t* tile_have;   // [n_tiles] the prefix holds a value
  uint8_t* seg;      // [n_pad] a bucket run begins here
  uint8_t* grant;    // [n_pad]
};

long long pad_rows(int B) {
  long long n = 1;
  while (n < B) n <<= 1;
  return n;
}

long long scratch_layout(int B, Scratch* sc, uint8_t* base) {
  const long long n = pad_rows(B);
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  long long off = 0;
  auto take = [&](long long bytes) {
    uint8_t* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  uint8_t* p_key = take(n * 8);
  uint8_t* p_idx = take(n * 4);
  uint8_t* p_amt = take(n * 4);
  uint8_t* p_v1 = take(n * 4);
  uint8_t* p_v2 = take(n * 4);
  uint8_t* p_tv = take(tiles * 4);
  uint8_t* p_tf = take(tiles * 4);
  uint8_t* p_t1 = take(tiles * 4);
  uint8_t* p_th = take(tiles * 4);
  uint8_t* p_seg = take(n);
  uint8_t* p_grant = take(n);
  if (sc != nullptr) {
    sc->key = reinterpret_cast<uint64_t*>(p_key);
    sc->idx = reinterpret_cast<uint32_t*>(p_idx);
    sc->amt = reinterpret_cast<int32_t*>(p_amt);
    sc->v1 = reinterpret_cast<int32_t*>(p_v1);
    sc->v2 = reinterpret_cast<int32_t*>(p_v2);
    sc->tile_v = reinterpret_cast<int32_t*>(p_tv);
    sc->tile_f = reinterpret_cast<int32_t*>(p_tf);
    sc->tile_first = reinterpret_cast<int32_t*>(p_t1);
    sc->tile_have = reinterpret_cast<int32_t*>(p_th);
    sc->seg = p_seg;
    sc->grant = p_grant;
  }
  return off;
}

// gate, roll and sort key of every row; pads sort after every row
__global__ void __launch_bounds__(kThreads)
    mb_prep_kernel(Args a, Scratch sc, int mode, int n_pad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_pad) return;
  if (r >= a.B) {
    sc.key[r] = ~0ull;
    sc.idx[r] = 0xffffffffu;
    return;
  }
  const int32_t amt = gated_amount(a, r);
  sc.amt[r] = amt;
  const bool act = live(a, r);
  if (act) roll(a, r);
  const uint32_t kb = act ? ((uint32_t)a.buckets[r] ^ 0x80000000u)
                          : 0xffffffffu;
  uint32_t lo = 0;
  if (mode == kSeg) {
    const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
    lo = ((a.be[r] != 0 ? 1u : 0u) << 22) | (uint32_t)a_pos;
  }
  sc.key[r] = ((uint64_t)kb << 32) | lo;
  sc.idx[r] = (uint32_t)r;
}

__device__ __forceinline__ void cmp_swap(uint64_t* key, uint32_t* idx, int i,
                                         int l, bool ascending) {
  const uint64_t ki = key[i], kl = key[l];
  const uint32_t ii = idx[i], il = idx[l];
  const bool gt = ki > kl || (ki == kl && ii > il);
  if (gt == ascending) {
    key[i] = kl;
    key[l] = ki;
    idx[i] = il;
    idx[l] = ii;
  }
}

// one bitonic step of stride j >= kSortTile across the whole buffer
__global__ void __launch_bounds__(kThreads)
    mb_sort_global_kernel(uint64_t* key, uint32_t* idx, int n_pad, int k,
                          int j) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const int l = i ^ j;
  if (l > i) cmp_swap(key, idx, i, l, (i & k) == 0);
}

// every step of stride < kSortTile for k in [k_lo, k_hi], inside one
// kSortTile tile in shared memory (the direction bit is the global
// index's)
__global__ void __launch_bounds__(kThreads)
    mb_sort_tile_kernel(uint64_t* key, uint32_t* idx, int k_lo, int k_hi) {
  __shared__ uint64_t s_key[kSortTile];
  __shared__ uint32_t s_idx[kSortTile];
  const int base = blockIdx.x * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += blockDim.x) {
    s_key[i] = key[base + i];
    s_idx[i] = idx[base + i];
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1)
    for (int j = (k >> 1) < (kSortTile >> 1) ? (k >> 1) : (kSortTile >> 1);
         j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kSortTile; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) cmp_swap(s_key, s_idx, i, l, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < kSortTile; i += blockDim.x) {
    key[base + i] = s_key[i];
    idx[base + i] = s_idx[i];
  }
}

// run starts of the sorted order; v1 = position of each run start (unit)
__global__ void __launch_bounds__(kThreads)
    mb_seg_kernel(Args a, Scratch sc, int mode) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const bool s = q == 0 || (sc.key[q] >> 32) != (sc.key[q - 1] >> 32);
  sc.seg[q] = s;
  if (mode == kUnit) sc.v1[q] = s ? q : 0;
}

// in-tile segmented inclusive scan of v (f == nullptr: no segments);
// per tile: its last value, whether a segment began in it, and the
// position of its first segment start
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
    mb_scan_tile_kernel(int32_t* v, const uint8_t* f, int n, Scratch sc) {
  __shared__ int32_t s_v[kScanTile];
  __shared__ uint8_t s_f[kScanTile];
  __shared__ int32_t t_v[kThreads];
  __shared__ uint8_t t_f[kThreads];
  __shared__ int first;
  const int base = blockIdx.x * kScanTile;
  const int len = min(kScanTile, n - base);
  if (threadIdx.x == 0) first = len;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_v[i] = v[base + i];
    const uint8_t fi = f != nullptr ? f[base + i] : 0;
    s_f[i] = fi;
    if (fi) atomicMin(&first, i);
  }
  __syncthreads();
  block_scan<kMax>(s_v, f != nullptr ? s_f : nullptr, len, t_v, t_f);
  for (int i = threadIdx.x; i < len; i += blockDim.x) v[base + i] = s_v[i];
  if (threadIdx.x == 0) {
    sc.tile_v[blockIdx.x] = s_v[len - 1];
    sc.tile_f[blockIdx.x] = first < len;
    sc.tile_first[blockIdx.x] = first;
  }
}

// one thread: tile carries → the exclusive prefix flowing into each tile
template <bool kMax>
__global__ void mb_scan_carry_kernel(Scratch sc, int n_tiles) {
  int32_t pv = 0;
  bool have = false;
  for (int t = 0; t < n_tiles; ++t) {
    const int32_t cv = sc.tile_v[t];
    const bool cf = sc.tile_f[t] != 0;
    sc.tile_v[t] = pv;
    sc.tile_have[t] = have;
    pv = (cf || !have) ? cv : scan_op<kMax>(pv, cv);
    have = true;
  }
}

// fold each tile's prefix into its elements before its first segment
// start
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
    mb_scan_fix_kernel(int32_t* v, int n, Scratch sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = i / kScanTile;
  if (!sc.tile_have[t] || i - t * kScanTile >= sc.tile_first[t]) return;
  v[i] = scan_op<kMax>(sc.tile_v[t], v[i]);
}

// unit: grant iff the row's rank in its run is < max - used
__global__ void __launch_bounds__(kThreads)
    mb_unit_kernel(Args a, Scratch sc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const int r = sc.idx[q];
  int32_t g = 0;
  if (live(a, r)) g = (q - sc.v1[q]) < avail_of(a, r) ? 1 : 0;
  a.granted[r] = g;
  sc.v2[q] = g;
}

// scan: one thread per bucket run walks it with its consumed carry
__global__ void __launch_bounds__(kThreads)
    mb_walk_kernel(Args a, Scratch sc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const int r0 = sc.idx[q];
  if (!live(a, r0)) {  // inactive rows sort into their own run
    a.granted[r0] = 0;
    sc.v1[q] = 0;
    return;
  }
  if (!sc.seg[q]) return;
  const int32_t used = used_of(a, r0);  // the run shares a bucket
  int32_t consumed = 0;
  for (int z = q; z < a.B && (z == q || !sc.seg[z]); ++z) {
    const int r = sc.idx[z];
    const int32_t g = alloc_one(a.be[r] != 0, sc.amt[r],
                                wsub(wsub(a.mx[r], used), consumed));
    consumed = wadd(consumed, g);
    a.granted[r] = g;
    sc.v1[z] = g;
  }
}

// seg, before the first scan: v1 = all-or-nothing amounts
__global__ void __launch_bounds__(kThreads)
    mb_seg_ao_kernel(Args a, Scratch sc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const int r = sc.idx[q];
  const int32_t amt = sc.amt[r];
  const bool ao = live(a, r) && a.be[r] == 0 && amt <= kDomainMax;
  sc.v1[q] = ao ? (amt < 0 ? 0 : amt) : 0;
}

// seg, after cum_ao: grant_ao; v2 = granted cum_ao; v1 = best-effort
// amounts (for the third scan)
__global__ void __launch_bounds__(kThreads)
    mb_seg_grant_kernel(Args a, Scratch sc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const int r = sc.idx[q];
  const int32_t amt = sc.amt[r];
  const bool g = live(a, r) && a.be[r] == 0 && amt <= kDomainMax &&
                 amt > 0 && sc.v1[q] <= avail_of(a, r);
  sc.grant[q] = g;
  sc.v2[q] = g ? sc.v1[q] : 0;
  const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
  sc.v1[q] = (live(a, r) && a.be[r] != 0) ? a_pos : 0;
}

// seg, after consumed_ao (v2) and the best-effort cumsum (v1): grants
__global__ void __launch_bounds__(kThreads)
    mb_seg_final_kernel(Args a, Scratch sc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  const int r = sc.idx[q];
  const int32_t amt = sc.amt[r];
  const int32_t a_pos = amt < 0 ? 0 : (amt > kDomainMax ? kDomainMax : amt);
  int32_t g = 0;
  if (sc.grant[q]) {
    g = a_pos;
  } else if (live(a, r) && a.be[r] != 0) {
    const int32_t before = wsub(sc.v1[q], a_pos);
    int32_t av = avail_of(a, r);
    av = av < 0 ? 0 : av;
    int32_t rem = wsub(av, sc.v2[q]);
    rem = rem < 0 ? 0 : rem;
    const int32_t left = wsub(rem, before);
    g = a_pos < left ? a_pos : left;
    g = g < 0 ? 0 : g;
  }
  a.granted[r] = g;
  sc.v1[q] = g;
}

// every read of `used` is done: commit each position's grant
__global__ void __launch_bounds__(kThreads)
    mb_commit_kernel(Args a, const uint32_t* idx, const int32_t* g) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.B) return;
  commit(a, idx[q], g[q]);
}

// the multi-block pipeline → the number of kernels launched
int multi_block(const Args& a, int mode, uint8_t* scratch, cudaStream_t st) {
  Scratch sc;
  scratch_layout(a.B, &sc, scratch);
  const int n_pad = (int)pad_rows(a.B);
  const unsigned g_pad = (unsigned)((n_pad + kThreads - 1) / kThreads);
  const unsigned g_rows = (unsigned)((a.B + kThreads - 1) / kThreads);
  const int n_tiles = (a.B + kScanTile - 1) / kScanTile;
  int n = 0;
  mb_prep_kernel<<<g_pad, kThreads, 0, st>>>(a, sc, mode, n_pad);
  ++n;
  // bitonic sort: whole tiles first, then each larger k as global steps
  // down to kSortTile and one tile launch for the rest
  mb_sort_tile_kernel<<<n_pad / kSortTile, kThreads, 0, st>>>(
      sc.key, sc.idx, 2, kSortTile);
  ++n;
  for (int k = 2 * kSortTile; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= kSortTile; j >>= 1) {
      mb_sort_global_kernel<<<g_pad, kThreads, 0, st>>>(sc.key, sc.idx,
                                                        n_pad, k, j);
      ++n;
    }
    mb_sort_tile_kernel<<<n_pad / kSortTile, kThreads, 0, st>>>(
        sc.key, sc.idx, k, k);
    ++n;
  }
  mb_seg_kernel<<<g_rows, kThreads, 0, st>>>(a, sc, mode);
  ++n;
  auto scan = [&](bool is_max, int32_t* v, const uint8_t* f) {
    if (is_max) {
      mb_scan_tile_kernel<true><<<n_tiles, kThreads, 0, st>>>(v, f, a.B, sc);
      mb_scan_carry_kernel<true><<<1, 1, 0, st>>>(sc, n_tiles);
      mb_scan_fix_kernel<true><<<g_rows, kThreads, 0, st>>>(v, a.B, sc);
    } else {
      mb_scan_tile_kernel<false><<<n_tiles, kThreads, 0, st>>>(v, f, a.B,
                                                               sc);
      mb_scan_carry_kernel<false><<<1, 1, 0, st>>>(sc, n_tiles);
      mb_scan_fix_kernel<false><<<g_rows, kThreads, 0, st>>>(v, a.B, sc);
    }
    n += 3;
  };
  const int32_t* committed = sc.v1;
  if (mode == kUnit) {
    scan(true, sc.v1, nullptr);  // run start
    mb_unit_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    committed = sc.v2;
    ++n;
  } else if (mode == kScan) {
    mb_walk_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
  } else {
    mb_seg_ao_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
    scan(false, sc.v1, sc.seg);   // cum_ao
    mb_seg_grant_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
    scan(true, sc.v2, sc.seg);    // consumed_ao
    scan(false, sc.v1, sc.seg);   // best-effort cumsum
    mb_seg_final_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
  }
  mb_commit_kernel<<<g_rows, kThreads, 0, st>>>(a, sc.idx, committed);
  return n + 1;
}

}  // namespace

// Bytes of scratch a contended batch of B rows needs (0: the one-block
// path or fast mode, which need none).
extern "C" int quota_alloc_scratch_bytes(int B, int mode) {
  if (mode == kFast || pad_rows(B) <= kMaxRows) return 0;
  return (int)scratch_layout(B, nullptr, nullptr);
}

// Returns the number of kernels launched, or -cudaError_t on failure
// (cudaErrorInvalidValue for a contended batch above kMaxRows rows given
// no scratch).
extern "C" int quota_alloc(int32_t* slots, int n_buckets, int K,
                           const int32_t* buckets, const int32_t* amounts,
                           const int32_t* be, const int32_t* mx,
                           const int32_t* active, const int32_t* ticks,
                           const int32_t* lasts, const int32_t* rolling,
                           int B, int mode, const int32_t* status,
                           const uint8_t* matched, int R,
                           const int32_t* rule_idx, const int32_t* rule_ns,
                           const int32_t* req_ns, int default_ns,
                           int32_t* granted, int32_t* gate_out,
                           uint8_t* scratch, void* stream) {
  if (B == 0) return 0;
  if (K < 1 || mode < kScan || mode > kSeg)
    return -(int)cudaErrorInvalidValue;
  const Args a{slots,  n_buckets, K,       buckets, amounts, be,
               mx,     active,    ticks,   lasts,   rolling, B,
               status, matched,   R,       rule_idx, rule_ns, req_ns,
               default_ns, granted, gate_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int launched = 1;
  if (mode == kFast) {
    fast_kernel<<<(B + kFastThreads - 1) / kFastThreads, kFastThreads, 0,
                  st>>>(a);
  } else if (pad_rows(B) > kMaxRows) {
    if (scratch == nullptr) return -(int)cudaErrorInvalidValue;
    launched = multi_block(a, mode, scratch, st);
  } else {
    const int n_pad = (int)pad_rows(B);
    const size_t smem = (size_t)n_pad * (8 + 4 + 4 + 4 + 4 + 1 + 1) +
                        (size_t)kThreads * (4 + 1);
    const cudaError_t e = cudaFuncSetAttribute(
        contended_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return -(int)e;
    contended_kernel<<<1, kThreads, smem, st>>>(a, mode, n_pad);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? launched : -(int)e;
}
