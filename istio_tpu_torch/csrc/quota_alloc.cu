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
// contended modes are a chain of dependent steps (a stable sort, then
// segmented scans), each tiny. What costs is the chain: barriers (about
// half a microsecond each at 1,024 threads), per-thread chains of global
// round trips, and an SM's rate of scattered memory requests, which
// caps any design that puts thousands of rows on one SM.
//
// The design of the contended modes (unit, seg, gated seg) up to 65,536
// rows: ONE launch of a thread-block cluster of c = min(16, ceil(B /
// 1,024)) blocks on neighbouring SMs (16 is a non-portable cluster size),
// 1,024 threads and up to 168 KB of shared memory each, with no global
// scratch. Block k holds rows [k·n, (k+1)·n), n = ceil(B / c) <= 4,096,
// and, once sorted, the same range of positions.
//   prep   gate, roll and key of every row, a thread's rows loaded
//          together through the read-only path; the cluster's largest
//          live bucket and amount (read through distributed shared
//          memory) size a compact key (bucket, best-effort bit, amount:
//          about 21 bits on the served pools); each row's max and
//          counter column stay in its block's shared memory, and each
//          position reads its row's once after the sort (through
//          distributed shared memory where another block holds it), so
//          no stage after the sort gathers a row from global memory;
//   sort   a stable LSD radix sort on 7-bit digits over those bits only
//          (3 passes for 21 bits): per pass each block ranks its rows by
//          digit (a warp match + per-warp counters, one block scan),
//          writes them (key, row index) in local digit order, publishes
//          its digit counts, and after a cluster barrier copies each
//          digit run to its global positions in the owning blocks'
//          shared memory (the runs are contiguous, so the remote stores
//          coalesce); six barriers a pass. Stable, so the row index is not part of the
//          key: the order is the reference's lexsort;
//   scans  each segmented scan (run starts by max, the all-or-nothing and
//          best-effort cumsums together in one pass, then the granted
//          running max) scans per thread, per warp with shuffles and per
//          block, publishes the block's (carry, "a segment began here"),
//          and after one cluster barrier folds the lower blocks' carries
//          read through distributed shared memory;
//   used   read once per bucket run, at the run's first position; every
//          other row of the run reads it from there (another block's
//          shared memory where the run spans a seam);
//   commit one atomicAdd per run of equal counter cells among a thread's
//          consecutive positions.
// Per-position arrays carry one pad word in 32, so a thread's run of
// positions and a warp's 32 consecutive ones fall in distinct banks.
// Cluster barriers keep the reference's order: every roll before any read
// of `used`, every read of `used` before any commit; and no block exits
// while another may still read its shared memory. Duplicate rolls write
// the same zeros (the reference's idempotent multiply-scatter); commits
// are integer atomics, which commute. A refused cluster launch is an
// error, not a fallback.
//
// Above 65,536 rows the contended modes run on many blocks, with their
// state in a global scratch buffer the wrapper allocates
// (quota_alloc_scratch_bytes) and kernel boundaries in place of barriers:
// one launch gates, rolls and keys every row; a bitonic sort of the
// power-of-two padded (key, row) pairs runs the steps whose stride is at
// least kSortTile as global compare-exchange launches and every other
// step inside kSortTile-element tiles in shared memory; a segmented scan
// runs per kScanTile tile, then one thread chains the tile carries (each
// with its "a segment began here" flag), then the tiles' leading runs
// are fixed up; the grant, scan-walk (one thread per bucket run) and
// commit steps are one launch each. The scan oracle runs there above
// 8,192 rows too, and in one block of 1,024 threads at or under 8,192
// (a bitonic sort of (key, row) pairs in shared memory, one thread
// walking each bucket run).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

#ifdef KERNEL_PROBE
// The probe build: thread 0 of each block writes (%globaltimer ns,
// clock64) at each stage boundary into the buffer quota_alloc_probe set,
// slot i of block b at [(b * kProbeSlots + i) * 2].
constexpr int kProbeSlots = 32;
__device__ unsigned long long* g_probe = nullptr;
__device__ __forceinline__ void probe_stamp(int i) {
  if (g_probe == nullptr || threadIdx.x != 0) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  unsigned long long* p = g_probe + 2 * (blockIdx.x * kProbeSlots + i);
  p[0] = ns;
  p[1] = (unsigned long long)clock64();
}
__global__ void probe_kernel(int i) { probe_stamp(i); }
#define PROBE(i) probe_stamp(i)
#define PROBE_LAUNCH(i, st) probe_kernel<<<1, 1, 0, st>>>(i)
#else
#define PROBE(i) ((void)0)
#define PROBE_LAUNCH(i, st) ((void)0)
#endif

constexpr int kThreads = 1024;     // the scan oracle's one block
constexpr int kFastThreads = 256;
constexpr int kMaxRows = 8192;    // the scan oracle's one-block limit
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

// scan at up to kMaxRows rows: one block, every row in shared memory; a
// bitonic sort of (key, row index) pairs, then one thread per bucket run
// walks it with its consumed carry
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a, int n_pad) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_key = smem;
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_key + n_pad);
  int32_t* s_amt = reinterpret_cast<int32_t*>(s_idx + n_pad);  // by row
  int32_t* s_g = s_amt + n_pad;                                // by position
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(s_g + n_pad);
  const int B = a.B, T = blockDim.x, t = threadIdx.x;
  PROBE(0);
  // gate, roll and sort key of every row; pads sort after every row
  for (int r = t; r < n_pad; r += T) {
    if (r >= B) {
      s_key[r] = ~0ull;
      s_idx[r] = 0xffffffffu;
      continue;
    }
    s_amt[r] = gated_amount(a, r);
    const bool act = live(a, r);
    if (act) roll(a, r);
    // key_bucket = active ? bucket : INT32_MAX, as an unsigned order
    s_key[r] = (uint64_t)(act ? ((uint32_t)a.buckets[r] ^ 0x80000000u)
                              : 0xffffffffu) << 32;
    s_idx[r] = (uint32_t)r;
  }
  __syncthreads();  // every roll done: `used` is final from here on
  PROBE(1);
  bitonic_sort(s_key, s_idx, n_pad);
  PROBE(2);
  for (int q = t; q < B; q += T)
    s_seg[q] = q == 0 || (s_key[q] >> 32) != (s_key[q - 1] >> 32);
  __syncthreads();
  PROBE(3);
  for (int q = t; q < B; q += T) {
    const int r0 = s_idx[q];
    if (!live(a, r0)) {  // inactive rows sort into their own run
      a.granted[r0] = 0;
      s_g[q] = 0;
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
      s_g[z] = g;
    }
  }
  __syncthreads();  // every read of `used` done before any commit
  PROBE(4);
  for (int q = t; q < B; q += T) commit(a, s_idx[q], s_g[q]);
  __syncthreads();
  PROBE(5);
}

// ---------------------------------------------------------------------------
// the cluster path: unit and seg at up to kClusterRows rows, one launch
// ---------------------------------------------------------------------------

constexpr int kCThreads = 1024;
constexpr int kBlockRows = 1024;   // rows per cluster block, as a rule
constexpr int kMaxCluster = 16;    // blocks per cluster (non-portable)
constexpr int kMaxBlockRows = 4096;  // rows per cluster block, at most
constexpr int kClusterRows = kMaxBlockRows * kMaxCluster;
constexpr int kMaxItems = kMaxBlockRows / kCThreads;  // rows per thread
constexpr int kDigitBits = 7;
constexpr int kBins = 1 << kDigitBits;
constexpr int kCntStride = kCThreads / 32 + 1;  // per-digit warp counters,
                                                // padded off one bank
// the small shared arrays, in int32 words: block reduce, the published
// maxima (read by the cluster), the block-sum scratch, the scans' warp
// aggregates, published carries and block prefix
constexpr int kRed = 0, kPub = 64, kMax2 = 66, kSumW = 72, kScanW = 256,
              kCarry = 416, kPre = 432, kMisc = 448;

// shared bytes of a cluster block holding `rows` rows: two keys and two
// row indices per position, the max and counter column per row (each
// array padded one word in 32), two sets of digit counters (a pass zeroes
// the next pass's), digit totals and offsets, and the small arrays
__host__ __device__ constexpr size_t cluster_smem(int rows) {
  return (size_t)(rows + rows / 32) * (2 * (8 + 4) + 4 + 4) +
         (size_t)(2 * kBins * kCntStride + 2 * kBins + kMisc) * 4;
}

__device__ __forceinline__ int bitlen(uint32_t x) { return 32 - __clz(x); }

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// exclusive sum of x over the block's threads in order; *total = the sum
// (one barrier: every warp scans the warp totals itself)
__device__ __forceinline__ uint32_t block_excl_sum(uint32_t x, int32_t* misc,
                                                   uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) misc[kSumW + w] = (int32_t)inc;
  __syncthreads();
  const uint32_t s = (uint32_t)misc[kSumW + lane];
  uint32_t si = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, si, off);
    if (lane >= off) si += y;
  }
  *total = __shfl_sync(0xffffffffu, si, 31);
  return __shfl_sync(0xffffffffu, si - s, w) + inc - x;
}

// a position's index in a per-position shared array: one pad word per 32,
// so a thread's run of consecutive positions (stride kMaxItems across a
// warp) and a warp's 32 consecutive positions both fall in distinct banks
__device__ __forceinline__ int sw(int q) { return q + (q >> 5); }

// One element of a segmented scan: `have` (anything there), `f` (a segment
// began in it), and NV values; bit i of kMaxMask: value i is a running
// max, else a wrapping sum.
template <int NV>
struct SegVal {
  int32_t v[NV];
  bool have, f;
};

template <int NV, uint32_t kMaxMask>
__device__ __forceinline__ SegVal<NV> seg_combine(const SegVal<NV>& a,
                                                  const SegVal<NV>& b) {
  if (!a.have) return b;
  if (!b.have) return a;
  SegVal<NV> o;
  o.have = true;
  o.f = a.f || b.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    o.v[i] = b.f ? b.v[i]
                 : (((kMaxMask >> i) & 1) ? max(a.v[i], b.v[i])
                                          : wadd(a.v[i], b.v[i]));
  return o;
}

// inclusive scan of one SegVal per lane across the warp
template <int NV, uint32_t kMaxMask>
__device__ __forceinline__ SegVal<NV> warp_seg_scan(SegVal<NV> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    SegVal<NV> p;
    p.have = __shfl_up_sync(0xffffffffu, (int)x.have, off) != 0;
    p.f = __shfl_up_sync(0xffffffffu, (int)x.f, off) != 0;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      p.v[i] = __shfl_up_sync(0xffffffffu, x.v[i], off);
    if (lane >= off) x = seg_combine<NV, kMaxMask>(p, x);
  }
  return x;
}

template <int NV>
__device__ __forceinline__ SegVal<NV> seg_shfl_prev(const SegVal<NV>& x) {
  // the previous lane's value (lane 0: nothing)
  SegVal<NV> p;
  p.have = __shfl_up_sync(0xffffffffu, (int)x.have, 1) != 0;
  p.f = __shfl_up_sync(0xffffffffu, (int)x.f, 1) != 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) p.v[i] = __shfl_up_sync(0xffffffffu, x.v[i], 1);
  if ((threadIdx.x & 31) == 0) p.have = false;
  return p;
}

template <int NV>
__device__ __forceinline__ void seg_store(int32_t* p, const SegVal<NV>& x) {
  p[0] = x.have;
  p[1] = x.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) p[2 + i] = x.v[i];
}

template <int NV>
__device__ __forceinline__ SegVal<NV> seg_load(const int32_t* p) {
  SegVal<NV> x;
  x.have = p[0] != 0;
  x.f = p[1] != 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) x.v[i] = p[2 + i];
  return x;
}

// Inclusive segmented scan, in place, of the NV arrays col[i] over this
// block's positions [0, n) (at sw(q); bit 0 of flags[sw(q)]: a segment
// begins at q),
// continued across the cluster: the block scans (each thread its
// kMaxItems-strided run of `items` positions, then the warps with
// shuffles, then the warp totals), publishes its carry in slot `slot`,
// and after one cluster barrier folds the lower blocks' carries. Each
// thread reads and writes only its own positions outside the barriers, so
// neither side of a scan needs one of its own.
template <int NV, uint32_t kMaxMask>
__device__ void cluster_seg_scan(cg::cluster_group& cl, int c, int rank,
                                 int32_t* const (&col)[NV],
                                 const uint8_t* flags, int n, int items,
                                 int32_t* misc, int slot) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  constexpr int kW = NV + 2;  // words per stored SegVal
  SegVal<NV> acc;
  acc.have = acc.f = false;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc.v[i] = 0;
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    if (u < items && q < n) {
      SegVal<NV> x;
      x.have = true;
      x.f = (flags[sw(q)] & 1) != 0;
#pragma unroll
      for (int i = 0; i < NV; ++i) x.v[i] = col[i][sw(q)];
      acc = seg_combine<NV, kMaxMask>(acc, x);
#pragma unroll
      for (int i = 0; i < NV; ++i) col[i][sw(q)] = acc.v[i];
    }
  }
  const SegVal<NV> inc = warp_seg_scan<NV, kMaxMask>(acc);
  const SegVal<NV> lane_ex = seg_shfl_prev<NV>(inc);
  if (lane == 31) seg_store<NV>(misc + kScanW + w * kW, inc);
  __syncthreads();
  if (w == 0) {
    const SegVal<NV> wi =
        warp_seg_scan<NV, kMaxMask>(seg_load<NV>(misc + kScanW + lane * kW));
    const SegVal<NV> we = seg_shfl_prev<NV>(wi);
    __syncwarp();
    seg_store<NV>(misc + kScanW + lane * kW, we);  // exclusive per warp
    if (lane == 31) seg_store<NV>(misc + kCarry + slot * kW, wi);
  }
  SegVal<NV> blk;  // what the lower blocks carry in (one block: nothing)
  blk.have = blk.f = false;
#pragma unroll
  for (int i = 0; i < NV; ++i) blk.v[i] = 0;
  if (c > 1) {
    cl.sync();  // every block's carry is published
    if (w == 0) {
      SegVal<NV> x;
      x.have = false;
      x.f = false;
#pragma unroll
      for (int i = 0; i < NV; ++i) x.v[i] = 0;
      if (lane < rank)
        x = seg_load<NV>(cl.map_shared_rank(misc, lane) + kCarry +
                         slot * kW);
      x = warp_seg_scan<NV, kMaxMask>(x);
      if (lane == 31) seg_store<NV>(misc + kPre, x);
    }
  }
  __syncthreads();
  if (c > 1) blk = seg_load<NV>(misc + kPre);
  const SegVal<NV> pre = seg_combine<NV, kMaxMask>(
      seg_combine<NV, kMaxMask>(blk, seg_load<NV>(misc + kScanW + w * kW)),
      lane_ex);
  if (pre.have) {
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      if (u >= items || q >= n || (flags[sw(q)] & 1)) break;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        col[i][sw(q)] = ((kMaxMask >> i) & 1) ? max(pre.v[i], col[i][sw(q)])
                                              : wadd(pre.v[i], col[i][sw(q)]);
    }
  }
}

// the read-only inputs of one row, read through the read-only path (so a
// thread's rows are loaded together, not one round trip after another)
struct RowIn {
  int32_t bk, act, amt, be, mx, tk, ls, rl;
};

__device__ __forceinline__ RowIn load_row(const Args& a, int r) {
  RowIn x;
  x.bk = __ldg(a.buckets + r);
  x.act = __ldg(a.active + r);
  x.amt = __ldg(a.amounts + r);
  x.be = __ldg(a.be + r);
  x.mx = __ldg(a.mx + r);
  x.tk = __ldg(a.ticks + r);
  x.ls = __ldg(a.lasts + r);
  x.rl = __ldg(a.rolling + r);
  return x;
}

// gated_amount on a loaded row
__device__ __forceinline__ int32_t gate_row(const Args& a, int r,
                                            const RowIn& x) {
  if (a.status == nullptr) return x.amt;
  bool g = false;
  if (x.act != 0 && a.R > 0) {
    const int ri = __ldg(a.rule_idx + r);
    const int rule = ri < 0 ? 0 : (ri >= a.R ? a.R - 1 : ri);
    const int rn = __ldg(a.rule_ns + rule);
    const bool ns_ok = rn == a.default_ns || rn == __ldg(a.req_ns + r);
    g = ri >= 0 && ns_ok && __ldg(a.status + r) == 0 &&
        __ldg(a.matched + (long long)r * a.R + rule) != 0;
  }
  a.gate_out[r] = g ? 1 : 0;
  return g ? x.amt : 0;
}

// roll on a loaded row: (p - last - 1) mod K by one modulo and then
// increments, where p - last - 1 does not wrap over p in [0, K)
__device__ __forceinline__ void roll_row(const Args& a, const RowIn& x) {
  if (x.rl == 0) return;
  int32_t delta = wsub(x.tk, x.ls);
  delta = delta < 0 ? 0 : (delta > a.K ? a.K : delta);
  if (delta == 0) return;
  int32_t* row = a.slots + (long long)x.bk * a.K;
  const int32_t x0 = wsub(wsub(0, x.ls), 1);
  if (delta == a.K) {
    for (int p = 0; p < a.K; ++p) row[p] = 0;
  } else if (x0 <= 0x7fffffff - a.K) {
    int m = floor_mod(x0, a.K);
    for (int p = 0; p < a.K; ++p) {
      if (m < delta) row[p] = 0;
      if (++m == a.K) m = 0;
    }
  } else {
    for (int p = 0; p < a.K; ++p)
      if (floor_mod(wsub(wsub(p, x.ls), 1), a.K) < delta) row[p] = 0;
  }
}

__global__ void __launch_bounds__(kCThreads, 1)
    cluster_kernel(Args a, int mode, int chunk, int items) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int cap = sw(kCThreads * items);  // per-position array length
  extern __shared__ __align__(16) unsigned char csmem[];
  uint64_t* key_a = reinterpret_cast<uint64_t*>(csmem);
  uint64_t* key_b = key_a + cap;
  // the payload: row index (bit 31: over the domain)
  uint32_t* idx_a = reinterpret_cast<uint32_t*>(key_b + cap);
  uint32_t* idx_b = idx_a + cap;
  // per row of this block (not moved by the sort): max << 32 | counter
  // column, one word so a position reads its row's in one load
  uint64_t* row_mc = reinterpret_cast<uint64_t*>(idx_b + cap);
  // digit counters [kBins][kCntStride], one set per pass parity
  uint32_t* cnt2 = reinterpret_cast<uint32_t*>(row_mc + cap);
  // (every array above is a multiple of 16 bytes: hist is read as int4)
  int32_t* hist = reinterpret_cast<int32_t*>(cnt2 + 2 * kBins * kCntStride);
  int32_t* gofs = hist + kBins;
  int32_t* misc = gofs + kBins;
  const int base = rank * chunk;
  const int n = min(chunk, a.B - base);
  const bool seg = mode == kSeg;
  PROBE(0);

  for (int i = t; i < kBins * kCntStride; i += kCThreads) cnt2[i] = 0;

  // ---- prep: gate, roll and a provisional key (bucket | best-effort bit
  // 31 | clamped amount; ~0: not live) of every row, four rows of a
  // thread at a time, and its payload: row index (bit 31: the amount is
  // over the domain), max and counter column
  int maxb = -1, maxa = 0;
#pragma unroll
  for (int u0 = 0; u0 < kMaxItems; u0 += 4) {
    if (u0 >= items) break;
    RowIn x[4];
    int32_t amt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + (u0 + j) * kCThreads;
      if (u0 + j < items && i < n) x[j] = load_row(a, base + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + (u0 + j) * kCThreads;
      if (u0 + j < items && i < n) amt[j] = gate_row(a, base + i, x[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + (u0 + j) * kCThreads;
      if (u0 + j >= items || i >= n) continue;
      uint64_t prov = ~0ull;
      uint32_t over = 0;
      if (x[j].act != 0 && x[j].bk >= 0 && x[j].bk < a.n_buckets) {
        roll_row(a, x[j]);
        maxb = max(maxb, x[j].bk);
        uint32_t lo = 0;
        if (seg) {
          const int32_t a_pos =
              amt[j] < 0 ? 0 : (amt[j] > kDomainMax ? kDomainMax : amt[j]);
          maxa = max(maxa, a_pos);
          lo = (x[j].be != 0 ? 0x80000000u : 0u) | (uint32_t)a_pos;
          over = amt[j] > kDomainMax ? 1u : 0u;
        }
        prov = ((uint64_t)(uint32_t)x[j].bk << 32) | lo;
      }
      key_a[sw(i)] = prov;
      idx_a[sw(i)] = (uint32_t)(base + i) | (over << 31);
      row_mc[sw(i)] =
          ((uint64_t)(uint32_t)x[j].mx << 32) |
          (uint32_t)(x[j].rl != 0 ? floor_mod(x[j].tk, a.K) : 0);
    }
  }
  // (the cluster barriers below release the rolls to every block before
  // any reads `used`)
  maxb = __reduce_max_sync(0xffffffffu, maxb);
  maxa = __reduce_max_sync(0xffffffffu, maxa);
  if (lane == 0) {
    misc[kRed + w] = maxb;
    misc[kRed + 32 + w] = maxa;
  }
  __syncthreads();
  if (w == 0) {
    const int vb = __reduce_max_sync(0xffffffffu, misc[kRed + lane]);
    const int va = __reduce_max_sync(0xffffffffu, misc[kRed + 32 + lane]);
    if (lane == 0) {
      misc[c > 1 ? kPub : kMax2] = vb;
      misc[(c > 1 ? kPub : kMax2) + 1] = va;
    }
  }
  if (c > 1) {  // the cluster's maxima, from every block's
    cl.sync();
    if (w == 0) {
      int vb = -1, va = 0;
      if (lane < c) {
        const int32_t* pub = cl.map_shared_rank(misc, lane) + kPub;
        vb = pub[0];
        va = pub[1];
      }
      vb = __reduce_max_sync(0xffffffffu, vb);
      va = __reduce_max_sync(0xffffffffu, va);
      if (lane == 0) {
        misc[kMax2] = vb;
        misc[kMax2 + 1] = va;
      }
    }
  }
  __syncthreads();
  // compact keys: bucket (not live: the largest live bucket + 1), then in
  // seg mode the best-effort bit and abits bits of clamped amount
  const uint32_t sentinel = (uint32_t)(misc[kMax2] + 1);
  const int abits = seg ? bitlen((uint32_t)misc[kMax2 + 1]) : 0;
  const int lo_bits = seg ? abits + 1 : 0;
  const uint64_t amask = (1ull << abits) - 1;
  const int passes = (bitlen(sentinel) + lo_bits + kDigitBits - 1) /
                     kDigitBits;
  for (int i = t; i < n; i += kCThreads) {
    const uint64_t prov = key_a[sw(i)];
    const uint32_t hi = (uint32_t)(prov >> 32), lo = (uint32_t)prov;
    key_a[sw(i)] = hi == 0xffffffffu
                       ? (uint64_t)sentinel << lo_bits
                       : ((uint64_t)hi << lo_bits) |
                             (seg ? ((uint64_t)(lo >> 31) << abits) |
                                        (lo & 0x7fffffffu)
                                  : 0);
  }
  __syncthreads();
  PROBE(1);

  // ---- sort: stable LSD radix over `passes` digits, the row index along
  uint64_t *sk = key_a, *dk = key_b;
  uint32_t *si = idx_a, *di = idx_b;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    uint32_t* cnt = cnt2 + (pass & 1) * kBins * kCntStride;
    // the next pass's counters (last read before this pass began)
    uint32_t* nxt = cnt2 + ((pass + 1) & 1) * kBins * kCntStride;
    for (int i = t; i < kBins * kCntStride; i += kCThreads) nxt[i] = 0;
    // rank each item within its warp: warp-striped positions, so the
    // block's order is (warp, item, lane)
    uint32_t item[kMaxItems];
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      item[u] = 0xffffffffu;
      if (u < items) {
        const int q = w * 32 * items + u * 32 + lane;
        const bool v = q < n;
        const uint32_t d =
            v ? (uint32_t)(sk[sw(q)] >> shift) & (kBins - 1) : kBins + lane;
        // the lanes with this lane's digit (an invalid lane stays alone)
        const uint32_t peers = __match_any_sync(0xffffffffu, d);
        uint32_t rk = 0;
        if (v) rk = cnt[d * kCntStride + w] + __popc(peers & lanemask_lt());
        __syncwarp();
        if (v && lane == __ffs(peers) - 1)
          cnt[d * kCntStride + w] += __popc(peers);
        __syncwarp();
        if (v) item[u] = (rk << 8) | d;
      }
    }
    __syncthreads();
    if (pass == 0) PROBE(15);
    // exclusive scan of the counters in (digit, warp) order: thread t
    // takes digit t / 8, warps (t % 8) * 4 .. + 3
    {
      const int d = t >> 3, w0 = (t & 7) * 4;
      uint32_t* row = cnt + d * kCntStride + w0;
      const uint32_t x0 = row[0], x1 = row[1], x2 = row[2], x3 = row[3];
      uint32_t total;
      const uint32_t ex = block_excl_sum(x0 + x1 + x2 + x3, misc, &total);
      row[0] = ex;
      row[1] = ex + x0;
      row[2] = ex + x0 + x1;
      row[3] = ex + x0 + x1 + x2;
      __syncthreads();
      if (t < kBins)
        hist[t] = (int32_t)((t + 1 < kBins ? cnt[(t + 1) * kCntStride]
                                           : total) -
                            cnt[t * kCntStride]);
    }
    if (pass == 0) PROBE(16);
    // local digit order
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      if (u < items && item[u] != 0xffffffffu) {
        const int q = w * 32 * items + u * 32 + lane;
        const uint32_t d = item[u] & 0xff;
        const int to = sw((int)(cnt[d * kCntStride + w] + (item[u] >> 8)));
        dk[to] = sk[sw(q)];
        di[to] = si[sw(q)];
      }
    }
    if (c == 1) {  // the local order is the pass's order
      __syncthreads();
      uint64_t* tk = sk;
      sk = dk;
      dk = tk;
      uint32_t* ti = si;
      si = di;
      di = ti;
      PROBE(2 + pass);
      continue;
    }
    cl.sync();  // local order done; every block's digit counts published
    if (pass == 0) PROBE(17);
    if (w == 0) {
      // lane l: digits 4l .. 4l + 3 over the cluster → each digit's first
      // global position for this block, less its first local one
      int32_t tot[4] = {0, 0, 0, 0}, below[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < c; k0 += 4) {  // four blocks' counts at once
        int4 h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k0 + k < c)
            h[k] = *reinterpret_cast<const int4*>(
                cl.map_shared_rank(hist, k0 + k) + 4 * lane);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k0 + k >= c) break;
          const int32_t x[4] = {h[k].x, h[k].y, h[k].z, h[k].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tot[j] += x[j];
            if (k0 + k < rank) below[j] += x[j];
          }
        }
      }
      const int32_t s4 = tot[0] + tot[1] + tot[2] + tot[3];
      int32_t inc = s4;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
      }
      int32_t ex = inc - s4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 4 * lane + j;
        gofs[d] = ex + below[j] - (int32_t)cnt[d * kCntStride];
        ex += tot[j];
      }
    }
    __syncthreads();
    if (pass == 0) PROBE(18);
    // each digit run to its global positions: contiguous remote stores
    for (int i = t; i < n; i += kCThreads) {
      const uint64_t k = dk[sw(i)];
      const int pos = gofs[(int)(k >> shift) & (kBins - 1)] + i;
      const int to = pos / chunk, at = sw(pos - to * chunk);
      cl.map_shared_rank(sk, to)[at] = k;
      cl.map_shared_rank(si, to)[at] = di[sw(i)];
    }
    cl.sync();
    PROBE(2 + pass);
  }

  // ---- per position (thread t: positions t·items .. + items - 1):
  // flags (bit 0 run start, 1 live, 2 best-effort, 3 over the domain,
  // 4 all-or-nothing grant); v1 = run start (max scan), v2 = cum_ao,
  // v3 = best-effort cumsum
  int32_t* v1 = reinterpret_cast<int32_t*>(dk);
  int32_t* v2 = v1 + cap;
  int32_t* v3 = reinterpret_cast<int32_t*>(di);
  uint8_t* flags = reinterpret_cast<uint8_t*>(cnt2);
  const uint64_t prev_last =
      rank > 0 ? cl.map_shared_rank(sk, rank - 1)[sw(chunk - 1)] >> lo_bits
               : 0;
  // each position's max and counter column, from its row's block, kept in
  // registers to the end
  int32_t pmx[kMaxItems], pcol[kMaxItems];
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    pmx[u] = pcol[u] = 0;
    if (u < items && q < n) {
      const int r = (int)(si[sw(q)] & 0x7fffffffu);
      const int owner = r / chunk, at = sw(r - owner * chunk);
      const uint64_t mc = owner == rank
                              ? row_mc[at]
                              : cl.map_shared_rank(row_mc, owner)[at];
      pmx[u] = (int32_t)(uint32_t)(mc >> 32);
      pcol[u] = (int32_t)(uint32_t)mc;
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    if (u < items && q < n) {
      const uint64_t k = sk[sw(q)];
      const uint64_t kb = k >> lo_bits;
      const bool start = (q > 0 ? (sk[sw(q - 1)] >> lo_bits) != kb
                                : rank == 0 || prev_last != kb);
      const bool lv = kb != sentinel;
      const bool be = seg && ((k >> abits) & 1);
      const bool over = (si[sw(q)] >> 31) != 0;
      const int32_t a_pos = (int32_t)(k & amask);
      flags[sw(q)] = (uint8_t)(start | (lv << 1) | (be << 2) | (over << 3));
      v1[sw(q)] = start ? base + q : 0;
      if (seg) {
        v2[sw(q)] = lv && !be && !over ? a_pos : 0;
        v3[sw(q)] = lv && be ? a_pos : 0;
      }
    }
  }
  if (seg) {
    int32_t* const cols[3] = {v1, v2, v3};
    cluster_seg_scan<3, 1u>(cl, c, rank, cols, flags, n, items, misc, 0);
  } else {
    int32_t* const cols[1] = {v1};
    cluster_seg_scan<1, 1u>(cl, c, rank, cols, flags, n, items, misc, 0);
  }
  PROBE(10);

  // ---- `used`, once per live bucket run, into v1 at the run's start
  // (every item's sum before any store)
  {
    int32_t used[kMaxItems];
    const int32_t* row[kMaxItems];
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      used[u] = 0;
      row[u] = nullptr;
      if (u < items && q < n && (flags[sw(q)] & 3) == 3)
        row[u] = a.slots + (long long)(int32_t)(sk[sw(q)] >> lo_bits) * a.K;
    }
#pragma unroll 4
    for (int p = 0; p < a.K; ++p) {
#pragma unroll
      for (int u = 0; u < kMaxItems; ++u)
        if (row[u] != nullptr) used[u] = wadd(used[u], row[u][p]);
    }
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      if (u < items && q < n && (flags[sw(q)] & 3) == 3) v1[sw(q)] = used[u];
    }
  }
  // every read of `used` is done: commits may start
  if (c > 1)
    cl.sync();
  else
    __syncthreads();
  PROBE(11);

  // avail = max - used of a live position (used: at its run's start, in
  // this block or the one that holds the start)
  auto avail_at = [&](int q, int32_t mx, int32_t* p0) -> int32_t {
    int32_t used;
    if (flags[sw(q)] & 1) {
      *p0 = base + q;
      used = v1[sw(q)];
    } else {
      *p0 = v1[sw(q)];
      const int owner = *p0 / chunk;
      used = owner == rank
                 ? v1[sw(*p0 - base)]
                 : cl.map_shared_rank(v1, owner)[sw(*p0 - owner * chunk)];
    }
    return wsub(mx, used);
  };
  // granted[r] and the commits of the grants in g_at (positions): one
  // atomicAdd per run of equal cells among the thread's consecutive
  // positions
  auto commit_all = [&](const int32_t* g_at) {
    long long cell = -1;
    int32_t sum = 0;
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      if (u >= items || q >= n) break;
      const int32_t g = g_at[sw(q)];
      a.granted[si[sw(q)] & 0x7fffffffu] = g;
      if (g == 0) continue;
      const long long here =
          (long long)(int32_t)(sk[sw(q)] >> lo_bits) * a.K + pcol[u];
      if (here != cell) {
        if (sum != 0) atomicAdd(a.slots + cell, sum);
        cell = here;
        sum = 0;
      }
      sum = wadd(sum, g);
    }
    if (sum != 0) atomicAdd(a.slots + cell, sum);
  };

  if (!seg) {  // unit: grant iff the rank in the run is < max - used
    int32_t av[kMaxItems], p0[kMaxItems];
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      av[u] = p0[u] = 0;
      if (u < items && q < n && (flags[sw(q)] & 2))
        av[u] = avail_at(q, pmx[u], &p0[u]);
    }
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int q = t * items + u;
      if (u < items && q < n)
        v2[sw(q)] = (flags[sw(q)] & 2) && (base + q - p0[u]) < av[u] ? 1 : 0;
    }
    PROBE(12);
    commit_all(v2);
    if (c > 1) cl.sync();  // no block exits while another may read it
    PROBE(14);
    return;
  }

  // seg: avail of every live item (read once, kept for the grants), the
  // all-or-nothing grants; v2 = granted cum_ao
  int32_t av[kMaxItems];
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    av[u] = 0;
    if (u < items && q < n && (flags[sw(q)] & 2)) {
      int32_t p0;
      av[u] = avail_at(q, pmx[u], &p0);
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    if (u < items && q < n) {
      const uint8_t f = flags[sw(q)];
      // live, all-or-nothing, inside the domain, > 0, within avail
      if ((f & 0xe) == 2 && (sk[sw(q)] & amask) > 0 && v2[sw(q)] <= av[u])
        flags[sw(q)] = f | 16;
      else
        v2[sw(q)] = 0;
    }
  }
  PROBE(12);
  {
    int32_t* const cols[1] = {v2};
    cluster_seg_scan<1, 1u>(cl, c, rank, cols, flags, n, items, misc, 1);
  }
  PROBE(13);
  // grants into v3: all-or-nothing as decided, best-effort from what is
  // left after the granted all-or-nothing running max
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int q = t * items + u;
    if (u < items && q < n) {
      const uint8_t f = flags[sw(q)];
      const int32_t a_pos = (int32_t)(sk[sw(q)] & amask);
      int32_t g = 0;
      if (f & 16) {
        g = a_pos;
      } else if ((f & 6) == 6) {
        const int32_t avp = av[u] < 0 ? 0 : av[u];
        int32_t rem = wsub(avp, v2[sw(q)]);
        rem = rem < 0 ? 0 : rem;
        const int32_t left = wsub(rem, wsub(v3[sw(q)], a_pos));
        g = a_pos < left ? a_pos : left;
        g = g < 0 ? 0 : g;
      }
      v3[sw(q)] = g;
    }
  }
  commit_all(v3);
  if (c > 1) cl.sync();  // no block exits while another may read it
  PROBE(14);
}

// one cluster launch of the contended modes → 0 or a CUDA error
cudaError_t launch_cluster(const Args& a, int mode, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cluster_smem(kMaxBlockRows));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  // about kBlockRows rows per block, more only past kMaxCluster blocks
  const int c = min(kMaxCluster, (a.B + kBlockRows - 1) / kBlockRows);
  const int chunk = (a.B + c - 1) / c;
  const int items = (chunk + kCThreads - 1) / kCThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)c);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = cluster_smem(kCThreads * items);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_kernel, a, mode, chunk, items);
}


// ---------------------------------------------------------------------------
// the multi-block path: unit and seg above kClusterRows rows, scan above
// kMaxRows
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
  PROBE_LAUNCH(0, st);
  mb_prep_kernel<<<g_pad, kThreads, 0, st>>>(a, sc, mode, n_pad);
  ++n;
  PROBE_LAUNCH(1, st);
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
  PROBE_LAUNCH(2, st);
  mb_seg_kernel<<<g_rows, kThreads, 0, st>>>(a, sc, mode);
  ++n;
  PROBE_LAUNCH(3, st);
  int stage = 4;
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
    PROBE_LAUNCH(stage++, st);
  };
  const int32_t* committed = sc.v1;
  if (mode == kUnit) {
    scan(true, sc.v1, nullptr);  // run start
    mb_unit_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    committed = sc.v2;
    ++n;
    PROBE_LAUNCH(stage++, st);
  } else if (mode == kScan) {
    mb_walk_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
  } else {
    mb_seg_ao_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
    PROBE_LAUNCH(stage++, st);
    scan(false, sc.v1, sc.seg);   // cum_ao
    mb_seg_grant_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
    PROBE_LAUNCH(stage++, st);
    scan(true, sc.v2, sc.seg);    // consumed_ao
    scan(false, sc.v1, sc.seg);   // best-effort cumsum
    mb_seg_final_kernel<<<g_rows, kThreads, 0, st>>>(a, sc);
    ++n;
    PROBE_LAUNCH(stage++, st);
  }
  mb_commit_kernel<<<g_rows, kThreads, 0, st>>>(a, sc.idx, committed);
  PROBE_LAUNCH(stage++, st);
  return n + 1;
}

}  // namespace

#ifdef KERNEL_PROBE
// The probe build only: stage stamps go to `buf` (nullptr: off) from the
// next launch on. Returns 0, or -cudaError_t.
extern "C" int quota_alloc_probe(unsigned long long* buf) {
  const cudaError_t e = cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf));
  return e == cudaSuccess ? 0 : -(int)e;
}
#endif

// Bytes of scratch a contended batch of B rows needs (0: fast mode, the
// cluster path and the one-block scan, which need none).
extern "C" int quota_alloc_scratch_bytes(int B, int mode) {
  if (mode == kFast || (mode != kScan && B <= kClusterRows) ||
      (mode == kScan && pad_rows(B) <= kMaxRows))
    return 0;
  return (int)scratch_layout(B, nullptr, nullptr);
}

// Returns the number of kernels launched, or -cudaError_t on failure
// (cudaErrorInvalidValue for a batch of the multi-block path given no
// scratch).
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
  } else if (mode != kScan && B <= kClusterRows) {
    const cudaError_t e = launch_cluster(a, mode, st);
    if (e != cudaSuccess) return -(int)e;
  } else if (mode == kScan && pad_rows(B) <= kMaxRows) {
    const int n_pad = (int)pad_rows(B);
    const size_t smem = (size_t)n_pad * (8 + 4 + 4 + 4 + 1);
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
    scan_kernel<<<1, kThreads, smem, st>>>(a, n_pad);
  } else {
    if (scratch == nullptr) return -(int)cudaErrorInvalidValue;
    launched = multi_block(a, mode, scratch, st);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? launched : -(int)e;
}
