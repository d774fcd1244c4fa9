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
// What bounds it on an H100: neither bytes nor operations. A batch is at
// most a few thousand rows touching as many 40-byte counter rows, well
// under a microsecond of memory traffic; the contended modes are a
// chain of dependent steps (sort, three segmented scans) in one block. The
// design: fast is one thread per row. The contended modes run in ONE
// block of 1024 threads with every row in shared memory: a bitonic sort
// of (64-bit key, row index) pairs (the index breaks ties, so the order is
// the reference's stable lexsort), block-wide segmented scans (a
// sequential pass over each thread's chunk, a Hillis-Steele scan of the
// chunk totals, a fix-up pass), and __syncthreads between the roll, the
// reads of `used` and the commits, so each bucket is rolled before any
// row reads it and read before any row commits to it. Duplicate rolls
// write the same zeros (the reference's idempotent multiply-scatter);
// commits are integer atomics, which commute. The row limit is what fits
// the 227 KB of shared memory a block may use: 26 bytes per row at the
// next power of two, so 8,192 rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // the contended modes' one block
constexpr int kFastThreads = 256;
constexpr int kMaxRows = 8192;
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

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure
// (cudaErrorInvalidValue for a contended batch above kMaxRows rows).
extern "C" int quota_alloc(int32_t* slots, int n_buckets, int K,
                           const int32_t* buckets, const int32_t* amounts,
                           const int32_t* be, const int32_t* mx,
                           const int32_t* active, const int32_t* ticks,
                           const int32_t* lasts, const int32_t* rolling,
                           int B, int mode, const int32_t* status,
                           const uint8_t* matched, int R,
                           const int32_t* rule_idx, const int32_t* rule_ns,
                           const int32_t* req_ns, int default_ns,
                           int32_t* granted, int32_t* gate_out, void* stream) {
  if (B == 0) return 0;
  if (K < 1 || mode < kScan || mode > kSeg)
    return -(int)cudaErrorInvalidValue;
  const Args a{slots,  n_buckets, K,       buckets, amounts, be,
               mx,     active,    ticks,   lasts,   rolling, B,
               status, matched,   R,       rule_idx, rule_ns, req_ns,
               default_ns, granted, gate_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFast) {
    fast_kernel<<<(B + kFastThreads - 1) / kFastThreads, kFastThreads, 0,
                  st>>>(a);
  } else {
    int n_pad = 1;
    while (n_pad < B) n_pad <<= 1;
    if (n_pad > kMaxRows) return -(int)cudaErrorInvalidValue;
    const size_t smem = (size_t)n_pad * (8 + 4 + 4 + 4 + 4 + 1 + 1) +
                        (size_t)kThreads * (4 + 1);
    const cudaError_t e = cudaFuncSetAttribute(
        contended_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return -(int)e;
    contended_kernel<<<1, kThreads, smem, st>>>(a, mode, n_pad);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
