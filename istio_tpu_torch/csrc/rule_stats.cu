// rule_stats — fold one check batch's per-rule counts into the resident
// rule-telemetry accumulators, in place.
//
// Replaces the JAX package's istio_tpu/runtime/rulestats.py:165-201,
// RuleTelemetry._make_delta.<locals>.delta, and the fold lambda at :161
// ((h, d, e) + delta), as one pass that adds straight into the int32
// accumulators:
//
//   hit [slot(b), r]            += matched & ns_ok & real
//   deny[slot(b), deny_rule[b]] += status != OK & real  (deny_rule in [0,R))
//   err [r]                     += err & ns_ok & real & err_rows[r]
//
// with ns_ok = rule_ns[r] == default_ns | rule_ns[r] == req_ns[b] and
// slot(b) = S-1 for an unknown namespace (req_ns < 0), else
// min(req_ns, S-1). Padding rows (real == 0) never count; host-fallback
// rows are masked out of err by err_rows. The counters stay int32 and
// exact (integer atomics commute).
//
// What bounds it on an H100: memory. It must stream the matched and err
// planes, 2·B·R bytes (41 MB at B = 2,048, R = 10,008: 0.0122 ms at
// 3.35 TB/s, less where rule_match left them in the 50 MB L2), and it
// does a few integer operations per byte. (The bound chip_smoke prints
// counts only the cells a row's namespace sees, but the served world
// interleaves rule namespaces, so almost every 32-byte sector holds one.)
//
// The design: a streaming kernel. Each thread owns a run of 8
// consecutive rule columns and reads them as one 8-byte word of matched
// and one of err per row: an aligned load, or two aligned loads and a
// funnel shift where R is not a multiple of 8 (never a misaligned vector
// load), bytes only for the ragged last run and at the plane's end.
// Several rows' words are loaded before any is used. A block stages its
// chunk of rows once in shared memory (row, namespace, slot), real rows
// only, ordered by slot, so each column's hit count for the current slot
// and its err count live in registers; a hit register is flushed with
// one atomicAdd when it is non-zero and the slot changes. Blocks are
// (column runs × rows): 256 threads, as many column runs as the rule axis
// has (up to 256), and, where it has fewer, several row lanes; row chunks
// sized so the grid is about three blocks per SM. The deny cell is one
// atomicAdd per non-OK real row, made by the first column block. One
// code path serves any S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;           // rule columns per thread
constexpr int kChunkMax = kThreads;  // rows staged per block
constexpr int kUnroll = 4;         // rows loaded before use
constexpr int kBlocksPerSm = 3;

__device__ __forceinline__ int slot_of(int ns, int S) {
  return ns < 0 ? S - 1 : (ns < S - 1 ? ns : S - 1);
}

// The n <= 8 bytes at base[o, o + n) as a little-endian word: one aligned
// load, two aligned loads and a shift, or bytes (the ragged run, or a
// shifted pair that would reach outside [base, base + total)).
__device__ __forceinline__ uint64_t load_run(const uint8_t* __restrict__ base,
                                             long long o, long long total,
                                             int n) {
  const uint8_t* p = base + o;
  if (n == kCols) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const int sh = (int)(a & 7);
    const uintptr_t al = a - sh;
    if (sh == 0) return __ldg(reinterpret_cast<const unsigned long long*>(p));
    if (al >= reinterpret_cast<uintptr_t>(base) &&
        al + 16 <= reinterpret_cast<uintptr_t>(base + total)) {
      const unsigned long long* w =
          reinterpret_cast<const unsigned long long*>(al);
      return (__ldg(w) >> (8 * sh)) | (__ldg(w + 1) << (64 - 8 * sh));
    }
  }
  uint64_t v = 0;
  for (int j = 0; j < n; ++j) v |= (uint64_t)__ldg(p + j) << (8 * j);
  return v;
}

__global__ void __launch_bounds__(kThreads) rule_stats_kernel(
    const uint8_t* __restrict__ matched, const uint8_t* __restrict__ err,
    const int32_t* __restrict__ status, const int32_t* __restrict__ deny_rule,
    const int32_t* __restrict__ req_ns, const uint8_t* __restrict__ real,
    int B, int R, const int32_t* __restrict__ rule_ns, int default_ns, int S,
    const uint8_t* __restrict__ err_rows, int32_t* __restrict__ hit,
    int32_t* __restrict__ deny, int32_t* __restrict__ err_acc, int gx,
    int chunk) {
  __shared__ int s_key[kChunkMax];
  __shared__ int s_row[kChunkMax];
  __shared__ int s_ns[kChunkMax];
  __shared__ int s_slot[kChunkMax];
  const int t = threadIdx.x;
  const int b0 = blockIdx.y * chunk;
  const int n = min(chunk, B - b0);

  // stage the chunk's real rows, keyed (slot, row); the first column
  // block also makes the chunk's deny adds
  int key = 0x7fffffff, ns = 0;
  if (t < n) {
    const int b = b0 + t;
    if (real[b]) {
      ns = req_ns[b];
      key = slot_of(ns, S) * kChunkMax + t;
      const int dr = deny_rule[b];
      if (blockIdx.x == 0 && status[b] != 0 && dr >= 0 && dr < R)
        atomicAdd(&deny[(long long)slot_of(ns, S) * R + dr], 1);
    }
  }
  s_key[t] = key;
  __syncthreads();
  const bool mine = key != 0x7fffffff;
  if (mine) {
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += s_key[j] < key;
    s_row[rank] = b0 + t;
    s_ns[rank] = ns;
    s_slot[rank] = key / kChunkMax;
  }
  const int n_real = __syncthreads_count(mine);

  const int x = t % gx, y = t / gx, gy = kThreads / gx;
  const int c0 = (blockIdx.x * gx + x) * kCols;
  if (c0 >= R) return;
  const int nc = min(kCols, R - c0);
  int rn[kCols];
  uint32_t is_def = 0, count_err = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    rn[j] = j < nc ? rule_ns[c0 + j] : default_ns - 1;
    if (j < nc && rn[j] == default_ns) is_def |= 1u << j;
    if (j < nc && err_rows[c0 + j]) count_err |= 1u << j;
  }
  const long long total = (long long)B * R;
  int32_t h[kCols], e[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) h[j] = e[j] = 0;
  int cur = -1;
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (h[j]) {
        atomicAdd(&hit[(long long)cur * R + c0 + j], h[j]);
        h[j] = 0;
      }
  };
  for (int k = y; k < n_real; k += gy * kUnroll) {
    uint64_t m[kUnroll], ev[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = k + u * gy;
      if (kk < n_real) {
        const long long o = (long long)s_row[kk] * R + c0;
        m[u] = load_run(matched, o, total, nc);
        ev[u] = load_run(err, o, total, nc);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = k + u * gy;
      if (kk >= n_real) break;
      const int slot = s_slot[kk];
      if (slot != cur) {
        flush();
        cur = slot;
      }
      const int rns = s_ns[kk];
      // vis is 0 or 1, so `vis & word >> 8j` is bit 0 of byte j (the
      // planes hold 0 / 1 bytes)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int vis = ((is_def >> j) & 1) | (rn[j] == rns);
        h[j] += vis & (int)(m[u] >> (8 * j));
        e[j] += vis & (int)(count_err >> j) & (int)(ev[u] >> (8 * j));
      }
    }
  }
  if (cur >= 0) flush();
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (e[j]) atomicAdd(&err_acc[c0 + j], e[j]);
}

int num_sms() {
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

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int rule_stats(const uint8_t* matched, const uint8_t* err,
                          const int32_t* status, const int32_t* deny_rule,
                          const int32_t* req_ns, const uint8_t* real, int B,
                          int R, const int32_t* rule_ns, int default_ns,
                          int S, const uint8_t* err_rows, int32_t* hit,
                          int32_t* deny, int32_t* err_acc, void* stream) {
  if (B == 0 || R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int runs = (R + kCols - 1) / kCols;
  int gx = 1;
  while (gx < runs && gx < kThreads) gx <<= 1;
  const int gy = kThreads / gx;
  const int col_blocks = (runs + gx - 1) / gx;
  const int want = (kBlocksPerSm * num_sms() + col_blocks - 1) / col_blocks;
  int chunk = (B + want - 1) / want;
  chunk = max(chunk, min(2 * gy, kChunkMax));
  chunk = min(chunk, kChunkMax);
  const dim3 grid((unsigned)col_blocks, (unsigned)((B + chunk - 1) / chunk));
  rule_stats_kernel<<<grid, kThreads, 0, st>>>(
      matched, err, status, deny_rule, req_ns, real, B, R, rule_ns,
      default_ns, S, err_rows, hit, deny, err_acc, gx, chunk);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
