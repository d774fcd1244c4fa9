// route_select — Pilot's batched route selection: the winner reduction
// over the matched plane, and the re-densify of a ragged byte plane.
//
// Replaces the JAX package's istio_tpu/pilot/route_nfa.py: `_winner`
// (:115, the selection tail of both device paths), the tail of
// `_select_on_device` (:256-268) and the re-densify half of
// `_select_on_device_compact` (:270-308). The match itself is K1
// (rule_match), K2 (dfa_scan) and K3 (byte_pred), as on every path.
//
// route_winner: matched uint8 [B, R] (row stride `stride`), weight int32
//   [R] → out int32 [B]. score[r] = matched[b, r] ? weight[r] : 0; out[b]
//   = the lowest r with the greatest score when that score is > 0, else
//   `default_index` (jnp.argmax takes the first maximum; hit = max > 0).
// route_densify: flat uint8 [cap], lens int16 [B, nbyte], presence
//   uint8 [B, P8] (bits little-endian), n_cols, L → str_bytes uint8
//   [B, nbyte, L], str_lens int32 [B, nbyte], present uint8 [B, n_cols]:
//     start    = exclusive int32 cumsum of lens over the flattened
//                [B·nbyte] (wrapping, as jnp's int32 cumsum);
//     str_bytes[b, s, j] = j < lens ? flat[clip(start + j, 0, cap-1)] : 0;
//     present[b, c] = (presence[b, c >> 3] >> (c & 7)) & 1.
//
// What bounds it on an H100: memory. The winner reads the B·R matched
// plane once (20 MB at B = 2048, R = 10,000) and writes 4 bytes a row;
// its work is one select and one compare per byte. The design: one
// block per row; consecutive threads read consecutive bytes of the row,
// each keeps the best (score, −index) as one 64-bit key, a warp-shuffle
// max then a shared-memory max over the 8 warps pick the winner.
// Densify moves the flat bytes in and the dense B·nbyte·L plane out;
// the scan of the lens is a few thousand int32. The design: a scan
// across blocks in three launches (per-tile sums, one block that scans
// the sums, per-tile offsets), then one thread per output byte; the
// presence unpack rides the first launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // lens per scan tile

__global__ void __launch_bounds__(kThreads)
    winner_kernel(const uint8_t* __restrict__ matched, long long stride,
                  int R, const int32_t* __restrict__ weight,
                  int default_index, int32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const uint8_t* row = matched + (long long)b * stride;
  // key = (score biased to unsigned) << 32 | (0xffffffff - index): the
  // greatest key has the greatest score and, among equal scores, the
  // lowest index. Unmatched entries score 0, as in matched * weight.
  unsigned long long best = 0ull;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int32_t score = row[r] != 0 ? weight[r] : 0;
    const unsigned long long key =
        ((unsigned long long)((uint32_t)score ^ 0x80000000u) << 32) |
        (unsigned long long)(0xffffffffu - (uint32_t)r);
    best = key > best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o > best ? o : best;
  }
  __shared__ unsigned long long s_best[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) best = s_best[w] > best ? s_best[w] : best;
    const bool hit = (uint32_t)(best >> 32) > 0x80000000u;  // max score > 0
    out[b] = hit ? (int32_t)(0xffffffffu - (uint32_t)best) : default_index;
  }
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// exclusive wrapping sum of v over the block's threads → (prefix, total)
__device__ int32_t block_exclusive(int32_t v, int32_t* total) {
  __shared__ int32_t s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = wadd(inc, o);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = wadd(before, s_warp[w]);
    all = wadd(all, s_warp[w]);
  }
  __syncthreads();  // s_warp is reused by the next call
  *total = all;
  return wadd(before, (int32_t)((uint32_t)inc - (uint32_t)v));
}

// launch 1: the sum of each tile of lens, the int32 copy of lens, and
// (grid-stride) the presence unpack
__global__ void __launch_bounds__(kThreads)
    tile_sums_kernel(const int16_t* __restrict__ lens16, long long N,
                     int32_t* __restrict__ lens32,
                     int32_t* __restrict__ sums,
                     const uint8_t* __restrict__ pres, int P8, int B,
                     int n_cols, uint8_t* __restrict__ present) {
  const long long base = (long long)blockIdx.x * kTile;
  int32_t acc = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + (long long)threadIdx.x * kPerThread + k;
    if (i < N) {
      const int32_t v = lens16[i];
      lens32[i] = v;
      acc = wadd(acc, v);
    }
  }
  int32_t total;
  block_exclusive(acc, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  const long long n_pres = (long long)B * n_cols;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_pres; i += (long long)gridDim.x * kThreads) {
    const long long b = i / n_cols;
    const int c = (int)(i - b * n_cols);
    present[i] = (pres[b * P8 + (c >> 3)] >> (c & 7)) & 1;
  }
}

// launch 2: one block turns the tile sums into exclusive tile offsets
__global__ void __launch_bounds__(kThreads)
    scan_sums_kernel(int32_t* __restrict__ sums, int n_tiles) {
  int32_t carry = 0;
  for (int lo = 0; lo < n_tiles; lo += kThreads) {
    const int i = lo + threadIdx.x;
    const int32_t v = i < n_tiles ? sums[i] : 0;
    int32_t total;
    const int32_t ex = block_exclusive(v, &total);
    if (i < n_tiles) sums[i] = wadd(carry, ex);
    carry = wadd(carry, total);
  }
}

// launch 3: the exclusive start of every slot
__global__ void __launch_bounds__(kThreads)
    starts_kernel(const int32_t* __restrict__ lens32, long long N,
                  const int32_t* __restrict__ tile_off,
                  int32_t* __restrict__ starts) {
  const long long first =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  int32_t v[kPerThread];
  int32_t acc = 0;
  for (int k = 0; k < kPerThread; ++k) {
    v[k] = first + k < N ? lens32[first + k] : 0;
    acc = wadd(acc, v[k]);
  }
  int32_t total;
  int32_t run = wadd(tile_off[blockIdx.x], block_exclusive(acc, &total));
  for (int k = 0; k < kPerThread; ++k) {
    if (first + k < N) starts[first + k] = run;
    run = wadd(run, v[k]);
  }
}

// launch 4: one thread per output byte
__global__ void __launch_bounds__(kThreads)
    fill_kernel(const uint8_t* __restrict__ flat, long long cap,
                const int32_t* __restrict__ lens32,
                const int32_t* __restrict__ starts, long long N, int L,
                uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N * L) return;
  const long long slot = i / L;
  const int j = (int)(i - slot * L);
  uint8_t byte = 0;
  if (j < lens32[slot]) {
    long long at = (long long)wadd(starts[slot], j);
    at = at < 0 ? 0 : (at > cap - 1 ? cap - 1 : at);
    byte = flat[at];
  }
  out[i] = byte;
}

}  // namespace

// Each entry point returns the number of kernels it launched, or
// -cudaError_t (cudaGetLastError right after the launches).
extern "C" int route_winner(const uint8_t* matched, long long stride, int B,
                            int R, const int32_t* weight, int default_index,
                            int32_t* out, void* stream) {
  if (B == 0) return 0;
  winner_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      matched, stride, R, weight, default_index, out);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

extern "C" int route_densify(const uint8_t* flat, long long cap,
                             const int16_t* lens16, int B, int nbyte,
                             const uint8_t* pres, int P8, int n_cols, int L,
                             int32_t* lens32, int32_t* sums, int32_t* starts,
                             uint8_t* str_bytes, uint8_t* present,
                             void* stream) {
  if (cap < 1) return -(int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * nbyte;
  const long long n_pres = (long long)B * n_cols;
  const long long n_tiles = (N + kTile - 1) / kTile;
  // launch 1 covers every tile, and at least one block for the presence
  const long long g1 = n_tiles > 0 ? n_tiles : (n_pres > 0 ? 1 : 0);
  if (g1 == 0) return 0;
  int n = 0;
  tile_sums_kernel<<<(unsigned)g1, kThreads, 0, st>>>(
      lens16, N, lens32, sums, pres, P8, B, n_cols, present);
  ++n;
  if (N > 0) {
    scan_sums_kernel<<<1, kThreads, 0, st>>>(sums, (int)n_tiles);
    starts_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(lens32, N, sums,
                                                           starts);
    const long long bytes = N * L;
    if (bytes > 0)
      fill_kernel<<<(unsigned)((bytes + kThreads - 1) / kThreads), kThreads,
                    0, st>>>(flat, cap, lens32, starts, N, L, str_bytes);
    n += bytes > 0 ? 3 : 2;
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
}
