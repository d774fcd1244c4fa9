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
//   chunk_map     one thread per (chunk c, row b, entry state s) walks
//      the chunk's local_len = clip(lens[b] - (c0 + c) * Lc, 0, Lc) bytes
//      from state s and writes maps[c, b, s]; a chunk past the row's end
//      (local_len 0) is the identity map. The [S, 256] int32 table sits
//      in dynamic shared memory while S KB fit the 227 KB a block may use
//      (above 48 KB after cudaFuncSetAttribute); past that it is read
//      through L1. A grid of a few blocks per SM strides over the work,
//      so each block loads the table once.
//   compose_maps  one thread per (row b, entry state s) folds the C maps
//      LEFT TO RIGHT in chunk order, acc = maps[c, b, acc] (the JAX
//      package's take_along_axis(nxt, acc)), and writes out[b, s]; given
//      `accept`, one thread per row folds from entry state `entry` and
//      writes accept[final] (sharded_dfa_match's last gather, fused).
//
// What bounds it on an H100: neither bytes nor operations. Each walk is a
// dependent chain of Lc table lookups (state -> next state), so the kernel
// is latency-bound; B * C * S independent chains (2048 * 64 * S at the
// headline layout) hide each other's latency. The bytes it must move are
// the B * L subject bytes once, plus the C * B * S int32 maps written and
// the table. Threads of one (c, b) read the same byte at each step: a
// warp broadcast, not S separate loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90
constexpr size_t kDefaultSmem = 49152;  // without cudaFuncSetAttribute
constexpr int kBlocksPerSm = 4;

template <bool kSmem>
__global__ void chunk_map_kernel(const uint8_t* __restrict__ data,
                                 long long row_stride, int Lc,
                                 const int32_t* __restrict__ lens, int B,
                                 int C, int c0,
                                 const int32_t* __restrict__ trans, int S,
                                 int32_t* __restrict__ maps) {
  extern __shared__ int32_t s_trans[];
  const int32_t* tab = trans;
  if (kSmem) {
    const int n = S * 256;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_trans[i] = trans[i];
    __syncthreads();
    tab = s_trans;
  }
  const long long total = (long long)C * B * S;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < total; w += step) {
    const int s = (int)(w % S);
    const long long cb = w / S;
    const int b = (int)(cb % B);
    const int c = (int)(cb / B);
    long long len = (long long)lens[b] - (long long)(c0 + c) * Lc;
    const int n = len < 0 ? 0 : (len > Lc ? Lc : (int)len);
    const uint8_t* row = data + (long long)b * row_stride + (long long)c * Lc;
    int st = s;
    for (int i = 0; i < n; ++i) st = tab[st * 256 + __ldg(row + i)];
    maps[w] = st;
  }
}

__global__ void compose_kernel(const int32_t* __restrict__ maps, int C,
                               int B, int S, int32_t* __restrict__ out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)B * S) return;
  const int b = (int)(w / S);
  int acc = (int)(w - (long long)b * S);
  for (int c = 0; c < C; ++c) acc = maps[((long long)c * B + b) * S + acc];
  out[w] = acc;
}

__global__ void compose_accept_kernel(const int32_t* __restrict__ maps,
                                      int C, int B, int S,
                                      const uint8_t* __restrict__ accept,
                                      int entry, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int acc = entry;
  for (int c = 0; c < C; ++c) acc = maps[((long long)c * B + b) * S + acc];
  out[b] = accept[acc] != 0;
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

}  // namespace

// maps [C, B, S] int32 of the C chunks data[b, c0 + c, :Lc] (row b at
// data + b * row_stride, chunk c at + c * Lc). Returns the number of
// kernels launched (1), or -cudaError_t on failure.
extern "C" int chunk_map(const uint8_t* data, long long row_stride, int Lc,
                         const int32_t* lens, int B, int C, int c0,
                         const int32_t* trans, int S, int32_t* maps,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)C * B * S;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const size_t smem = (size_t)S * 256 * sizeof(int32_t);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          chunk_map_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return -(int)e;
    }
    chunk_map_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(
        data, row_stride, Lc, lens, B, C, c0, trans, S, maps);
  } else {
    chunk_map_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        data, row_stride, Lc, lens, B, C, c0, trans, S, maps);
  }
  const cudaError_t e = cudaGetLastError();
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
  if (accept == nullptr) {
    const long long total = (long long)B * S;
    compose_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                     0, st>>>(maps, C, B, S, static_cast<int32_t*>(out));
  } else {
    compose_accept_kernel<<<(unsigned)((B + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(
        maps, C, B, S, accept, entry, static_cast<uint8_t*>(out));
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
