// dfa_scan — multi-pattern DFA acceptance over padded byte rows.
//
// Replaces the JAX package's istio_tpu/ops/bytes_ops.py dfa_match (:186),
// dfa_match_many (:221), dfa_match_many_onehot (:263) and
// dfa_match_many_onehot_blocked (:317): three TPU formulations (flat
// gather scan, dense one-hot bf16 matmul, block-diagonal einsum) of ONE
// function, out[b, n] = accept[walk(starts[n], row b), n], where the walk
// consumes the row's first min(lens[b], L) bytes. The one-hot forms exist
// on the TPU only because its per-step gathers are slow; all values are
// 0/1 there, so they are exact and equal to this walk bit for bit.
//
// What bounds it on an H100: a dependent chain of table lookups. Each
// (row, pattern) walk is up to L serial loads (state → next state), so
// the kernel is latency-bound, not bandwidth-bound: the bytes it must
// move are B·L subject bytes plus B·N outputs. The design keeps every
// lookup on chip: the class-compressed table gt[:, rep] ([S, C] int32,
// pack_dfas_classes) and class_of[256] sit in shared memory whenever they
// fit in the 227 KB a block may use (else they are read through L1/L2),
// and one thread walks one (row, pattern) pair, so thousands of
// independent chains hide each other's latency. A thread stops at its
// own row's length, not at the batch's longest string.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90

template <bool kSmem>
__global__ void dfa_scan_kernel(const uint8_t* __restrict__ data,
                                long long data_stride,
                                const int32_t* __restrict__ lens,
                                long long lens_stride, int B, int L,
                                const int32_t* __restrict__ table,
                                const int32_t* __restrict__ class_of,
                                const int32_t* __restrict__ starts,
                                const uint8_t* __restrict__ accept, int S,
                                int C, int N, uint8_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int32_t* cls = class_of;
  const int32_t* tab = table;
  if (kSmem) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = class_of[i];
    const long long n_tab = (long long)S * C;
    for (long long i = threadIdx.x; i < n_tab; i += blockDim.x)
      smem[256 + i] = table[i];
    __syncthreads();
    cls = smem;
    tab = smem + 256;
  }
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N) return;
  const int b = (int)(idx / N);
  const int n = (int)(idx - (long long)b * N);
  int len = lens[(long long)b * lens_stride];
  len = len < 0 ? 0 : (len > L ? L : len);
  const uint8_t* row = data + (long long)b * data_stride;
  int st = starts[n];
  for (int i = 0; i < len; ++i) st = tab[st * C + cls[row[i]]];
  out[idx] = accept[(long long)st * N + n] ? 1 : 0;
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int dfa_scan(const uint8_t* data, long long data_stride,
                        const int32_t* lens, long long lens_stride, int B,
                        int L, const int32_t* table, const int32_t* class_of,
                        const int32_t* starts, const uint8_t* accept, int S,
                        int C, int N, uint8_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const size_t smem = (256 + (size_t)S * C) * sizeof(int32_t);
  if (smem <= kMaxSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        dfa_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return -(int)e;
    dfa_scan_kernel<true><<<blocks, kThreads, smem, s>>>(
        data, data_stride, lens, lens_stride, B, L, table, class_of, starts,
        accept, S, C, N, out);
  } else {
    dfa_scan_kernel<false><<<blocks, kThreads, 0, s>>>(
        data, data_stride, lens, lens_stride, B, L, table, class_of, starts,
        accept, S, C, N, out);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
