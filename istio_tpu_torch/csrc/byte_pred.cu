// byte_pred — constant startsWith / endsWith / exact / glob predicates of
// one subject byte plane against P patterns.
//
// Replaces the constant part of the JAX package's istio_tpu/ops/
// bytes_ops.py (:26-78): prefix_match, suffix_match, exact_match and
// glob_match. The JAX package traces one such function per rule atom;
// the port's ruleset groups all constant atoms over one subject, so one
// launch answers every pattern of that subject: out[b, p] for kind[p] in
//   0 prefix: plens 0 → true; k > L → false; else lens >= k and
//             row[0:k] == pat
//   1 suffix: plens 0 → true; k > L → false; else lens >= k and
//             row[lens-k : lens] == pat (offsets clipped to [0, L-1])
//   2 exact : k > L → false; else lens == k and the whole row equals the
//             pattern zero-padded to L
// Globs are mapped to these kinds on the host (trailing '*' → prefix,
// leading '*' → suffix, else exact; "*" is an empty prefix).
//
// What bounds it on an H100: memory. The work is at most Lp (or L for
// exact) byte compares per (row, pattern), a few hundred thousand per
// batch; the bytes that must move are the B·L subject plane, the B
// lengths and the B·P outputs. One thread computes one (row, pattern)
// cell; neighbouring threads take neighbouring patterns of one row, so
// a warp reads one subject row (cached) and writes one contiguous run of
// output bytes. The patterns are a few hundred bytes and stay in L1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void byte_pred_kernel(const uint8_t* __restrict__ data,
                                 long long data_stride,
                                 const int32_t* __restrict__ lens,
                                 long long lens_stride, int B, int L,
                                 const uint8_t* __restrict__ pats,
                                 const int32_t* __restrict__ plens,
                                 const int32_t* __restrict__ kind, int P,
                                 int Lp, uint8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const int b = (int)(idx / P);
  const int p = (int)(idx - (long long)b * P);
  const int k = plens[p];
  const int kd = kind[p];
  const int len = lens[(long long)b * lens_stride];
  const uint8_t* row = data + (long long)b * data_stride;
  const uint8_t* pat = pats + (long long)p * Lp;
  bool hit;
  if (k > L) {
    hit = false;
  } else if (kd == 2) {  // exact
    hit = (len == k);
    for (int j = 0; hit && j < L; ++j) hit = row[j] == (j < k ? pat[j] : 0);
  } else if (k == 0) {
    hit = true;
  } else {
    hit = len >= k;
    const int start = (kd == 1) ? len - k : 0;
    for (int j = 0; hit && j < k; ++j) {
      int o = start + j;
      o = o < 0 ? 0 : (o > L - 1 ? L - 1 : o);
      hit = row[o] == pat[j];
    }
  }
  out[idx] = hit ? 1 : 0;
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
extern "C" int byte_pred(const uint8_t* data, long long data_stride,
                         const int32_t* lens, long long lens_stride, int B,
                         int L, const uint8_t* pats, const int32_t* plens,
                         const int32_t* kind, int P, int Lp, uint8_t* out,
                         void* stream) {
  const long long total = (long long)B * P;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  byte_pred_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, data_stride, lens, lens_stride, B, L, pats, plens, kind, P, Lp,
      out);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
