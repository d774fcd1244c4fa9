// check_pack — the packed int32 rows of one served Check() batch, the
// single array the host pulls after the fused step.
//
// Replaces the JAX package's istio_tpu/runtime/fused.py:315-360,
// FusedPlan._base_packer.<locals>.pack, with the bit-lane codec inside it
// (pack_bool_rows, fused.py:76, and unpack_bits, ops/bytes_ops.py:173).
// Output int32 [5 + W + Cw, B], one column per request row b:
//
//   row 0 status, 1 the TTL's f32 bits, 2 uses, 3 deny_rule, 4 err_count
//   (the batch scalar, broadcast);
//   rows 5 .. 5+W   item word w (W = ceil(n_items/32), absent when
//                   n_items == 0): bit j (little-endian, bit 31 reads
//                   negative) is the OR of
//                     referenced[b, j]                       (j < n_cols)
//                     OR over ns-visible rules r of pred bit j - n_cols
//                     OR over active rules r (matched and ns-visible) of
//                        inst bit j;
//   rows 5+W ..     overlay word c (Cw = ceil(C/32), absent when C == 0):
//                   bit k is the raw, ns-UNmasked matched[b, cols[32c+k]].
//
// ns-visible: the rule's bit in the request namespace's row of vis_words
// (runtime/fused.PackTables, the verdict fold's table; rule_words.cuh),
// the row looked up from vis_ns once per request row.
//
// The reference computes the two item ORs as int8 matmuls ([B,R]x[R,n])
// followed by > 0. The predicate-map OR depends on the namespace alone:
// it is the row's pred_ns words, computed at plan build. The instance OR
// is an OR of the active rules' 32-bit mask words, which is exact and
// needs no tensor cores.
//
// What bounds it on an H100: memory. It reads the [B, R] matched plane
// (20.5 MB at B=2048, R=10,008) once, plus the word tables; it does a few
// integer ops per 16 rules. The design: one warp per request row,
// kPackWarps rows a block; the lanes walk the row in 16-byte words (every
// word: gating a load on the table words, to skip words with no visible
// rule that carries an instance bit, was slower on the card, PERF.md §6),
// so one pass serves every instance word; the active rules are
// matched & vis & inst_any, and each ORs its IW instance words into
// registers (the first kRegWords) or the warp's words in shared memory
// (the rest, by shared atomics), reduced across the warp with
// __reduce_or_sync; the referenced and overlay bits are packed 32 at a
// time with __ballot_sync. No block barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rule_words.cuh"

// Request rows (warps) per block; chosen by A/B on the card (PERF.md).
#ifndef PACK_WARPS
#define PACK_WARPS 4
#endif

namespace {

using rule_words::kFull;
using rule_words::kUnroll;

constexpr int kPackWarps = PACK_WARPS;
constexpr int kPackThreads = 32 * kPackWarps;
constexpr int kRegWords = 8;  // instance words a lane keeps in registers

// 32 bits of the pred-map bitstring P (PW words) starting at bit `base`
// (which may be negative: the bits below 0 read 0).
__device__ __forceinline__ uint32_t bits_at(const uint32_t* P, int PW,
                                            int base) {
  if (base >= 32 * PW || base <= -32) return 0u;
  if (base < 0) return PW > 0 ? (P[0] << (-base)) : 0u;
  const int lo = base >> 5, sh = base & 31;
  uint32_t v = P[lo] >> sh;
  if (sh && lo + 1 < PW) v |= P[lo + 1] << (32 - sh);
  return v;
}

__global__ void __launch_bounds__(kPackThreads) check_pack_kernel(
    const int32_t* __restrict__ status, const float* __restrict__ dur,
    const int32_t* __restrict__ uses, const int32_t* __restrict__ deny_rule,
    const int32_t* __restrict__ err_count,
    const uint8_t* __restrict__ referenced, int ref_stride, int n_cols,
    const uint8_t* __restrict__ matched, int B, int R,
    const int32_t* __restrict__ req_ns, const int32_t* __restrict__ vis_ns,
    int V, const uint32_t* __restrict__ vis_words,
    const uint32_t* __restrict__ inst_any,
    const uint32_t* __restrict__ inst_bits, int IW,
    const uint32_t* __restrict__ pred_ns, int PW, int W,
    const int32_t* __restrict__ cols, int C, int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_inst[];  // [kPackWarps][IW - kRegWords]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kPackWarps + warp;
  if (b >= B) return;  // the whole warp
  const uint8_t* mrow = matched + (long long)b * R;
  const int row = rule_words::vis_row(vis_ns, V, req_ns[b]);

  if (lane == 0) {
    out[0LL * B + b] = status[b];
    out[1LL * B + b] = __float_as_int(dur[b]);
    out[2LL * B + b] = uses[b];
    out[3LL * B + b] = deny_rule[b];
    out[4LL * B + b] = err_count[0];
  }

  // the OR of the instance words of the row's active rules
  const int XW = max(IW - kRegWords, 0);
  uint32_t* xs = s_inst + warp * XW;
  for (int k = lane; k < XW; k += 32) xs[k] = 0u;
  __syncwarp();
  uint32_t acc[kRegWords];
#pragma unroll
  for (int k = 0; k < kRegWords; ++k) acc[k] = 0u;
  auto take = [&](int g, uint32_t act) {  // act: active rules from g
    for (; act; act &= act - 1) {
      const uint32_t* iw = inst_bits + (long long)(g + __ffs(act) - 1) * IW;
#pragma unroll
      for (int k = 0; k < kRegWords; ++k)
        if (k < IW) acc[k] |= iw[k];
      for (int k = kRegWords; k < IW; ++k) atomicOr(xs + k - kRegWords, iw[k]);
    }
  };
  if (IW > 0) {
    const uint32_t* vis = vis_words + (long long)row * ((R + 31) / 32);
    const rule_words::RowSplit s(mrow, R);
    const int j1 = s.single_byte(lane, R);
    if (j1 >= 0 && mrow[j1])
      take(j1, rule_words::table_bits(vis, j1, 1) &
                   rule_words::table_bits(inst_any, j1, 1));
    const uint4* m4 = reinterpret_cast<const uint4*>(mrow + s.head);
    for (int c0 = lane; c0 < s.body; c0 += 32 * kUnroll) {
      uint4 mq[kUnroll];
      uint32_t a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        mq[u] = make_uint4(0u, 0u, 0u, 0u);
        a[u] = 0u;
        if (c < s.body) {
          const int g = s.head + 16 * c;
          a[u] = rule_words::table_bits(vis, g, 16) &
                 rule_words::table_bits(inst_any, g, 16);
          mq[u] = m4[c];  // not gated on a: see the header
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        take(s.head + 16 * (c0 + 32 * u),
             rule_words::nonzero16(mq[u]) & a[u]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRegWords; ++k) acc[k] = __reduce_or_sync(kFull, acc[k]);
  __syncwarp();  // the shared words are complete

  // item words, one per round: referenced bits by ballot, the
  // namespace's pred words, the instance OR
  const uint32_t* pred = pred_ns + (long long)row * PW;
  for (int w = 0; w < W; ++w) {
    const int j = 32 * w + lane;
    const bool rb = j < n_cols && referenced[(long long)b * ref_stride + j];
    const uint32_t refw = __ballot_sync(kFull, rb);
    if (lane == 0) {
      uint32_t v = refw | bits_at(pred, PW, 32 * w - n_cols);
#pragma unroll
      for (int k = 0; k < kRegWords; ++k)
        if (k == w) v |= acc[k];
      if (w >= kRegWords && w < IW) v |= xs[w - kRegWords];
      out[(long long)(5 + w) * B + b] = (int32_t)v;
    }
  }
  // overlay words: raw matched bits of the overlay columns, by ballot
  const int Cw = (C + 31) / 32;
  for (int c = 0; c < Cw; ++c) {
    const int k = 32 * c + lane;
    const bool v = k < C && mrow[cols[k]] != 0;
    const uint32_t word = __ballot_sync(kFull, v);
    if (lane == 0) out[(long long)(5 + W + c) * B + b] = (int32_t)word;
  }
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
// vis_ns [V] and vis_words [V + 1, ceil(R / 32)]: the verdict fold's
// namespace rows; inst_any [ceil(R / 32)]: the rules with any instance
// bit; inst_bits [R, IW]; pred_ns [V + 1, PW]: each namespace row's
// predicate-map words (runtime/fused.PackTables).
extern "C" int check_pack(const int32_t* status, const float* dur,
                          const int32_t* uses, const int32_t* deny_rule,
                          const int32_t* err_count, const uint8_t* referenced,
                          int ref_stride, int n_cols, const uint8_t* matched,
                          int B, int R, const int32_t* req_ns,
                          const int32_t* vis_ns, int V,
                          const uint32_t* vis_words,
                          const uint32_t* inst_any,
                          const uint32_t* inst_bits, int IW,
                          const uint32_t* pred_ns, int PW, int W,
                          const int32_t* cols, int C, int32_t* out,
                          void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      (size_t)kPackWarps * (size_t)(IW > kRegWords ? IW - kRegWords : 0) *
      sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        check_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (a != cudaSuccess) return -(int)a;
  }
  const unsigned blocks = (unsigned)((B + kPackWarps - 1) / kPackWarps);
  check_pack_kernel<<<blocks, kPackThreads, smem, s>>>(
      status, dur, uses, deny_rule, err_count, referenced, ref_stride,
      n_cols, matched, B, R, req_ns, vis_ns, V, vis_words, inst_any,
      inst_bits, IW, pred_ns, PW, W, cols, C, out);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
