// list_banks — membership of the byte-level list banks: REGEX lists over
// the DFA acceptance of their patterns, and IP_ADDRESSES lists as CIDR
// prefix compares in v6-mapped space.
//
// Replaces the JAX package's istio_tpu/models/policy_engine.py:439-502,
// the REGEX bank fold (the M / M_def int8 products after the DFA scan)
// and the CIDR compare of PolicyEngine.__init__.<locals>.step. Both
// kernels write one state byte per (request row b, list position) into
// lstate [B, NL] (bit 0 member, bit 1 und, bit 2 bad), which the
// verdict_fold kernel reads for every REGEX / IP_ADDRESSES list in place
// of its id scan. Two launches on the caller's stream, each skipped when
// its bank is empty:
//
//   1. regex_list  one thread per (b, REGEX list j). The list's patterns
//      are a CSR row (ptr / pat: columns of the DFA acceptance plane acc
//      [B, N], the dfa_scan kernel's output over every bank). hit = OR of
//      acc over the list's patterns, dec = the same OR over its $-free
//      patterns (pdef), trunc = the value's byte length >= max_len; member
//      = trunc ? dec : hit, und = trunc & !dec (a truncated value whose
//      match is not decided by a $-free prefix hit). Where und holds the
//      list's rule row of the err plane [B, R] is set to 1 in place, as
//      the reference's err.at[:, list_rule].max(und) does; lists may share
//      a rule, and an idempotent store of 1 is safe there.
//   2. cidr_list   one thread per (b, CIDR list k), reading the value's
//      first 16 bytes and its length from its byte slot. A length-4 value
//      maps to ::ffff:a.b.c.d; the value is v4 for length 4, or length 16
//      with the v4-mapped prefix; member = any entry e with valid[e] and
//      (v & mask[e]) == prefix[e] and v4(value) == v4(e), and a value
//      whose length is neither 4 nor 16 is bad (member false).
//
// What bounds it on an H100: neither kernel moves much. regex_list reads
// B·nnz acceptance bytes (nnz = the CSR's pattern entries) and writes B
// state bytes per list; cidr_list reads 16 value bytes per (row, list)
// and 33 bytes per entry from L1 (the entry tables are shared by every
// row). Both are a launch and a few loads per thread: latency, not
// bandwidth, sets their time at the served batch sizes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void regex_list_kernel(
    const uint8_t* __restrict__ acc, int B, int N,
    const int32_t* __restrict__ str_lens, long long sl_b, long long sl_s,
    int max_len, int J, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ rule,
    const int32_t* __restrict__ bslot, const int32_t* __restrict__ ptr,
    const int32_t* __restrict__ pat, const uint8_t* __restrict__ pdef,
    uint8_t* __restrict__ lstate, int NL, uint8_t* __restrict__ err, int R) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * J) return;
  const int b = (int)(t / J);
  const int j = (int)(t % J);
  const uint8_t* a_row = acc + (long long)b * N;
  bool hit = false, dec = false;
  for (int i = ptr[j]; i < ptr[j + 1]; ++i) {
    const int p = pat[i];
    if (a_row[p]) {
      hit = true;
      if (pdef[p]) {
        dec = true;
        break;
      }
    }
  }
  const bool trunc = str_lens[b * sl_b + bslot[j] * sl_s] >= max_len;
  const bool member = trunc ? dec : hit;
  const bool und = trunc && !dec;
  lstate[(long long)b * NL + pos[j]] = (uint8_t)(member | (und << 1));
  if (und) err[(long long)b * R + rule[j]] = 1;
}

__global__ void cidr_list_kernel(
    const uint8_t* __restrict__ str_bytes, long long sb_b, long long sb_s,
    int B, const int32_t* __restrict__ str_lens, long long sl_b,
    long long sl_s, int K, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ bslot, int E,
    const uint8_t* __restrict__ prefix,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ ent_v4, uint8_t* __restrict__ lstate,
    int NL) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * K) return;
  const int b = (int)(t / K);
  const int k = (int)(t % K);
  const uint8_t* vb = str_bytes + b * sb_b + bslot[k] * sb_s;
  const int32_t len = str_lens[b * sl_b + bslot[k] * sl_s];
  const bool is4 = len == 4;
  const bool val_ok = is4 || len == 16;
  uint8_t v[16];
  bool mapped = true;  // the 16 bytes carry the ::ffff:0:0/96 prefix
  for (int i = 0; i < 16; ++i) {
    const uint8_t x = vb[i];
    if (i < 12) mapped = mapped && x == (i < 10 ? 0 : 255);
    if (is4) v[i] = i < 10 ? 0 : (i < 12 ? 255 : vb[i - 12]);
    else v[i] = x;
  }
  const bool val_v4 = is4 || (len == 16 && mapped);
  bool member = false;
  const long long base = (long long)k * E;
  for (int e = 0; e < E && !member; ++e) {
    if (!valid[base + e] || (ent_v4[base + e] != 0) != val_v4) continue;
    const uint8_t* m = mask + (base + e) * 16;
    const uint8_t* p = prefix + (base + e) * 16;
    bool eq = true;
    for (int i = 0; i < 16 && eq; ++i) eq = (v[i] & m[i]) == p[i];
    member = eq;
  }
  lstate[(long long)b * NL + pos[k]] =
      (uint8_t)((member && val_ok) | ((!val_ok) << 2));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point returns the number of kernels launched (0 or 1), or
// -cudaError_t on failure.
extern "C" int regex_list(const uint8_t* acc, int B, int N,
                          const int32_t* str_lens, long long sl_b,
                          long long sl_s, int max_len, int J,
                          const int32_t* pos, const int32_t* rule,
                          const int32_t* bslot, const int32_t* ptr,
                          const int32_t* pat, const uint8_t* pdef,
                          uint8_t* lstate, int NL, uint8_t* err, int R,
                          void* stream) {
  if (B == 0 || J == 0) return 0;
  regex_list_kernel<<<blocks_for((long long)B * J), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      acc, B, N, str_lens, sl_b, sl_s, max_len, J, pos, rule, bslot, ptr,
      pat, pdef, lstate, NL, err, R);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

extern "C" int cidr_list(const uint8_t* str_bytes, long long sb_b,
                         long long sb_s, int B, const int32_t* str_lens,
                         long long sl_b, long long sl_s, int K,
                         const int32_t* pos, const int32_t* bslot, int E,
                         const uint8_t* prefix,
                         const uint8_t* mask, const uint8_t* valid,
                         const uint8_t* ent_v4, uint8_t* lstate, int NL,
                         void* stream) {
  if (B == 0 || K == 0) return 0;
  cidr_list_kernel<<<blocks_for((long long)B * K), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      str_bytes, sb_b, sb_s, B, str_lens, sl_b, sl_s, K, pos, bslot, E,
      prefix, mask, valid, ent_v4, lstate, NL);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
