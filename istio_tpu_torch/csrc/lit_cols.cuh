// lit_cols.cuh — what a subject group writes into rule_match's ext planes.
//
// byte_lits (byte_pred.cu) and dfa_lits (dfa_scan.cu) answer every
// pattern of one subject group and write each pattern's literal pair
// straight into its column of the bool [B, X] planes em / en that
// rule_match reads: m = val ∧ ¬ee, n = ¬val ∧ ¬ee (the reference's
// parts_m / parts_n, istio_tpu/compiler/ruleset.py:826-835), with the
// group's absence, error and truncation rules (istio_tpu/compiler/
// tensor_expr.py _compile_byte_pred and compile_dfa_group):
//   ee = err ∨ ¬ok, or on a possibly truncated row (ok ∧ len >= max_len)
//        where the column's mode says so:
//          kSafe  never (a prefix read decides a truncated row),
//          kMiss  where the pattern missed (an unanchored regex hit in
//                 the stored prefix is a hit in the whole value),
//          kAll   always (suffix, cap-length exact, `$`-anchored regex).
#pragma once

#include <stdint.h>

namespace lits {

// a column's truncation mode (ops/bytes_ops.py TRUNC_SAFE / _MISS / _ALL)
constexpr int kSafe = 0, kMiss = 1, kAll = 2;

// the subject's row view beside its bytes: ok null = present on every
// row (a constant), err null = never an error (a plain attribute)
struct Subject {
  const int32_t* lens;
  long long lens_stride;
  const uint8_t* ok;
  long long ok_stride;
  const uint8_t* err;
  long long err_stride;
  int max_len;
};

// where the literal pairs go: bool [B, X] planes with one row stride
struct Planes {
  uint8_t* m;
  uint8_t* n;
  long long stride;
};

// a byte store the compiler need not order against shared-memory loads
// (an output plane is always global; a generic store is not known to be)
__device__ __forceinline__ void st_global_u8(uint8_t* p, unsigned v) {
  asm volatile("st.global.u8 [%0], %1;\n" ::"l"(p), "r"(v));
}

// an asynchronous 4-byte copy into shared memory (sm_80+); src_bytes 0
// fills the word with zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src,
                                          unsigned src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct RowState {
  int len;      // the stored length, unclipped
  bool ee0;     // absent or an error
  bool maybe;   // possibly truncated
};

__device__ __forceinline__ RowState row_state(const Subject& s, long long b) {
  RowState r;
  r.len = s.lens[b * s.lens_stride];
  const bool ok = s.ok == nullptr || s.ok[b * s.ok_stride] != 0;
  const bool err = s.err != nullptr && s.err[b * s.err_stride] != 0;
  r.ee0 = err || !ok;
  r.maybe = ok && r.len >= s.max_len;
  return r;
}

__device__ __forceinline__ void write(const Planes& p, long long b, int col,
                                      int mode, const RowState& r,
                                      bool hit) {
  const bool und =
      r.maybe && (mode == kAll || (mode == kMiss && !hit));
  const bool ee = r.ee0 || und;
  st_global_u8(p.m + b * p.stride + col, (hit && !ee) ? 1u : 0u);
  st_global_u8(p.n + b * p.stride + col, (!hit && !ee) ? 1u : 0u);
}

}  // namespace lits
