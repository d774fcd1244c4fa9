// field_eval / atom_eval — op programs interpreted per record: the report
// field planes of a batch, and the generic-tier check atoms of a ruleset.
// ONE interpreter (run_program), two entry points.
//
// field_eval replaces the JAX package's istio_tpu/runtime/report_lower.py:
// 73-84, ReportLowering.field_planes (one jitted closure per field,
// stacked), and the field rows of FusedPlan.packed_report's packr
// (istio_tpu/runtime/fused.py:409-416), with the bit-lane codec of the
// valid words inside (pack_bool_rows, fused.py:76). Output int32
// [F + ceil(F/32), B], one column per record b:
//
//   rows 0 .. F      field f's value: an intern id, or 0/1 for a BOOL
//                    field — the value the reference writes on EVERY
//                    cell, invalid ones included (the pull is compared
//                    byte for byte);
//   rows F ..        valid word w: bit j (little-endian, bit 31 reads
//                    negative) is ok & ~err of field 32w + j.
//
// atom_eval replaces the per-atom closures of the JAX package's
// compile_ruleset run (istio_tpu/compiler/tensor_expr.py:291-775 under
// istio_tpu/compiler/ruleset.py:798), with the runtime-pattern
// predicates and the ordered compare inside (istio_tpu/ops/bytes_ops.py:
// 80-131). For atom a and record b it writes the literal pair
// m = val & !ee, n = !val & !ee (ee = err | !ok) into column cols[a] of
// the bool [B, X] planes ext_m / ext_n that rule_match reads.
//
// A program is a postfix list of op rows (opcode, a, b, c, d) over the
// masked algebra of compiler/tensor_expr.py; each stack entry is
// (val, len, ok, err), and a byte VIEW keeps its source in val (a byte
// slot s >= 0 reads str_bytes[b, s, :L], a constant -1 - k reads row k of
// the constant table, first L bytes) and its length in len:
//
//   CONST a            (a, 1, 0)
//   VAR a, is_bool b   (b ? ids[a] == id_true : ids[a], present[a], 0)
//   DSLOT a            (ids[a], present[a], 0)
//   MAPSEL a b c d     sel = map_present[c]:
//                      (sel ? ids[a] : ids[b],
//                       sel ? present[a] : map_present[d] & present[b], 0)
//   EXTERN a           e = present[a] & ids[a] == 0:
//                      (ids[a], present[a] & !e, e)
//   ERR                (0, 0, 1)
//   BSLOT a b          view of byte slot a, len str_lens[a], ok present[b]
//   BCONST a b         view of constant row a, len b, ok
//   OR                 (x.ok ? x.val : y.val, x.ok | (!x.err & y.ok),
//                       x.err | (!x.ok & !x.err & y.err)); a view also
//                       takes x's or y's len
//   EQ / NEQ           ee = eff(x) | eff(y), eff(v) = v.err | !v.ok:
//                      (x.val ==/!= y.val, !ee, ee)
//   LAND               err = ex | (!ex & x.val & ey):
//                      (x.val & y.val & !err, !err, err)
//   LOR                err = ex | (!ex & !x.val & ey):
//                      (((x.val & !ex) | (y.val & !ey)) & !err, !err, err)
//   CMP a b            lex compare of two views, a = LSS LEQ GTR GEQ, b =
//                      numeric order keys (len 0 = NaN reads False, len 1
//                      = malformed is err) else strings (len >= max_len
//                      is err)
//   DPRED a            runtime-pattern prefix / suffix / glob of view x
//                      against view y (bytes_ops.dyn_*); a pattern at the
//                      cap is err, and a subject at the cap too for
//                      suffix and glob
//   BPRED a b c d      constant prefix / suffix / exact of the top view
//                      against constant row b of length c
//                      (bytes_ops.byte_pred_plain); d: a subject at the
//                      cap is err
//   DFA a b            DFA a of the program's bank walks the top view
//                      (bytes_ops.dfa_scan_plain); at the cap, b ($ in
//                      the pattern): err, else a miss is err
//
// A two-operand op's d is the operand-order bit: 1 when the right
// operand y was emitted first and lies below x. The lowering emits the
// operand that needs more stack first (Sethi–Ullman), so a program of n
// nodes needs at most floor(log2(n + 1)) slots; kStack = 32 holds any.
//
// What bounds it on an H100: neither much. field_eval at F = 60 and
// B = 2048 moves well under 1 MB; atom_eval at the authz world's 306
// atoms reads a few id and presence columns per record and writes
// 2 x 306 bools per record (1.25 MB at B = 2048); the work is a few
// integer ops per op row and, for byte ops, per byte compared. So both
// are launch-bound at the served sizes. The design keeps it simple: one
// thread per (record, field word) or (record, atom); a block's threads
// take consecutive records of ONE program, so every thread of a warp
// walks the same op rows (the op-table reads are broadcasts and the
// branches agree; only byte loops of different lengths diverge). The
// field rows' stores are coalesced; atom_eval's m / n stores are one
// byte per thread at a row stride of X bytes (not coalesced; at 1.25 MB
// they cost little next to the launch). The stack lives in per-thread
// local memory (L1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 32;  // MAX_STACK in ops/field_ops.py
constexpr int kOpWidth = 5;
constexpr int kMaxGridY = 65535;

enum Op : int32_t {
  kConst = 0, kVar, kDslot, kMapsel, kExtern, kErr, kOr, kEq, kNeq, kLand,
  kLor, kBslot, kBconst, kCmp, kDpred, kBpred, kDfa
};
// predicate kinds: bytes_ops PREFIX / SUFFIX / EXACT, field_ops GLOB
enum Kind : int32_t { kPrefix = 0, kSuffix = 1, kExact = 2, kGlob = 3 };

struct Planes {
  const int32_t* ids; long long ids_stride;
  const uint8_t* present; long long pres_stride;
  const uint8_t* map_present; long long map_stride;
  const uint8_t* str_bytes; long long sb_rec, sb_slot; int L;
  const int32_t* str_lens; long long sl_rec, sl_slot;
  int id_true;
};

struct Program {
  const int32_t* ops; const int32_t* starts; int P;
  const uint8_t* consts; int const_w;
  const int32_t* dfa_table; const int32_t* dfa_class;
  const int32_t* dfa_start; const uint8_t* dfa_accept;
  int dfa_cls, dfa_n;
  int max_len;
};

// one record's rows of the planes
struct Rec {
  const int32_t* id; const uint8_t* pres; const uint8_t* mp;
  const uint8_t* sb; const int32_t* sl;
};

struct Val {
  int32_t v, len;
  bool ok, err;
};

__device__ __forceinline__ Rec record(const Planes& P, int b) {
  Rec r;
  r.id = P.ids + (long long)b * P.ids_stride;
  r.pres = P.present + (long long)b * P.pres_stride;
  r.mp = P.map_present + (long long)b * P.map_stride;
  r.sb = P.str_bytes + (long long)b * P.sb_rec;
  r.sl = P.str_lens + (long long)b * P.sl_rec;
  return r;
}

__device__ __forceinline__ const uint8_t* view(const Planes& P,
                                               const Program& G,
                                               const Rec& r, int32_t src) {
  return src >= 0 ? r.sb + (long long)src * P.sb_slot
                  : G.consts + (long long)(-1 - src) * G.const_w;
}

// bytes_ops.byte_pred_plain for one constant pattern of length k
__device__ bool const_pred(const uint8_t* s, int sl, int L, int kind,
                           const uint8_t* pat, int k) {
  if (k > L) return false;
  if (kind == kExact) {
    if (sl != k) return false;
    for (int i = 0; i < L; ++i)
      if (s[i] != (i < k ? pat[i] : 0)) return false;
    return true;
  }
  if (k == 0) return true;
  if (sl < k) return false;
  const int start = kind == kSuffix ? sl - k : 0;
  for (int i = 0; i < k; ++i)
    if (s[min(max(start + i, 0), L - 1)] != pat[i]) return false;
  return true;
}

// bytes_ops.dyn_prefix_match
__device__ bool dyn_prefix(const uint8_t* s, int sl, const uint8_t* p,
                           int pl, int L) {
  if (sl < pl) return false;
  const int n = min(pl, L);
  for (int i = 0; i < n; ++i)
    if (s[i] != p[i]) return false;
  return true;
}

// bytes_ops.dyn_suffix_match: s's last (pl - shift) bytes against
// p[shift:] (the pattern row rolled left by shift)
__device__ bool dyn_suffix(const uint8_t* s, int sl, const uint8_t* p,
                           int pl, int shift, int L) {
  const int k = pl - shift;
  if (k < 0 || sl < k) return false;
  const int n = min(k, L);
  for (int i = 0; i < n; ++i)
    if (s[min(max(i + sl - k, 0), L - 1)] != p[(i + shift) % L])
      return false;
  return true;
}

// bytes_ops.dyn_exact_match
__device__ bool dyn_exact(const uint8_t* s, int sl, const uint8_t* p,
                          int pl, int L) {
  if (sl != pl) return false;
  for (int i = 0; i < L; ++i)
    if (s[i] != p[i]) return false;
  return true;
}

// bytes_ops.dyn_glob_match: trailing '*' = prefix of p[:-1], leading '*'
// = suffix of p[1:], else exact
__device__ bool dyn_glob(const uint8_t* s, int sl, const uint8_t* p, int pl,
                         int L) {
  const bool trailing = pl > 0 && p[min(max(pl - 1, 0), L - 1)] == '*';
  const bool leading = pl > 0 && p[0] == '*';
  if (trailing) return dyn_prefix(s, sl, p, max(pl - 1, 0), L);
  if (leading) return dyn_suffix(s, sl, p, pl, 1, L);
  return dyn_exact(s, sl, p, pl, L);
}

// bytes_ops.lex_cmp: the sign of a ⋛ b over L bytes, lengths break ties
__device__ int lex_cmp(const uint8_t* a, int al, const uint8_t* b, int bl,
                       int L) {
  for (int i = 0; i < L; ++i)
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  return al < bl ? -1 : (al > bl ? 1 : 0);
}

__device__ Val run_program(const Planes& P, const Program& G, const Rec& r,
                           int i0, int i1) {
  int32_t sv[kStack], sn[kStack];
  uint8_t sf[kStack];  // bit 0 ok, bit 1 err
  int sp = 0;
  const int L = P.L, max_len = G.max_len;
  for (int i = i0; i < i1; ++i) {
    const int32_t* o = G.ops + (long long)i * kOpWidth;
    const int32_t op = o[0];
    Val x;
    x.v = 0;
    x.len = 0;
    x.ok = false;
    x.err = false;
    if (op == kConst) {
      x.v = o[1];
      x.ok = true;
    } else if (op == kVar) {
      const int32_t id = r.id[o[1]];
      x.v = o[2] ? (int32_t)(id == P.id_true) : id;
      x.ok = r.pres[o[1]] != 0;
    } else if (op == kDslot) {
      x.v = r.id[o[1]];
      x.ok = r.pres[o[1]] != 0;
    } else if (op == kMapsel) {
      const bool sel = r.mp[o[3]] != 0;
      x.v = sel ? r.id[o[1]] : r.id[o[2]];
      x.ok = sel ? r.pres[o[1]] != 0 : (r.mp[o[4]] != 0 && r.pres[o[2]] != 0);
    } else if (op == kExtern) {
      const int32_t id = r.id[o[1]];
      const bool pres = r.pres[o[1]] != 0;
      x.v = id;
      x.err = pres && id == 0;
      x.ok = pres && !x.err;
    } else if (op == kErr) {
      x.err = true;
    } else if (op == kBslot) {
      x.v = o[1];
      x.len = r.sl[(long long)o[1] * P.sl_slot];
      x.ok = r.pres[o[2]] != 0;
    } else if (op == kBconst) {
      x.v = -1 - o[1];
      x.len = o[2];
      x.ok = true;
    } else if (op == kBpred || op == kDfa) {
      --sp;
      const bool sok = sf[sp] & 1, serr = sf[sp] >> 1;
      const int sl = sn[sp];
      const uint8_t* s = view(P, G, r, sv[sp]);
      bool ee = serr || !sok;
      const bool maybe = sok && sl >= max_len;
      bool hit;
      if (op == kBpred) {
        hit = const_pred(s, sl, L, o[1],
                         G.consts + (long long)o[2] * G.const_w, o[3]);
        ee = ee || (maybe && o[4]);
        hit = hit && !ee;
      } else {
        const int k = o[1];
        int st = G.dfa_start[k];
        const int n = min(sl, L);
        for (int j = 0; j < n; ++j)
          st = G.dfa_table[(long long)st * G.dfa_cls + G.dfa_class[s[j]]];
        hit = G.dfa_accept[(long long)st * G.dfa_n + k] != 0 && !ee;
        ee = ee || (o[2] ? maybe : (maybe && !hit));
        hit = hit && !ee;
      }
      x.v = hit;
      x.ok = !ee;
      x.err = ee;
    } else {
      // two operands: x (left) and y (right); d = 1 when y lies below x
      sp -= 2;
      const int li = o[4] ? sp + 1 : sp, ri = o[4] ? sp : sp + 1;
      const int32_t av = sv[li], bv = sv[ri];
      const int al = sn[li], bl = sn[ri];
      const bool aok = sf[li] & 1, aerr = sf[li] >> 1;
      const bool bok = sf[ri] & 1, berr = sf[ri] >> 1;
      const bool ea = aerr || !aok, eb = berr || !bok;
      if (op == kOr) {
        x.v = aok ? av : bv;
        x.len = aok ? al : bl;
        x.ok = aok || (!aerr && bok);
        x.err = aerr || (!aok && !aerr && berr);
      } else if (op == kEq || op == kNeq) {
        x.v = (int32_t)((av == bv) != (op == kNeq));
        x.err = ea || eb;
        x.ok = !x.err;
      } else if (op == kLand) {
        const bool at = av != 0, bt = bv != 0;
        x.err = ea || (!ea && at && eb);
        x.v = (int32_t)(at && bt && !x.err);
        x.ok = !x.err;
      } else if (op == kLor) {
        const bool at = av != 0, bt = bv != 0;
        x.err = ea || (!ea && !at && eb);
        x.v = (int32_t)(((at && !ea) || (bt && !eb)) && !x.err);
        x.ok = !x.err;
      } else {
        const uint8_t* a = view(P, G, r, av);
        const uint8_t* b = view(P, G, r, bv);
        bool ee = ea || eb, val = false;
        if (op == kCmp) {
          const int c = lex_cmp(a, al, b, bl, L);
          const int32_t kind = o[1];
          val = kind == 0 ? c < 0 : kind == 1 ? c <= 0 : kind == 2 ? c > 0
                                                                   : c >= 0;
          if (o[2]) {
            const bool nan = (aok && al == 0) || (bok && bl == 0);
            ee = ee || (aok && al == 1) || (bok && bl == 1);
            val = val && !nan;
          } else {
            ee = ee || (aok && al >= max_len) || (bok && bl >= max_len);
          }
        } else if (op == kDpred) {
          const int32_t kind = o[1];
          val = kind == kPrefix   ? dyn_prefix(a, al, b, bl, L)
                : kind == kSuffix ? dyn_suffix(a, al, b, bl, 0, L)
                                  : dyn_glob(a, al, b, bl, L);
          bool und = bok && bl >= max_len;
          if (kind != kPrefix) und = und || (aok && al >= max_len);
          ee = ee || und;
        } else {
          ee = true;  // unknown opcode: an error, never a value
        }
        x.v = (int32_t)(val && !ee);
        x.ok = !ee;
        x.err = ee;
      }
    }
    sv[sp] = x.v;
    sn[sp] = x.len;
    sf[sp] = (uint8_t)(x.ok | (x.err << 1));
    ++sp;
  }
  Val top;
  top.v = sv[0];
  top.len = sn[0];
  top.ok = sf[0] & 1;
  top.err = sf[0] >> 1;
  return top;
}

__global__ void field_eval_kernel(Planes P, Program G, int B,
                                  int32_t* __restrict__ out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  if (b >= B) return;
  const Rec r = record(P, b);
  const int f0 = 32 * w, f1 = min(G.P, f0 + 32);
  uint32_t bits = 0u;
  for (int f = f0; f < f1; ++f) {
    const Val x = run_program(P, G, r, G.starts[f], G.starts[f + 1]);
    out[(long long)f * B + b] = x.v;
    if (x.ok && !x.err) bits |= 1u << (f - f0);
  }
  out[(long long)(G.P + w) * B + b] = (int32_t)bits;
}

__global__ void atom_eval_kernel(Planes P, Program G, int B,
                                 const int32_t* __restrict__ cols,
                                 uint8_t* __restrict__ ext_m,
                                 uint8_t* __restrict__ ext_n,
                                 long long x_stride) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const Rec r = record(P, b);
  for (int a = blockIdx.y; a < G.P; a += gridDim.y) {
    const Val x = run_program(P, G, r, G.starts[a], G.starts[a + 1]);
    const bool ee = x.err || !x.ok, val = x.v != 0;
    const long long k = (long long)b * x_stride + cols[a];
    ext_m[k] = val && !ee;
    ext_n[k] = !val && !ee;
  }
}

Planes planes(const int32_t* ids, long long ids_stride,
              const uint8_t* present, long long pres_stride,
              const uint8_t* map_present, long long map_stride,
              const uint8_t* str_bytes, long long sb_rec, long long sb_slot,
              int L, const int32_t* str_lens, long long sl_rec,
              long long sl_slot, int id_true) {
  Planes P;
  P.ids = ids; P.ids_stride = ids_stride;
  P.present = present; P.pres_stride = pres_stride;
  P.map_present = map_present; P.map_stride = map_stride;
  P.str_bytes = str_bytes; P.sb_rec = sb_rec; P.sb_slot = sb_slot; P.L = L;
  P.str_lens = str_lens; P.sl_rec = sl_rec; P.sl_slot = sl_slot;
  P.id_true = id_true;
  return P;
}

Program program(const int32_t* ops, const int32_t* starts, int n,
                const uint8_t* consts, int const_w, const int32_t* dfa_table,
                const int32_t* dfa_class, const int32_t* dfa_start,
                const uint8_t* dfa_accept, int dfa_cls, int dfa_n,
                int max_len) {
  Program G;
  G.ops = ops; G.starts = starts; G.P = n;
  G.consts = consts; G.const_w = const_w;
  G.dfa_table = dfa_table; G.dfa_class = dfa_class;
  G.dfa_start = dfa_start; G.dfa_accept = dfa_accept;
  G.dfa_cls = dfa_cls; G.dfa_n = dfa_n;
  G.max_len = max_len;
  return G;
}

}  // namespace

#define PLANE_PARAMS                                                       \
  const int32_t *ids, long long ids_stride, const uint8_t *present,        \
      long long pres_stride, const uint8_t *map_present,                   \
      long long map_stride, const uint8_t *str_bytes, long long sb_rec,    \
      long long sb_slot, int L, const int32_t *str_lens, long long sl_rec, \
      long long sl_slot, int B, int id_true
#define PROGRAM_PARAMS                                                    \
  const int32_t *ops, const int32_t *starts, int n, const uint8_t *consts, \
      int const_w, const int32_t *dfa_table, const int32_t *dfa_class,     \
      const int32_t *dfa_start, const uint8_t *dfa_accept, int dfa_cls,    \
      int dfa_n, int max_len
#define PLANE_ARGS                                                      \
  planes(ids, ids_stride, present, pres_stride, map_present, map_stride, \
         str_bytes, sb_rec, sb_slot, L, str_lens, sl_rec, sl_slot, id_true)
#define PROGRAM_ARGS                                                     \
  program(ops, starts, n, consts, const_w, dfa_table, dfa_class, dfa_start, \
          dfa_accept, dfa_cls, dfa_n, max_len)

// Both return the number of kernels launched, or -cudaError_t on failure.
extern "C" int field_eval(PLANE_PARAMS, PROGRAM_PARAMS, int32_t* out,
                          void* stream) {
  if (B == 0 || n == 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads, (n + 31) / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  field_eval_kernel<<<grid, kThreads, 0, s>>>(PLANE_ARGS, PROGRAM_ARGS, B,
                                               out);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

extern "C" int atom_eval(PLANE_PARAMS, PROGRAM_PARAMS, const int32_t* cols,
                         uint8_t* ext_m, uint8_t* ext_n, long long x_stride,
                         void* stream) {
  if (B == 0 || n == 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads, n < kMaxGridY ? n : kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  atom_eval_kernel<<<grid, kThreads, 0, s>>>(PLANE_ARGS, PROGRAM_ARGS, B,
                                              cols, ext_m, ext_n, x_stride);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}
