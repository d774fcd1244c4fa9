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
// the bool [B, X] planes ext_m / ext_n that rule_match reads, and no
// other byte: the DFA groups' and K3's columns of the same planes were
// written before this launch.
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
// nodes needs at most floor(log2(n + 1)) slots.
//
// What bounds it on an H100: not bytes, not operations. At B = 2048 the
// report trip's 60 fields read ≈ 0.5 MB and write 0.5 MB, the authz
// world's 306 atoms read ≈ 0.3 MB and write 1.25 MB (chip_smoke.py
// field_work / atom_work: 0.0002 and 0.0008 ms at 3.35 TB/s); the work
// is a few int32 ops per op row and, for byte ops, per byte compared.
// What a launch costs is its longest chain of dependent loads and the
// blocks it keeps in flight. The first port ran one thread per record
// through up to 32 programs (field_eval: 32 blocks at B = 2048), one
// dependent load of every op row, scattered byte stores X apart
// (atom_eval: 4,896 blocks), and a stack in local memory. This design:
//
//  1. Lanes are records, warps are programs. A block takes a tile of 32
//     records (one per lane) and a group of programs (field_eval: the 32
//     fields of one valid word; atom_eval: the plan's atom group), and
//     its warps take the group's programs in turn, so a thread runs at
//     most ceil(group / warps) programs. A warp runs one program over
//     its 32 records: its op-row reads are broadcasts and its branches
//     agree (only byte loops of different lengths diverge).
//  2. The group's program starts (and atom_eval's columns) sit in lane
//     registers from one warp load. Both entry points read the op rows
//     through the read-only path: a warp's op-row load is a broadcast,
//     and the group's rows stay in L1 across its tiles. The record's id /
//     presence columns are read in place: the tile's rows stay in L1
//     across the group's programs (a tile staged in shared memory
//     measured slower on every served launch, and field_eval's op rows
//     staged there gained too little to keep a second read path, PERF.md
//     §6).
//  3. Stores. field_eval's value stores are 128 contiguous bytes a warp;
//     its valid word is a __ballot_sync per field and a 32 x 32
//     transpose in shared memory. atom_eval stages its [32 x group]
//     literal tile in shared memory and writes it out one record row at
//     a time, lanes over atoms, so the bytes at cols[a] of one row fall
//     in a few sectors, and only those bytes are written. Where the
//     atoms are few (the route world's 13), the plan shrinks the group
//     until the launch has enough blocks to fill the card.
//  4. The stack lives in registers where the programs allow: the
//     shallow instantiation (need <= kShallow) is a shift register whose
//     every index is a compile-time constant; the general one keeps the
//     indexed kStack = 32 stack in local memory for deeper programs.
//
// The launch plan (groups, warps, shared-memory bytes, instantiation)
// is computed by ops/field_ops.py launch_plan and passed as PlanField
// ints.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // records per tile: one per lane
constexpr int kShallow = 4;   // register stack of the shallow kernels
constexpr int kStack = 32;    // MAX_STACK in ops/field_ops.py
constexpr int kOpWidth = 5;
constexpr int kMaxThreads = 256;  // field_ops.WARPS <= 8
// atom_eval's resident blocks an SM, asked of ptxas (at most 48
// registers): the authz world's 640 blocks then run in one wave on 132
// SMs, where 53 registers left 4 blocks an SM and two waves (+11 %)
constexpr int kAtomBlocks = 5;
constexpr int kMaxGridY = 65535;

enum Op : int32_t {
  kConst = 0, kVar, kDslot, kMapsel, kExtern, kErr, kOr, kEq, kNeq, kLand,
  kLor, kBslot, kBconst, kCmp, kDpred, kBpred, kDfa
};
// predicate kinds: bytes_ops PREFIX / SUFFIX / EXACT, field_ops GLOB
enum Kind : int32_t { kPrefix = 0, kSuffix = 1, kExact = 2, kGlob = 3 };

// the launch plan, in field_ops.PLAN_FIELDS order
enum PlanField : int {
  kTiles = 0, kGroups, kGroup, kWarps, kSRes, kDeep, kSmem, kPlanFields
};

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

struct Plan {
  int groups, group;  // programs [g * group, g * group + group) a block
  int s_res;          // atom_eval's literal tile row, bytes
};

// the block's shared memory (field_ops.LaunchPlan: field_eval's valid
// masks or atom_eval's literal tile); every access names it, so each is
// an explicit shared-memory access
extern __shared__ __align__(16) uint8_t smem[];

// one record's ids / present / map_present rows and byte views, read in
// place (the read-only path)
struct Row {
  const int32_t* id; const uint8_t* pres; const uint8_t* mp;
  const uint8_t* sb; const int32_t* sl;
  __device__ __forceinline__ int32_t ids(int c) const {
    return __ldg(id + c);
  }
  __device__ __forceinline__ bool present(int c) const {
    return __ldg(pres + c) != 0;
  }
  __device__ __forceinline__ bool mapped(int c) const {
    return __ldg(mp + c) != 0;
  }
};

struct Val {
  int32_t v, len;
  bool ok, err;
};

// need <= kShallow: a shift register, top at e[0]; every index is a
// compile-time constant, so the entries stay in registers
struct RegStack {
  Val e[kShallow];
  __device__ __forceinline__ RegStack() {
#pragma unroll
    for (int k = 0; k < kShallow; ++k) e[k] = Val{0, 0, false, false};
  }
  __device__ __forceinline__ void push(const Val& x) {
#pragma unroll
    for (int k = kShallow - 1; k > 0; --k) e[k] = e[k - 1];
    e[0] = x;
  }
  __device__ __forceinline__ void drop() {
#pragma unroll
    for (int k = 0; k + 1 < kShallow; ++k) e[k] = e[k + 1];
  }
  __device__ __forceinline__ Val& top() { return e[0]; }
  __device__ __forceinline__ const Val& below() const { return e[1]; }
};

// any need up to kStack: indexed by a runtime sp (local memory)
struct LocalStack {
  Val e[kStack];
  int sp;
  __device__ __forceinline__ LocalStack() : sp(0) {
    e[0] = Val{0, 0, false, false};
  }
  __device__ __forceinline__ void push(const Val& x) { e[sp++] = x; }
  __device__ __forceinline__ void drop() { --sp; }
  __device__ __forceinline__ Val& top() { return e[sp - 1]; }
  __device__ __forceinline__ const Val& below() const { return e[sp - 2]; }
};

__device__ __forceinline__ const uint8_t* view(const Planes& P,
                                               const Program& G,
                                               const Row& r, int32_t src) {
  return src >= 0 ? r.sb + (long long)src * P.sb_slot
                  : G.consts + (long long)(-1 - src) * G.const_w;
}

// bytes_ops.byte_pred_plain for one constant pattern of length k
__device__ __forceinline__ bool const_pred(const uint8_t* s, int sl, int L,
                                           int kind, const uint8_t* pat,
                                           int k) {
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
__device__ __forceinline__ bool dyn_prefix(const uint8_t* s, int sl,
                                           const uint8_t* p, int pl, int L) {
  if (sl < pl) return false;
  const int n = min(pl, L);
  for (int i = 0; i < n; ++i)
    if (s[i] != p[i]) return false;
  return true;
}

// bytes_ops.dyn_suffix_match: s's last (pl - shift) bytes against
// p[shift:] (the pattern row rolled left by shift)
__device__ __forceinline__ bool dyn_suffix(const uint8_t* s, int sl,
                                           const uint8_t* p, int pl,
                                           int shift, int L) {
  const int k = pl - shift;
  if (k < 0 || sl < k) return false;
  const int n = min(k, L);
  for (int i = 0; i < n; ++i)
    if (s[min(max(i + sl - k, 0), L - 1)] != p[(i + shift) % L])
      return false;
  return true;
}

// bytes_ops.dyn_exact_match
__device__ __forceinline__ bool dyn_exact(const uint8_t* s, int sl,
                                          const uint8_t* p, int pl, int L) {
  if (sl != pl) return false;
  for (int i = 0; i < L; ++i)
    if (s[i] != p[i]) return false;
  return true;
}

// bytes_ops.dyn_glob_match: trailing '*' = prefix of p[:-1], leading '*'
// = suffix of p[1:], else exact
__device__ __forceinline__ bool dyn_glob(const uint8_t* s, int sl,
                                         const uint8_t* p, int pl, int L) {
  const bool trailing = pl > 0 && p[min(max(pl - 1, 0), L - 1)] == '*';
  const bool leading = pl > 0 && p[0] == '*';
  if (trailing) return dyn_prefix(s, sl, p, max(pl - 1, 0), L);
  if (leading) return dyn_suffix(s, sl, p, pl, 1, L);
  return dyn_exact(s, sl, p, pl, L);
}

// bytes_ops.lex_cmp: the sign of a ⋛ b over L bytes, lengths break ties
__device__ __forceinline__ int lex_cmp(const uint8_t* a, int al,
                                       const uint8_t* b, int bl, int L) {
  for (int i = 0; i < L; ++i)
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  return al < bl ? -1 : (al > bl ? 1 : 0);
}

// op rows [i0, i1) over record r
template <class Stack>
__device__ __forceinline__ Val run_program(const Planes& P, const Program& G,
                                           const Row& r, int i0, int i1) {
  Stack st;
  const int L = P.L, max_len = G.max_len;
  for (int i = i0; i < i1; ++i) {
    const int32_t* o = G.ops + (long long)i * kOpWidth;
    const int32_t op = __ldg(o), a = __ldg(o + 1), b = __ldg(o + 2),
                  c = __ldg(o + 3), d = __ldg(o + 4);
    Val x{0, 0, false, false};
    // warp-uniform branches (every lane runs this program), the served
    // programs' commonest rows first: CONST, then OR / EQ / NEQ / LAND /
    // LOR
    if (op == kConst) {
      x.v = a;
      x.ok = true;
      st.push(x);
    } else if (op >= kOr && op <= kLor) {
      // two operands: x (left) and y (right); d = 1 when y lies below x
      const Val t = st.top(), u = st.below();
      const Val l = d ? t : u, rt = d ? u : t;
      const bool ea = l.err || !l.ok, eb = rt.err || !rt.ok;
      if (op == kOr) {
        x.v = l.ok ? l.v : rt.v;
        x.len = l.ok ? l.len : rt.len;
        x.ok = l.ok || (!l.err && rt.ok);
        x.err = l.err || (!l.ok && !l.err && rt.err);
      } else if (op == kEq || op == kNeq) {
        x.v = (int32_t)((l.v == rt.v) != (op == kNeq));
        x.err = ea || eb;
        x.ok = !x.err;
      } else if (op == kLand) {
        const bool at = l.v != 0, bt = rt.v != 0;
        x.err = ea || (!ea && at && eb);
        x.v = (int32_t)(at && bt && !x.err);
        x.ok = !x.err;
      } else {
        const bool at = l.v != 0, bt = rt.v != 0;
        x.err = ea || (!ea && !at && eb);
        x.v = (int32_t)(((at && !ea) || (bt && !eb)) && !x.err);
        x.ok = !x.err;
      }
      st.drop();
      st.top() = x;
    } else if (op == kVar) {
      const int32_t id = r.ids(a);
      x.v = b ? (int32_t)(id == P.id_true) : id;
      x.ok = r.present(a);
      st.push(x);
    } else if (op == kDslot) {
      x.v = r.ids(a);
      x.ok = r.present(a);
      st.push(x);
    } else if (op == kMapsel) {
      const bool sel = r.mapped(c);
      x.v = sel ? r.ids(a) : r.ids(b);
      x.ok = sel ? r.present(a) : (r.mapped(d) && r.present(b));
      st.push(x);
    } else if (op == kExtern) {
      const int32_t id = r.ids(a);
      const bool pres = r.present(a);
      x.v = id;
      x.err = pres && id == 0;
      x.ok = pres && !x.err;
      st.push(x);
    } else if (op == kErr) {
      x.err = true;
      st.push(x);
    } else if (op == kBslot) {
      x.v = a;
      x.len = __ldg(r.sl + (long long)a * P.sl_slot);
      x.ok = r.present(b);
      st.push(x);
    } else if (op == kBconst) {
      x.v = -1 - a;
      x.len = b;
      x.ok = true;
      st.push(x);
    } else if (op == kBpred || op == kDfa) {
      const Val t = st.top();
      const int sl = t.len;
      const uint8_t* s = view(P, G, r, t.v);
      bool ee = t.err || !t.ok;
      const bool maybe = t.ok && sl >= max_len;
      bool hit;
      if (op == kBpred) {
        hit = const_pred(s, sl, L, a, G.consts + (long long)b * G.const_w,
                         c);
        ee = ee || (maybe && d);
        hit = hit && !ee;
      } else {
        int q = __ldg(G.dfa_start + a);
        const int n = min(sl, L);
        for (int j = 0; j < n; ++j)
          q = __ldg(G.dfa_table + (long long)q * G.dfa_cls +
                    __ldg(G.dfa_class + s[j]));
        hit = __ldg(G.dfa_accept + (long long)q * G.dfa_n + a) != 0 && !ee;
        ee = ee || (b ? maybe : (maybe && !hit));
        hit = hit && !ee;
      }
      x.v = hit;
      x.ok = !ee;
      x.err = ee;
      st.top() = x;
    } else {
      // two byte views (CMP, DPRED); an unknown opcode is an error
      const Val t = st.top(), u = st.below();
      const Val l = d ? t : u, rt = d ? u : t;
      const uint8_t* pa = view(P, G, r, l.v);
      const uint8_t* pb = view(P, G, r, rt.v);
      bool ee = l.err || !l.ok || rt.err || !rt.ok, val = false;
      if (op == kCmp) {
        const int cmp = lex_cmp(pa, l.len, pb, rt.len, L);
        val = a == 0 ? cmp < 0 : a == 1 ? cmp <= 0 : a == 2 ? cmp > 0
                                                           : cmp >= 0;
        if (b) {
          const bool nan = (l.ok && l.len == 0) || (rt.ok && rt.len == 0);
          ee = ee || (l.ok && l.len == 1) || (rt.ok && rt.len == 1);
          val = val && !nan;
        } else {
          ee = ee || (l.ok && l.len >= max_len) ||
               (rt.ok && rt.len >= max_len);
        }
      } else if (op == kDpred) {
        val = a == kPrefix   ? dyn_prefix(pa, l.len, pb, rt.len, L)
              : a == kSuffix ? dyn_suffix(pa, l.len, pb, rt.len, 0, L)
                             : dyn_glob(pa, l.len, pb, rt.len, L);
        bool und = rt.ok && rt.len >= max_len;
        if (a != kPrefix) und = und || (l.ok && l.len >= max_len);
        ee = ee || und;
      } else {
        ee = true;
      }
      x.v = (int32_t)(val && !ee);
      x.ok = !ee;
      x.err = ee;
      st.drop();
      st.top() = x;
    }
  }
  return st.top();
}

// The lane's record min(b0 + lane, B - 1): lanes past B compute on a
// real record and store nothing.
__device__ __forceinline__ Row row_of(const Planes& P, int b0, int B) {
  const int b = min(b0 + (int)(threadIdx.x & 31), B - 1);
  Row r;
  r.id = P.ids + (long long)b * P.ids_stride;
  r.pres = P.present + (long long)b * P.pres_stride;
  r.mp = P.map_present + (long long)b * P.map_stride;
  r.sb = P.str_bytes + (long long)b * P.sb_rec;
  r.sl = P.str_lens + (long long)b * P.sl_rec;
  return r;
}

// Group [p0, p0 + np) (np <= 32): lane j's s0 / s1 are program p0 + j's
// first and end op rows.
struct Group {
  int s0, s1;
};

__device__ __forceinline__ Group group(const Program& G, int p0, int np) {
  const int j = min((int)(threadIdx.x & 31), np - 1);
  return Group{__ldg(G.starts + p0 + j), __ldg(G.starts + p0 + j + 1)};
}

template <class Stack>
__global__ void __launch_bounds__(kMaxThreads)
    field_eval_kernel(Planes P, Program G, Plan L, int B,
                      int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + lane < B;
  const Row r = row_of(P, b0, B);
  // vbits[j]: field f0 + j's valid bits, one per lane (record)
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem);
  for (int w = blockIdx.y; w < L.groups; w += gridDim.y) {
    const int f0 = w * L.group, nf = min(L.group, G.P - f0);
    const Group g = group(G, f0, nf);
    for (int j = warp; j < nf; j += warps) {
      const Val x = run_program<Stack>(P, G, r,
                                       __shfl_sync(0xffffffffu, g.s0, j),
                                       __shfl_sync(0xffffffffu, g.s1, j));
      if (live) out[(long long)(f0 + j) * B + b0 + lane] = x.v;
      const uint32_t m = __ballot_sync(0xffffffffu, x.ok && !x.err);
      if (lane == 0) vbits[j] = m;
    }
    __syncthreads();
    if (warp == 0 && live) {
      // transpose: bit j of the lane's word is field f0 + j's valid bit
      uint32_t word = 0u;
      for (int j = 0; j < nf; ++j) word |= ((vbits[j] >> lane) & 1u) << j;
      out[(long long)(G.P + w) * B + b0 + lane] = (int32_t)word;
    }
    __syncthreads();
  }
}

template <class Stack>
__global__ void __launch_bounds__(kMaxThreads, kAtomBlocks)
    atom_eval_kernel(Planes P, Program G, Plan L, int B,
                     const int32_t* __restrict__ cols,
                     uint8_t* __restrict__ ext_m,
                     uint8_t* __restrict__ ext_n, long long x_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * kLanes;
  const int rows = min(kLanes, B - b0);
  const Row r = row_of(P, b0, B);
  uint8_t* res = smem;  // [32 records][s_res]: m | n << 1
  for (int ga = blockIdx.y; ga < L.groups; ga += gridDim.y) {
    const int a0 = ga * L.group, na = min(L.group, G.P - a0);
    const long long col = __ldg(cols + a0 + min(lane, na - 1));
    const Group g = group(G, a0, na);
    for (int j = warp; j < na; j += warps) {
      const Val x = run_program<Stack>(P, G, r,
                                       __shfl_sync(0xffffffffu, g.s0, j),
                                       __shfl_sync(0xffffffffu, g.s1, j));
      const bool ee = x.err || !x.ok, val = x.v != 0;
      res[lane * L.s_res + j] =
          (uint8_t)((val && !ee) | ((!val && !ee) << 1));
    }
    __syncthreads();
    // one record row at a time, lanes over atoms: only cols[a] is written
    if (lane < na) {
      for (int rr = warp; rr < rows; rr += warps) {
        const uint8_t lit = res[rr * L.s_res + lane];
        const long long at = (long long)(b0 + rr) * x_stride + col;
        ext_m[at] = lit & 1u;
        ext_n[at] = lit >> 1;
      }
    }
    __syncthreads();
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

Plan plan_of(const int* f) {
  Plan L;
  L.groups = f[kGroups];
  L.group = f[kGroup];
  L.s_res = f[kSRes];
  return L;
}

// launch the instantiation the plan names on its grid (its shared memory
// is under the 48 KB a block gets without opting in) → 1, or
// -cudaError_t
template <class Kernel, class... Args>
int launch(Kernel kernel, const int* f, cudaStream_t s, Args... args) {
  const dim3 grid(f[kTiles], f[kGroups] < kMaxGridY ? f[kGroups] : kMaxGridY);
  kernel<<<grid, 32 * f[kWarps], f[kSmem], s>>>(args...);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
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

// Both take the launch plan (kPlanFields ints, field_ops.PLAN_FIELDS) and
// return the number of kernels launched, or -cudaError_t on failure.
extern "C" int field_eval(PLANE_PARAMS, PROGRAM_PARAMS, const int* f,
                          int32_t* out, void* stream) {
  if (B == 0 || n == 0) return 0;
  const auto kernel = f[kDeep] ? &field_eval_kernel<LocalStack>
                               : &field_eval_kernel<RegStack>;
  return launch(kernel, f, static_cast<cudaStream_t>(stream), PLANE_ARGS,
                PROGRAM_ARGS, plan_of(f), B, out);
}

extern "C" int atom_eval(PLANE_PARAMS, PROGRAM_PARAMS, const int* f,
                         const int32_t* cols, uint8_t* ext_m, uint8_t* ext_n,
                         long long x_stride, void* stream) {
  if (B == 0 || n == 0) return 0;
  const auto kernel = f[kDeep] ? &atom_eval_kernel<LocalStack>
                               : &atom_eval_kernel<RegStack>;
  return launch(kernel, f, static_cast<cudaStream_t>(stream), PLANE_ARGS,
                PROGRAM_ARGS, plan_of(f), B, cols, ext_m, ext_n, x_stride);
}
