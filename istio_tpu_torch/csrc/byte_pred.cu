// byte_pred — constant startsWith / endsWith / exact / glob predicates of
// one subject byte plane against P patterns.
//
// Replaces the constant part of the JAX package's istio_tpu/ops/
// bytes_ops.py (:26-78): prefix_match, suffix_match, exact_match and
// glob_match. The JAX package traces one such function per rule atom;
// the port's ruleset groups all constant atoms over one subject, so one
// launch answers every pattern of that subject. hit[b, p] for kind[p] in
//   0 prefix: plens 0 → true; k > L → false; else lens >= k and
//             row[0:k] == pat
//   1 suffix: plens 0 → true; k > L → false; else lens >= k and
//             row[lens-k : lens] == pat (offsets clipped to [0, L-1])
//   2 exact : k > L → false; else lens == k and the whole row equals the
//             pattern zero-padded to L
// Globs are mapped to these kinds on the host (trailing '*' → prefix,
// leading '*' → suffix, else exact; "*" is an empty prefix).
//
// Two entry points share one body:
//   byte_pred  writes the bool [B, P] plane (single-atom closures);
//   byte_lits  writes each pattern's literal pair into its column of
//              rule_match's ext planes, with the group's absence, error
//              and truncation rules (lit_cols.cuh): the ruleset's path.
//
// Design. A block holds a tile of rows and the group's patterns in
// shared memory, both copied in by asynchronous 4-byte copies issued
// together, so one wait covers them: the patterns as 32-bit words
// (host-packed, zero past k, an odd word stride so that lanes reading
// the same word of different patterns hit different banks) with each
// pattern's k, kind, output column and truncation mode; each row as
// words with a zero word after it (where every pattern is a prefix,
// rows and patterns only up to the longest prefix; a row that is not
// word-aligned — a slice at an odd offset, a width that is not a
// multiple of 4 — is assembled from byte loads). A row belongs to a group of G lanes
// (G = 32: a warp per row; G = 1: lanes as rows; the wrapper picks G,
// and the rows a block holds so that they fit its shared memory);
// the group's lanes split its patterns, and lane g compares patterns
// g, g + G, ... a word at a time, stopping at the first difference:
//   prefix  word t under the mask of bytes below k;
//   exact   every word against the zero-padded pattern word (len == k);
//   suffix  the window starting at len − k, built from two neighbouring
//           row words by a funnel shift of 8·((len − k) & 3) bits.
// A suffix window that runs past the plane (len > L) takes a byte path
// with byte_pred_plain's clipping. In byte_lits such a row is possibly
// truncated wherever the plane is max_len wide, and every suffix column
// is undecidable there (mode kAll), so the clip shows only for a value
// longer than a narrowed plane: a constant subject in a latency-tier
// batch. The verdicts go out as explicit global byte stores.
//
// Two kernels share the comparisons: byte_staged, above, and
// byte_direct, which reads rows and patterns in place through L1 and
// needs no shared memory. The wrapper takes byte_direct only where a
// row and a pattern do not fit the staged kernel's shared memory (rows
// of about 48 KB and more): on every served launch it was 2–70 %
// slower than byte_staged (PERF.md §6).
//
// What bounds it on an H100: memory, in principle — the bytes that must
// move are the B·L subject plane, the lengths and masks and the outputs;
// at the served shapes the launch itself takes most of the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lit_cols.cuh"

namespace {

constexpr int kPrefix = 0, kSuffix = 1, kExact = 2;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90

struct Rows {
  const uint8_t* data;
  long long stride;  // bytes between rows (0: one broadcast row)
  int B;
  int L;
  int aligned;  // data and stride are multiples of 4 and L % 4 == 0
  int need;     // words of a row (and of a pattern) the patterns read:
                // all of them unless every pattern is a prefix
};

struct Patterns {
  const uint32_t* words;  // [P, NWp] pattern bytes as words, zero past k
  const int32_t* plens;
  const int32_t* kind;
  const int32_t* mode;  // byte_lits: truncation mode of each column
  const int32_t* cols;  // byte_lits: ext column of each pattern
  int P;
  int NWp;
};

// the bytes of word t that lie below k
__device__ __forceinline__ uint32_t below(int k, int t) {
  const int rem = k - 4 * t;
  return rem >= 4 ? 0xffffffffu : ((1u << (8 * rem)) - 1u);
}

// one pattern against one row: the row's words row(t) (zero at and past
// the row's end), the pattern's words pat(t) (zero past k) and, for a
// suffix window past the plane, their bytes rowb(i) / patb(j)
template <class RowW, class PatW, class RowB, class PatB>
__device__ __forceinline__ bool compare(int k, int kd, int len, int L,
                                        RowW row, PatW pat, RowB rowb,
                                        PatB patb) {
  const int nw = (L + 3) >> 2;
  if (k > L) return false;
  if (kd == kExact) {
    bool hit = len == k;
    for (int t = 0; hit && t < nw; ++t) hit = row(t) == pat(t);
    return hit;
  }
  if (k == 0) return true;
  if (len < k) return false;
  bool hit = true;
  if (kd == kPrefix) {
    for (int t = 0; hit && 4 * t < k; ++t)
      hit = ((row(t) ^ pat(t)) & below(k, t)) == 0u;
  } else if (len <= L) {
    const int start = len - k;
    const int q0 = start >> 2, sh = (start & 3) * 8;
    for (int t = 0; hit && 4 * t < k; ++t) {
      const uint32_t w = __funnelshift_r(row(q0 + t), row(q0 + t + 1), sh);
      hit = ((w ^ pat(t)) & below(k, t)) == 0u;
    }
  } else {
    // the window runs past the plane: offsets clipped to L - 1
    const int start = len - k;
    for (int j = 0; hit && j < k; ++j)
      hit = rowb(min(start + j, L - 1)) == patb(j);
  }
  return hit;
}

template <bool kLits>
__device__ __forceinline__ void put(const lits::Planes& out, uint8_t* plane,
                                    int P, long long b, int p, int col,
                                    int mode, const lits::RowState& st,
                                    bool hit) {
  if (kLits) {
    lits::write(out, b, col, mode, st, hit);
  } else {
    lits::st_global_u8(plane + b * P + p, hit ? 1u : 0u);
  }
}

template <bool kLits>
__device__ __forceinline__ lits::RowState state_of(const lits::Subject& s,
                                                   long long b) {
  if (kLits) return lits::row_state(s, b);
  return lits::RowState{__ldg(s.lens + b * s.lens_stride), false, false};
}

// the staged kernel: rows and patterns in shared memory
template <bool kLits>
__global__ void __launch_bounds__(kMaxThreads)
    byte_staged(Rows r, Patterns q, lits::Subject s, lits::Planes out,
                uint8_t* __restrict__ plane, int G, int chunk) {
  extern __shared__ uint32_t smem[];
  const int L = r.L;
  const int ps = r.need | 1;     // pattern stride: odd, so lanes reading
                                 // word t of different patterns differ
                                 // in bank
  const int rs = (r.need + 1) | 1;  // row stride: a zero word after the
                                    // words read
  const int rpb = blockDim.x / G;  // rows a block holds at once
  uint32_t* pw = smem;                                   // [chunk, ps]
  int32_t* pk = reinterpret_cast<int32_t*>(pw + chunk * ps);
  int32_t* pkind = pk + chunk;
  int32_t* pcol = pkind + chunk;
  int32_t* pmode = pcol + chunk;
  uint32_t* rowbuf = reinterpret_cast<uint32_t*>(pmode + chunk);
  const int g = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  uint32_t* row = rowbuf + slot * rs;
  const uint8_t* rowb = reinterpret_cast<const uint8_t*>(row);
  const bool aligned = r.aligned != 0;

  for (int p0 = 0; p0 < q.P; p0 += chunk) {
    const int pc = min(chunk, q.P - p0);
    __syncthreads();  // the previous round's readers are done
    // the round's patterns, asynchronously: their loads overlap the
    // first rows' below, and one wait covers both
    for (int i = threadIdx.x; i < pc * r.need; i += blockDim.x) {
      const int p = i / r.need, t = i - p * r.need;
      const uint32_t* src =
          q.words + (long long)(p0 + p) * q.NWp + min(t, q.NWp - 1);
      lits::cp_async4(pw + p * ps + t, src, t < q.NWp ? 4u : 0u);
    }
    for (int p = threadIdx.x; p < pc; p += blockDim.x) {
      lits::cp_async4(pk + p, q.plens + p0 + p, 4u);
      lits::cp_async4(pkind + p, q.kind + p0 + p, 4u);
      if (kLits) {
        lits::cp_async4(pcol + p, q.cols + p0 + p, 4u);
        lits::cp_async4(pmode + p, q.mode + p0 + p, 4u);
      }
    }
    for (long long base = (long long)blockIdx.x * rpb; base < r.B;
         base += (long long)gridDim.x * rpb) {
      const long long b = base + slot;
      const bool live = b < r.B;
      if (live) {
        const uint8_t* src = r.data + b * r.stride;
        for (int t = g; t < r.need; t += G) {
          if (aligned) {
            lits::cp_async4(row + t, src + 4 * t, 4u);
          } else {  // a row off a word boundary: words from byte loads
            uint32_t w = 0;
            for (int j = 0; j < 4; ++j)
              if (4 * t + j < L)
                w |= (uint32_t)__ldg(src + 4 * t + j) << (8 * j);
            row[t] = w;
          }
        }
      }
      if (g == 0) row[r.need] = 0u;
      lits::RowState st{0, false, false};
      if (live) st = state_of<kLits>(s, b);
      lits::cp_async_wait_all();
      __syncthreads();  // the patterns and every group's row are in
      // the group's lanes split the patterns: lane g compares patterns
      // g, g + G, ... word by word against the row
      for (int p = g; live && p < pc; p += G) {
        const uint32_t* pat = pw + p * ps;
        const uint8_t* patb = reinterpret_cast<const uint8_t*>(pat);
        const bool hit = compare(
            pk[p], pkind[p], st.len, L, [&](int t) { return row[t]; },
            [&](int t) { return pat[t]; },
            [&](int i) { return (uint32_t)rowb[i]; },
            [&](int j) { return (uint32_t)patb[j]; });
        put<kLits>(out, plane, q.P, b, p0 + p, pcol[p], pmode[p], st, hit);
      }
      __syncthreads();  // every lane is done with the rows before the next
    }
  }
  lits::cp_async_wait_all();  // a block past the last row leaves none
}

// the direct kernel: rows and patterns read in place through L1
template <bool kLits>
__global__ void __launch_bounds__(kMaxThreads)
    byte_direct(Rows r, Patterns q, lits::Subject s, lits::Planes out,
                uint8_t* __restrict__ plane, int G) {
  const int L = r.L, nw = (L + 3) >> 2;
  const int rpb = blockDim.x / G;
  const int g = threadIdx.x % G;
  const bool aligned = r.aligned != 0;
  for (long long b = (long long)blockIdx.x * rpb + threadIdx.x / G;
       b < r.B; b += (long long)gridDim.x * rpb) {
    const uint8_t* src = r.data + b * r.stride;
    const uint32_t* src4 = reinterpret_cast<const uint32_t*>(src);
    const lits::RowState st = state_of<kLits>(s, b);
    auto row = [&](int t) -> uint32_t {
      if (t >= nw) return 0u;
      if (aligned) return __ldg(src4 + t);
      uint32_t w = 0;  // a row off a word boundary: a word of byte loads
      for (int j = 0; j < 4; ++j)
        if (4 * t + j < L) w |= (uint32_t)__ldg(src + 4 * t + j) << (8 * j);
      return w;
    };
    for (int p = g; p < q.P; p += G) {
      const uint32_t* pw = q.words + (long long)p * q.NWp;
      const uint8_t* pb = reinterpret_cast<const uint8_t*>(pw);
      const bool hit = compare(
          __ldg(q.plens + p), __ldg(q.kind + p), st.len, L, row,
          [&](int t) { return t < q.NWp ? __ldg(pw + t) : 0u; },
          [&](int i) { return (uint32_t)__ldg(src + i); },
          [&](int j) { return (uint32_t)__ldg(pb + j); });
      put<kLits>(out, plane, q.P, b, p, kLits ? __ldg(q.cols + p) : 0,
                 kLits ? __ldg(q.mode + p) : 0, st, hit);
    }
  }
}

// shared memory of a block (ops/bytes_ops.py byte_smem): `chunk`
// patterns of `need` words with their k, kind, column and mode, and the
// block's rows of `need` words and a zero word
size_t smem_bytes(int need, int rows, int chunk) {
  return ((size_t)chunk * ((need | 1) + 4) +
          (size_t)rows * ((need + 1) | 1)) * sizeof(uint32_t);
}

template <bool kLits>
int launch(const Rows& r, const Patterns& q, const lits::Subject& s,
           const lits::Planes& out, uint8_t* plane, int G, int threads,
           int chunk, int grid, int staged, cudaStream_t stream) {
  if (r.B == 0 || q.P == 0) return 0;
  if (r.need < 0 || r.need > (r.L + 3) / 4) return -(int)cudaErrorInvalidValue;
  if (G < 1 || G > 32 || threads % G != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || chunk < 1 || grid < 1)
    return -(int)cudaErrorInvalidValue;
  if (!staged) {
    byte_direct<kLits><<<grid, threads, 0, stream>>>(r, q, s, out, plane, G);
  } else {
    const size_t smem = smem_bytes(r.need, threads / G, chunk);
    if (smem > (size_t)kMaxSmem) return -(int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          byte_staged<kLits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (e != cudaSuccess) return -(int)e;
    }
    byte_staged<kLits><<<grid, threads, smem, stream>>>(r, q, s, out, plane,
                                                         G, chunk);
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
// plan: lanes per row (a power of two ≤ 32), threads per block, patterns
// staged per round, grid, staged (1: byte_staged, 0: byte_direct)
// (ops/bytes_ops.py byte_plan).
// need: the words of a row the patterns read (ops/bytes_ops.py
// BytePatterns.row_words).
extern "C" int byte_pred(const uint8_t* data, long long data_stride,
                         const int32_t* lens, long long lens_stride, int B,
                         int L, int aligned, int need, const uint32_t* words,
                         const int32_t* plens, const int32_t* kind, int P,
                         int NWp, uint8_t* out, int group, int threads,
                         int chunk, int grid, int staged, void* stream) {
  const Rows r{data, data_stride, B, L, aligned, need};
  const Patterns q{words, plens, kind, nullptr, nullptr, P, NWp};
  const lits::Subject s{lens, lens_stride, nullptr, 0, nullptr, 0, 0};
  const lits::Planes none{nullptr, nullptr, 0};
  return launch<false>(r, q, s, none, out, group, threads, chunk, grid,
                       staged, static_cast<cudaStream_t>(stream));
}

extern "C" int byte_lits(const uint8_t* data, long long data_stride,
                         const int32_t* lens, long long lens_stride,
                         const uint8_t* ok, long long ok_stride,
                         const uint8_t* err, long long err_stride, int B,
                         int L, int aligned, int need, int max_len,
                         const uint32_t* words, const int32_t* plens,
                         const int32_t* kind, const int32_t* mode,
                         const int32_t* cols, int P, int NWp, uint8_t* em,
                         uint8_t* en, long long e_stride, int group,
                         int threads, int chunk, int grid, int staged,
                         void* stream) {
  const Rows r{data, data_stride, B, L, aligned, need};
  const Patterns q{words, plens, kind, mode, cols, P, NWp};
  const lits::Subject s{lens, lens_stride, ok, ok_stride, err, err_stride,
                        max_len};
  const lits::Planes out{em, en, e_stride};
  return launch<true>(r, q, s, out, nullptr, group, threads, chunk, grid,
                      staged, static_cast<cudaStream_t>(stream));
}
