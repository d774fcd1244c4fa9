// dfa_scan — multi-pattern DFA acceptance over padded byte rows.
//
// Replaces the JAX package's istio_tpu/ops/bytes_ops.py dfa_match (:186),
// dfa_match_many (:221), dfa_match_many_onehot (:263) and
// dfa_match_many_onehot_blocked (:317): three TPU formulations (flat
// gather scan, dense one-hot bf16 matmul, block-diagonal einsum) of ONE
// function, acc[b, n] = accept[walk(starts[n], row b), n], where the walk
// consumes the row's first min(lens[b], L) bytes. The one-hot forms exist
// on the TPU only because its per-step gathers are slow; all values are
// 0/1 there, so they are exact and equal to this walk bit for bit.
//
// Two entry points share one body:
//   dfa_scan  writes the bool [B, N] acceptance plane (REGEX lists, the
//             single-atom closures);
//   dfa_lits  writes each pattern's literal pair into its column of
//             rule_match's ext planes, with the group's absence, error
//             and truncation rules (lit_cols.cuh): the ruleset's path.
//
// What bounds it on an H100: a dependent chain of table lookups, one per
// byte of each (row, pattern) walk. The design keeps that chain to one
// shared-memory load and one add a byte:
//   * the class-compressed table gt[:, rep] ([S, C] int32,
//     pack_dfas_classes) arrives with each next state multiplied by C
//     (host-side), so a state is its row offset and a step is
//     off = tab[off + cls]; a block stages it and the accept plane once
//     into shared memory by asynchronous copies (banks larger than
//     shared memory read them through L1 / L2);
//   * the class lookup is off the chain: a block takes a tile of rows,
//     copies their bytes into shared memory (asynchronously, a word a
//     thread, with the table's copies, so one wait covers both) and
//     maps them, up to each row's length, through class_of into a class
//     string per row in place;
//   * what the literal pair needs (the column, its mode, the row's
//     length, presence and error) is loaded before the walk;
//   * a thread walks one (row, pattern) chain at a time and stops at
//     its row's length (more chains a thread were slower on the served
//     launches; PERF.md §6);
//   * the grid is sized by the wrapper to the card (ops/bytes_ops.py
//     dfa_plan): tiles of ⌈B / SMs⌉ rows, so a few thousand walks still
//     reach every SM, and the table is staged once per block, not once
//     per 256 walks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lit_cols.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90

struct Rows {
  const uint8_t* data;
  long long stride;  // bytes between rows (0: one broadcast row)
  int B;
  int L;
  int aligned;  // data and stride are multiples of 4 and L % 4 == 0
};

struct Bank {
  const int32_t* scaled;    // [S, C] next state · C (a state's row offset)
  const int32_t* class_of;  // [256]
  const int32_t* starts;    // [N]
  const uint8_t* accept;    // [S, N]
  const int32_t* mode;      // dfa_lits: truncation mode of each column
  const int32_t* cols;      // dfa_lits: ext column of each pattern
  int S;
  int C;
  int N;
};

// bytes of one row's class string: a word multiple with an odd number of
// words, so the rows of a tile fall in different shared-memory banks
__host__ __device__ __forceinline__ int class_stride(int L) {
  return 4 * ((((L + 3) >> 2)) | 1);
}

// shared memory of a launch: [the table and the accept plane (kSmem)]
// [class_of 256] [starts N] [lengths of a tile] [the tile's class
// strings]
__host__ __device__ __forceinline__ size_t smem_bytes(long long n_tab, int N,
                                                      int rows, int L) {
  return (size_t)(n_tab + 256 + N + rows) * sizeof(int32_t) +
         (size_t)rows * class_stride(L);
}

// words of the accept plane [S, N] (bytes, rounded up to a word)
__host__ __device__ __forceinline__ long long accept_words(int S, int N) {
  return ((long long)S * N + 3) >> 2;
}

template <bool kSmem, bool kLits>
__global__ void __launch_bounds__(kMaxThreads)
    dfa_kernel(Rows r, Bank k, lits::Subject s, lits::Planes out,
               uint8_t* __restrict__ plane, int rows_per_tile) {
  extern __shared__ int32_t smem[];
  const int C = k.C, N = k.N, L = r.L;
  const long long n_tab = kSmem ? (long long)k.S * C : 0;
  const long long n_acc = kSmem ? accept_words(k.S, N) : 0;
  int32_t* tab_s = smem;                                  // [S, C]
  uint8_t* acc_s = reinterpret_cast<uint8_t*>(smem + n_tab);  // [S, N]
  int32_t* cls_of = smem + n_tab + n_acc;  // [256]
  int32_t* st0 = cls_of + 256;             // [N]
  int32_t* tlen = st0 + N;                 // [rows_per_tile]
  uint8_t* cstr = reinterpret_cast<uint8_t*>(tlen + rows_per_tile);
  const int32_t* tab = kSmem ? tab_s : k.scaled;
  const uint8_t* acc = kSmem ? acc_s : k.accept;
  const int cs = class_stride(L);
  const int nw = (L + 3) >> 2;
  const bool aligned = r.aligned != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // the bank, asynchronously: it lands with the first tile's rows
  if (kSmem) {
    for (long long i = threadIdx.x; i < n_tab; i += blockDim.x)
      lits::cp_async4(tab_s + i, k.scaled + i, 4u);
    const long long n_bytes = (long long)k.S * N;
    for (long long i = threadIdx.x; i < n_acc; i += blockDim.x)
      lits::cp_async4(acc_s + 4 * i, k.accept + 4 * i,
                      (unsigned)min(4LL, n_bytes - 4 * i));
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    lits::cp_async4(cls_of + i, k.class_of + i, 4u);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    lits::cp_async4(st0 + i, k.starts + i, 4u);

  for (long long r0 = (long long)blockIdx.x * rows_per_tile; r0 < r.B;
       r0 += (long long)gridDim.x * rows_per_tile) {
    const int rows = (int)min((long long)rows_per_tile, r.B - r0);
    __syncthreads();  // the last tile's walks are done with its strings
    for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
      const int rr = i / nw, t = i - rr * nw;
      const uint8_t* src = r.data + (r0 + rr) * r.stride + 4 * t;
      uint8_t* dst = cstr + rr * cs + 4 * t;
      if (aligned) {
        lits::cp_async4(dst, src, 4u);
      } else {  // a row off a word boundary: words from byte loads
        uint32_t w = 0;
        for (int j = 0; j < 4; ++j)
          if (4 * t + j < L) w |= (uint32_t)__ldg(src + j) << (8 * j);
        *reinterpret_cast<uint32_t*>(dst) = w;
      }
    }
    for (int rr = threadIdx.x; rr < rows; rr += blockDim.x)
      lits::cp_async4(tlen + rr, s.lens + (r0 + rr) * s.lens_stride, 4u);
    lits::cp_async_wait_all();
    __syncthreads();
    // bytes → classes in place, a warp a row, up to the row's length:
    // the walk then reads a class a byte
    for (int rr = warp; rr < rows; rr += n_warps) {
      const int len = min(max(tlen[rr], 0), L);
      for (int t = lane; t < ((len + 3) >> 2); t += 32) {
        uint32_t* w = reinterpret_cast<uint32_t*>(cstr + rr * cs + 4 * t);
        const uint32_t v = *w;
        *w = (uint32_t)cls_of[v & 255u] |
             (uint32_t)cls_of[(v >> 8) & 255u] << 8 |
             (uint32_t)cls_of[(v >> 16) & 255u] << 16 |
             (uint32_t)cls_of[v >> 24] << 24;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < rows * N; c += blockDim.x) {
      const int row = c / N, pat = c - row * N;
      const int len = min(max(tlen[row], 0), L);
      const long long b = r0 + row;
      // what the literal pair needs, loaded before the walk so that its
      // latency hides behind it
      int col = 0, mode = 0;
      lits::RowState rst{0, false, false};
      if (kLits) {
        col = __ldg(k.cols + pat);
        mode = __ldg(k.mode + pat);
        rst = lits::row_state(s, b);
      }
      const uint8_t* cls = cstr + row * cs;
      int off = st0[pat] * C;
      for (int i = 0; i < len; ++i) off = tab[off + cls[i]];
      const bool hit = acc[(long long)(off / C) * N + pat] != 0;
      if (kLits) {
        lits::write(out, b, col, mode, rst, hit);
      } else {
        lits::st_global_u8(plane + b * N + pat, hit ? 1u : 0u);
      }
    }
  }
  lits::cp_async_wait_all();  // a block past the last row leaves none
}

template <bool kLits>
int launch(const Rows& r, const Bank& k, const lits::Subject& s,
           const lits::Planes& out, uint8_t* plane, int threads,
           int rows_per_tile, int grid, cudaStream_t stream) {
  if (r.B == 0 || k.N == 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      rows_per_tile < 1 || grid < 1 || k.C < 1 || k.C > 256)
    return -(int)cudaErrorInvalidValue;
  const size_t base = smem_bytes(0, k.N, rows_per_tile, r.L);
  const size_t with_tab =
      smem_bytes((long long)k.S * k.C + accept_words(k.S, k.N), k.N,
                 rows_per_tile, r.L);
  if (base > kMaxSmem) return -(int)cudaErrorInvalidValue;
  // the bank in shared memory where it fits, else read through L1 / L2
  const bool staged = with_tab <= kMaxSmem;
  const size_t smem = staged ? with_tab : base;
  auto kern = staged ? dfa_kernel<true, kLits> : dfa_kernel<false, kLits>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return -(int)e;
  }
  kern<<<grid, threads, smem, stream>>>(r, k, s, out, plane, rows_per_tile);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 1 : -(int)e;
}

}  // namespace

// Returns the number of kernels launched, or -cudaError_t on failure.
// scaled: the [S, C] table with every next state multiplied by C. plan:
// threads per block, rows per tile, grid (ops/bytes_ops.py dfa_plan).
extern "C" int dfa_scan(const uint8_t* data, long long data_stride,
                        const int32_t* lens, long long lens_stride, int B,
                        int L, int aligned, const int32_t* scaled,
                        const int32_t* class_of, const int32_t* starts,
                        const uint8_t* accept, int S, int C, int N,
                        uint8_t* out, int threads, int rows_per_tile,
                        int grid, void* stream) {
  const Rows r{data, data_stride, B, L, aligned};
  const Bank k{scaled, class_of, starts, accept, nullptr, nullptr, S, C, N};
  const lits::Subject s{lens, lens_stride, nullptr, 0, nullptr, 0, 0};
  const lits::Planes none{nullptr, nullptr, 0};
  return launch<false>(r, k, s, none, out, threads, rows_per_tile, grid,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int dfa_lits(const uint8_t* data, long long data_stride,
                        const int32_t* lens, long long lens_stride,
                        const uint8_t* ok, long long ok_stride,
                        const uint8_t* err, long long err_stride, int B,
                        int L, int aligned, int max_len,
                        const int32_t* scaled, const int32_t* class_of,
                        const int32_t* starts, const uint8_t* accept,
                        const int32_t* mode, const int32_t* cols, int S,
                        int C, int N, uint8_t* em, uint8_t* en,
                        long long e_stride, int threads,
                        int rows_per_tile, int grid, void* stream) {
  const Rows r{data, data_stride, B, L, aligned};
  const Bank k{scaled, class_of, starts, accept, mode, cols, S, C, N};
  const lits::Subject s{lens, lens_stride, ok, ok_stride, err, err_stride,
                        max_len};
  const lits::Planes out{em, en, e_stride};
  return launch<true>(r, k, s, out, nullptr, threads, rows_per_tile, grid,
                      static_cast<cudaStream_t>(stream));
}
