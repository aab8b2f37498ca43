// Windowed rDFT magnitude of hop-framed audio at the sizes too large for a
// thread block cluster: every n_fft from 40961 to 2^20 (STAGED_MAX) that
// dft_cluster.cu does not take, from the padded samples: out[t, k] =
// |sum_n w[n] x[t*hop + n] exp(-2 pi i n k / N)|, k = 0..N/2. An n_fft whose
// prime factors are all in {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31} runs as
// one FFT of N points (98304, 131072; up to 2^20), any other in the chirp-z
// mode on a convolution length M >= 2 N - 1 of up to 2^21 (40962, 49154).
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel) at those sizes, which dft_gemm.cu's GEMM took before:
// its work grows as N^2 a frame (40.5 ms for 301 frames at 40962 on the
// H100, where torch.stft takes 0.5 ms) and its window-folded tables are
// 4 N (N/2 + 1) bytes, 6.7 GB at 40962 and 68.7 GB at 131072, more than a
// card holds above that. A lab recording at 384 kHz that wants the
// frequency resolution of 512 points at 48 kHz sets such an nfft.
//
// Bound on the card: bytes. The function reads each sample once and writes
// each magnitude once: at 131072 / 65536 a 2048-frame int16 tile is 0.27 GB
// in and 0.54 GB out, 0.24 ms at 3.35 TB/s; at 40962 / 20481 on 301 frames
// 0.011 ms. This design moves more: each frame pair's N complex values go
// to a scratch buffer and back between its kernels (in the chirp mode M
// values, twice: kernel 2 writes back over what kernel 1 wrote), 16 N bytes
// a pair: at 131072 on 2048 frames another 2.1 GB, 0.64 ms, its own floor of
// 0.88 ms. Chunks whose scratch fits in the 50 MB L2 would keep that off
// HBM, but on the H100 they ran slower than large ones (3.80 against 3.21
// ms there: many short launches with partial waves cost more than the
// trip), so a chunk holds up to 512 MB. The FFT's operations stay below the
// bytes on paper, yet in the chirp mode at 40962 kernels 1 and 2 move their
// bytes at 0.78-0.90 TB/s (an H100 80GB HBM3 at 700 W, tools/trace_staged.py,
// PERF.md): their passes, not their bytes, bound them.
//
// Design: the cluster route's four-step split (dft_cluster.cu) with kernel
// boundaries in place of cluster.sync() and a scratch buffer in device
// memory in place of distributed shared memory, so that neither side of the
// split need fit on one cluster. N = N1 * N2 (ops/dft.py::staged_plan,
// both sides at most 8192): the input z[N2 n1 + j] (z = w x_t + i w x_t+1)
// is N2 columns j of N1 points, the output Z[k1 + N1 k2] N1 rows k1 of N2.
//   1. kernel 1 (fft_columns_kernel): a CTA owns G1 adjacent columns of
//      one frame pair and reads them straight from the audio (adjacent
//      columns are adjacent samples: each n1 is one run of G1 samples),
//      runs their N1-point FFTs batched in shared memory (the passes of
//      fft_plan(N1)), multiplies by W_N^(k1 j) and stores Y[k1, j]
//      row-major into the pair's scratch, runs of G1 complex values;
//   2. kernel 2 (fft_rows_kernel): a CTA owns G2 adjacent row pairs {k1,
//      N1 - k1} (k1 = 0 and N1/2 pair with themselves), copies its rows
//      from the scratch (each row one run of N2 values), runs their
//      N2-point FFTs, and untangles X_t[k] = (Z[k] + conj Z[N-k])/2,
//      X_t+1[k] = (Z[k] - conj Z[N-k])/2i: the mirror of bin k1 + N1 k2
//      lies in row N1 - k1, on the same CTA. It writes IEEE sqrtf
//      magnitudes as runs of G2 adjacent bins (the rows k1 of a CTA are
//      adjacent, and so are their mirrors), where one row pair a CTA would
//      write every N1-th bin.
// What held the FFT mode was latency, not bytes: taken apart on the card
// (tools/probe_staged.py, PERF.md), its kernel 2 spent 0.79 of its 1.90 ms
// at 131072 on 2048 frames copying its rows one value a thread at a time
// (a load, then its store, then the next load), its passes 0.54 ms of the
// call, kernel 1 0.19 ms reading each twiddle of an N-value table from L2
// in the same way; its magnitude stores, 16-byte runs, cost 0.23 ms where
// their bytes need 0.16. So:
//   - kernel 2 copies its rows with every load of a thread in flight
//     before its stores (COPY at a time in the generic kernel);
//   - the twiddles are products of two tables of float64 roots in shared
//     memory, S + N/S values (twiddle_split, as dft_cluster.cu's), formed
//     where each value is stored, with the multiply's fused multiply-adds
//     spelled out (twiddled): no table of N values is read each pair;
//   - every side whose radices are all powers of two, in two passes or
//     more, and 98304's rows of 384 = 16 x 8 x 3, a fork for that one size
//     (Columns, Rows; the rule of dft_staged_plan.cuh::powers_of_two and
//     extra_row, which tests/test_torch_dft_staged.py enumerates over the
//     mode's reach), runs a kernel of its own compiled
//     whole (Fixed: every size, stride, round and pass a constant), on one
//     buffer, its passes in place (each thread's butterflies read, a
//     barrier, then written), so that its CTAs take half the shared memory
//     and three share an SM; kernel 1's last pass multiplies by the
//     twiddles and stores to the scratch from registers, and its 1- and
//     2-byte samples are staged in its buffer first (stage_columns). Every
//     other side runs the generic kernel, which reads its plan at run time
//     from shared memory.
// The chirp-z (Bluestein) mode follows dft_cluster.cu's, one stage a
// kernel, three kernels a chunk: kernel 1 the first FFT's columns of z =
// (w a)[n] (x_t + i x_t+1)[n] zero-padded to M; kernel 2 its rows, the
// product with B = FFT_M(b) / M and the conjugate where each value lies,
// and the second FFT's rows with W_M^(k1 p2), written back over the same
// rows of the scratch; kernel 3 (columns_untangle_kernel) the second FFT's
// columns, u[N2 p1 + p2] in column p2, and the untangle in shared memory,
// so that u never returns to device memory. The mirror u[n_fft - k] of a
// bin k = N2 p1 + p2 lies in the partner column (r - p2) mod N2 (r = n_fft
// mod N2), at row q - p1, or q - p1 - 1 where p2 > r (q = n_fft / N2); bin
// 0 is its own mirror. So a CTA owns G3 adjacent columns f + d and their
// partners f + e - d (ops/dft.py::staged_fold: the host's centre f and e =
// (r - 2 f) mod N2, 0 or 1; where N2 is odd one column is its own
// partner), runs their N1-point FFTs, forms Z[k] = a[k] conj u[k] and the
// mirror's, and writes the magnitudes of the bins k <= n_fft / 2 of its
// columns, each bin once, as runs of adjacent bins (adjacent columns hold
// adjacent bins). A stored u and a pass of its own to untangle it would
// move a third more device-memory bytes at 40962 (3.92 against 2.93 MB a
// frame pair by tools/trace_staged.py's count, on any card) and launch a
// fourth kernel.
//
// Chunks. The host walks the frame pairs in chunks of ops/dft.py::
// staged_chunk_pairs(M) (a chunk's scratch within 512 MB), each chunk's
// kernels back to back on one stream; the scratch (chunk pairs x M complex
// values) comes from the caller (the caching allocator).
// Each kernel's batch of G columns, row pairs or column pairs is the most
// whose two buffers fit in 96 KB (two CTAs on an SM), at least one within
// 200 KB (dft_staged_plan.cuh); the pass roots, and the chirp mode's
// twiddles, are read from device memory through L1 (the same across a
// batch: broadcasts).
//
// The butterflies are dft_mixed.cu's and dft_cluster.cu's
// (dft_butterflies.cuh, dft_batched.cuh): radix 16 as 4 x 4, the odd radices
// up to 31 direct over symmetric pairs. A build takes the plans of its
// largest odd radix (13, or 31 for the plans of 17 to 31; -DORCAI_ODD,
// ops/_build.py), compiled beside the other, and every sample type, chosen
// at run time (only kernel 1 reads samples). uint8 input is mu-law codes
// (the mulaw8 wire), decoded where a sample is read, so the codes and their
// int16 decode give the same magnitudes. IEEE fp32 throughout: no TF32, no
// fast-math sqrt, sincos or exp. A scratch the caller could not allocate, or
// a launch that fails, is an error, never a fallback.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#if !defined(ORCAI_ODD) || (ORCAI_ODD != 13 && ORCAI_ODD != 31)
#error "build with -DORCAI_ODD=13 or 31 (ops/_build.py::VARIANTS)"
#endif

namespace {

#include "dft_butterflies.cuh"

// ORCAI_ODD, the largest odd radix a build is for (13 or 31), leaves the
// radix-17 to -31 butterflies out of the kernels of the plans that lack them
#define ORCAI_RADIX_CASES(CALL) \
  case 2: CALL(2); break;       \
  case 3: CALL(3); break;       \
  case 4: CALL(4); break;       \
  case 5: CALL(5); break;       \
  case 7: CALL(7); break;       \
  case 8: CALL(8); break;       \
  case 11: CALL(11); break;     \
  case 13: CALL(13); break;     \
  case 16: CALL(16); break;     \
  case 17: if constexpr (ORCAI_ODD >= 17) { CALL(17); } break; \
  case 19: if constexpr (ORCAI_ODD >= 19) { CALL(19); } break; \
  case 23: if constexpr (ORCAI_ODD >= 23) { CALL(23); } break; \
  case 29: if constexpr (ORCAI_ODD >= 29) { CALL(29); } break; \
  case 31: if constexpr (ORCAI_ODD >= 31) { CALL(31); } break;

#include "dft_batched.cuh"
#include "dft_staged_plan.cuh"

// the columns cols[b] of the scratch: element e of local column b
struct ListColumns {
  const float2* s;
  const unsigned short* cols;
  int n2;
  __device__ __forceinline__ float2 operator()(int e, int b) const { return s[e * n2 + cols[b]]; }
};

// The G1 (or fewer, at the right edge) columns c0.. of one frame pair: their
// N1-point FFTs from `load`, then element k1 of column j, times t[k1 * n2 +
// j] (the chirp mode's four-step twiddles), stored at s[k1 * n2 + j].
// Consecutive threads take consecutive columns: runs of `cols` values.
template <typename Load>
__device__ __forceinline__ void columns(const Load& load, const float2* __restrict__ tables,
                                        const float2* __restrict__ t, float2* s, const Plan& p,
                                        int c0, int cols, float2* za, float2* zb, int tid,
                                        int nthreads) {
  const float2* y = batched_fft(load, za, zb, tables, p.col, p.cstride, cols, tid, nthreads);
  for (Walk w(tid, nthreads, cols); w.o < p.n1; w.step()) {
    const int at = w.o * p.n2 + c0 + w.i;
    s[at] = cmul(y[w.o * p.cstride + w.i], t[at]);
  }
}

// A side read at run time from the Plan (in shared memory, indexed by pass)
struct Generic {
  static constexpr bool compiled = false;
  static constexpr int most_threads = MAX_THREADS, ctas = 2;
};

template <int A, int... B>
struct Largest {
  static constexpr int value = A;
};
template <int A, int B, int... C>
struct Largest<A, B, C...> {
  static constexpr int value = A > Largest<B, C...>::value ? A : Largest<B, C...>::value;
};

// Pass radix R (after NS points) of BATCH FFTs of N points on THREADS
// threads: butterfly j of FFT b reads elements j + r N/R through load(e, b),
// times the pass roots at tw[(r - 1) NS + j % NS] (none in the first pass),
// and hands element (j / NS) NS R + j % NS + r NS to emit(e, b, v). Each
// thread's butterflies are read before any is written; IN_PLACE puts a
// barrier between, for a pass that reads and writes one buffer.
template <int R, int NS, int N, int BATCH, int THREADS, bool IN_PLACE, class Load, class Emit>
__device__ __forceinline__ void fixed_pass(const Load& load, const float2* tw, int tid,
                                           const Emit& emit) {
  constexpr int NB = N / R, ITEMS = NB * BATCH, K = (ITEMS + THREADS - 1) / THREADS;
  float re[K][R], im[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = tid + k * THREADS;
    if (ITEMS % THREADS == 0 || f < ITEMS) {
      const int j = f / BATCH, b = f % BATCH;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 v = load(j + r * NB, b);
        re[k][r] = v.x;
        im[k][r] = v.y;
      }
    }
  }
  if constexpr (IN_PLACE) __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = tid + k * THREADS;
    if (ITEMS % THREADS == 0 || f < ITEMS) {
      const int j = f / BATCH, b = f % BATCH, jm = j % NS;
      if constexpr (NS > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 t = tw[(r - 1) * NS + jm];
          const float vr = re[k][r] * t.x - im[k][r] * t.y;
          const float vi = re[k][r] * t.y + im[k][r] * t.x;
          re[k][r] = vr;
          im[k][r] = vi;
        }
      }
      dft(re[k], im[k]);
      const int base = (j / NS) * NS * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) emit(base + r * NS, b, make_float2(re[k][r], im[k][r]));
    }
  }
}

// The passes of a side compiled whole from radix R on (NS points done):
// the first reads through `load`, every pass but the last writes `buf` (at
// STRIDE) and ends at a barrier, the last hands its outputs to `last`.
// READS_BUF: the first pass reads `buf` (every later pass does); LAST_BUF:
// `last` writes `buf`, so the last pass runs in place.
template <int N, int BATCH, int STRIDE, int THREADS, int NS, bool READS_BUF, bool LAST_BUF,
          int... RS>
struct Passes;

template <int N, int BATCH, int STRIDE, int THREADS, int NS, bool READS_BUF, bool LAST_BUF, int R>
struct Passes<N, BATCH, STRIDE, THREADS, NS, READS_BUF, LAST_BUF, R> {
  template <class Load, class Last>
  static __device__ __forceinline__ void run(const Load& load, float2*, const float2* tw, int tid,
                                             const Last& last) {
    fixed_pass<R, NS, N, BATCH, THREADS, READS_BUF && LAST_BUF>(load, tw, tid, last);
  }
};

template <int N, int BATCH, int STRIDE, int THREADS, int NS, bool READS_BUF, bool LAST_BUF, int R,
          int R2, int... RS>
struct Passes<N, BATCH, STRIDE, THREADS, NS, READS_BUF, LAST_BUF, R, R2, RS...> {
  template <class Load, class Last>
  static __device__ __forceinline__ void run(const Load& load, float2* buf, const float2* tw,
                                             int tid, const Last& last) {
    fixed_pass<R, NS, N, BATCH, THREADS, READS_BUF>(
        load, tw, tid, [&](int e, int b, float2 v) { buf[e * STRIDE + b] = v; });
    __syncthreads();
    Passes<N, BATCH, STRIDE, THREADS, NS * R, true, LAST_BUF, R2, RS...>::run(
        Local{buf, STRIDE}, buf, NS > 1 ? tw + (R - 1) * NS : tw, tid, last);
  }
};

// A side compiled whole: BATCH FFTs a CTA (G columns in kernel 1, the 2 G
// rows of G row pairs in kernel 2) of N = R... points on THREADS threads
// (threads_for, as the plan launches them), one buffer at STRIDE, CTAS
// CTAs an SM in the registers.
template <int G, int BATCH, int... R>
struct Fixed {
  static constexpr bool compiled = true;
  static constexpr int g = G, batch = BATCH, n = (R * ...), passes = sizeof...(R);
  static constexpr int radix[passes] = {R...};
  static constexpr int stride = BATCH | 1;
  static constexpr int threads = threads_for(n, Largest<R...>::value, BATCH);
  static constexpr int buffer_bytes = n * stride * 8;
  static constexpr int most_threads = threads, ctas = buffer_bytes <= 64 * 1024 ? 3 : 2;

  // the FFTs: the first pass from `load`, the last to `last` (Passes)
  template <bool READS_BUF, bool LAST_BUF, class Load, class Last>
  static __device__ __forceinline__ void fft(const Load& load, float2* buf, const float2* tw,
                                             int tid, const Last& last) {
    Passes<n, BATCH, stride, threads, 1, READS_BUF, LAST_BUF, R...>::run(load, buf, tw, tid, last);
  }
};
template <int G, int... R>
using Column = Fixed<G, G, R...>;
template <int G, int... R>
using Row = Fixed<G, 2 * G, R...>;

// The sides compiled whole, every FFT-mode side whose radices are all
// powers of two, in two passes or more, with its batch (staged_plan's G1,
// G2) over the mode's reach, 8193 to 2^20 (tests/test_torch_dft_staged.py
// enumerates them): the columns of 256 (131072, 98304 and 177 other
// sizes), 512, 128 and 64 points and the rows of 1024, 4096, 256 and 512
// (131072); and the rows of 98304 (dft_staged_plan.cuh::extra_row); in
// every build, so that a plan runs them whatever its other side's radices.
template <class... Fs>
struct Sides {};
using Columns = Sides<Column<16, 16, 16>, Column<8, 8, 8, 8>, Column<16, 16, 8>, Column<16, 8, 8>>;
using Rows = Sides<Row<2, 16, 8, 8>, Row<1, 16, 16, 16>, Row<8, 16, 16>, Row<4, 8, 8, 8>,
                   Row<4, 16, 8, 3>>;

// A thread's loads kept in flight at a time where a copy is not compiled
// whole: the rows of kernel 2 (up to it in a compiled side too), kernel 1's
// samples where they are not copied as vectors (24 read no faster: PERF.md)
constexpr int COPY = 8;

template <int BYTES>
struct Vec;  // an unsigned type of BYTES bytes, for copies of that width
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};

// ROWS rows of G adjacent values of type U, row r from src + at(r), copied
// to dst[r G + b] as vectors of up to 16 bytes (V), each thread's loads
// (load) held in registers until its stores (store), so that a caller
// issues all of its copies' loads before any store
template <int G, int ROWS, int THREADS, typename U>
struct RowCopy {
  static constexpr int BYTES = G * sizeof(U) < 16 ? G * sizeof(U) : 16, VEC = BYTES / sizeof(U);
  static constexpr int PER_ROW = G / VEC, ITEMS = ROWS * PER_ROW;
  static constexpr int K = (ITEMS + THREADS - 1) / THREADS;
  using V = typename Vec<BYTES>::type;
  V v[K];

  // the rows below `rows`
  template <class At>
  __device__ __forceinline__ void load(const U* __restrict__ src, const At& at, int rows, int tid) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * THREADS, row = i / PER_ROW;
      if (i < ITEMS && row < rows)
        v[k] = *reinterpret_cast<const V*>(src + at(row) + (i % PER_ROW) * VEC);
    }
  }
  __device__ __forceinline__ void store(U* dst, int rows, int tid) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * THREADS;
      if (i < ITEMS && i / PER_ROW < rows) reinterpret_cast<V*>(dst)[i] = v[k];
    }
  }
};

// The G columns c0.. of one frame pair, staged for kernel 1's first pass:
// the two frames' samples (element e of frame f, 0: xa, 1: xa + hop, at
// stage[(f N1 + e) G + b]) and the window (wstage[e G + b]), each row a run
// of G values, copied as vectors where the audio's frames and rows and the
// window's rows are aligned to them and the group is whole (cols == G),
// else a value at a time, COPY loads a thread in flight; every load of a
// thread issued before its stores. A phantom second frame (has_b false) is
// not read. Either way the first pass reads the same values from the same
// place, so an unaligned view's magnitudes are bit for bit an aligned one's.
template <int G, int N1, int THREADS, typename T>
__device__ __forceinline__ void stage_columns(const T* __restrict__ xa, int hop, bool has_b,
                                              const float* __restrict__ window, int n2, int c0,
                                              int cols, T* stage, float* wstage, int tid) {
  using Samples = RowCopy<G, 2 * N1, THREADS, T>;
  using Window = RowCopy<G, N1, THREADS, float>;
  const uintptr_t at = reinterpret_cast<uintptr_t>(xa) | static_cast<uintptr_t>(n2) * sizeof(T) |
                       static_cast<uintptr_t>(hop) * sizeof(T);
  const uintptr_t w_at = reinterpret_cast<uintptr_t>(window) | static_cast<uintptr_t>(n2) * 4;
  const int rows = has_b ? 2 * N1 : N1;
  if (cols == G && at % Samples::BYTES == 0 && w_at % Window::BYTES == 0) {
    Samples samples;
    Window w;
    samples.load(xa + c0, [&](int row) { return (row / N1) * hop + (row % N1) * n2; }, rows, tid);
    w.load(window + c0, [&](int row) { return row * n2; }, N1, tid);
    samples.store(stage, rows, tid);
    w.store(wstage, N1, tid);
  } else {
    constexpr int ITEMS = 3 * N1 * G;  // the samples' rows, then the window's
    for (int i0 = tid; i0 < ITEMS; i0 += COPY * THREADS) {
      float v[COPY];
#pragma unroll
      for (int k = 0; k < COPY; ++k) {
        const int i = i0 + k * THREADS, row = i / G, b = i % G;
        if (i < ITEMS && b < cols)
          v[k] = row >= 2 * N1 ? window[(row - 2 * N1) * n2 + c0 + b]
                 : row < rows  ? static_cast<float>(xa[(row / N1) * hop + (row % N1) * n2 + c0 + b])
                               : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < COPY; ++k) {
        const int i = i0 + k * THREADS, row = i / G;
        if (i < ITEMS && i % G < cols) {
          if (row >= 2 * N1)
            wstage[i - 2 * N1 * G] = v[k];
          else
            stage[i] = static_cast<T>(v[k]);
        }
      }
    }
  }
}

// Kernel 1 of the FFT mode: CTA blockIdx.x owns column group blockIdx.x %
// col_groups of the chunk's frame pair blockIdx.x / col_groups, whose
// scratch is scratch + that pair * n. Shared memory: where S is compiled
// whole the twiddles' two tables (tables + tab_off: lo, then hi), then the
// buffers. S: Generic, or the Fixed column side the plan's is (Columns).
template <typename T, class S>
__global__ void __launch_bounds__(S::most_threads, S::ctas)
fft_columns_kernel(const T* __restrict__ audio, const float* __restrict__ window,
                   const float2* __restrict__ tables, float2* __restrict__ scratch, int pair0,
                   int n_frames, int hop, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;  // read with the pass index, so from shared memory
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (!S::compiled && tid == 0) p = plan;
  // the twiddles' tables: copied to shared memory where the side is
  // compiled whole; the generic kernel, whose CTAs may hold a few hundred
  // values (16 columns of 16 points), reads them where they lie (L1)
  const double2* lo = reinterpret_cast<const double2*>(tables + plan.tab_off);
  if constexpr (S::compiled) {
    const uint4* src = reinterpret_cast<const uint4*>(lo);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < plan.tab_bytes / 16; i += nthreads) dst[i] = src[i];
    lo = reinterpret_cast<const double2*>(smem);
  }
  const double2* hi = lo + (1 << plan.tw_log2);
  const int tw_log2 = plan.tw_log2, n2 = plan.n2;
  float2* za = reinterpret_cast<float2*>(smem + (S::compiled ? plan.tab_bytes : 0));
  const int local = blockIdx.x / plan.col_groups;
  const int c0 = (blockIdx.x % plan.col_groups) * plan.g1;
  const int cols = n2 - c0 < plan.g1 ? n2 - c0 : plan.g1;
  float2* s = scratch + static_cast<long long>(local) * plan.n;
  const int t0 = 2 * (pair0 + local);
  const T* xa = audio + static_cast<long long>(t0) * hop;
  const PairColumns<T> load{xa, xa + hop, t0 + 1 < n_frames, window, n2, c0};
  __syncthreads();
  if constexpr (S::compiled) {
    // the last pass's outputs times their twiddles into the scratch; the
    // columns past the right edge (b >= cols) load zeros and store nothing
    const auto last = [&](int k1, int b, float2 v) {
      if (b < cols) {
        const int j = c0 + b;
        s[k1 * n2 + j] = twiddled(v, twiddle(lo, hi, tw_log2, k1 * j));
      }
    };
    if constexpr (sizeof(T) < 4) {
      // 1- and 2-byte samples, read a sample a thread, left the loads short
      // of the bytes the card moves: staged in the buffer with the window,
      // which the first pass reads and then overwrites in place
      T* stage = reinterpret_cast<T*>(za);
      float* wstage = reinterpret_cast<float*>(stage + 2 * S::n * S::g);
      stage_columns<S::g, S::n, S::threads>(xa, hop, load.has_b, window, n2, c0, cols, stage,
                                            wstage, tid);
      __syncthreads();
      S::template fft<true, false>(
          [&](int e, int b) {
            if (b >= cols) return make_float2(0.0f, 0.0f);
            const float w = wstage[e * S::g + b];
            return make_float2(w * sample_to_f32(stage[e * S::g + b]),
                               load.has_b ? w * sample_to_f32(stage[(S::n + e) * S::g + b])
                                          : 0.0f);
          },
          za, tables, tid, last);
    } else {
      S::template fft<false, false>(
          [&](int e, int b) { return b < cols ? load(e, b) : make_float2(0.0f, 0.0f); }, za,
          tables, tid, last);
    }
  } else {
    const float2* y = batched_fft(load, za, za + plan.n1 * plan.cstride, tables, p.col,
                                  plan.cstride, cols, tid, nthreads);
    for (Walk w(tid, nthreads, cols); w.o < plan.n1; w.step()) {
      const int j = c0 + w.i;
      s[w.o * n2 + j] = twiddled(y[w.o * plan.cstride + w.i], twiddle(lo, hi, tw_log2, w.o * j));
    }
  }
}

// Kernel 1 of the chirp mode: CTA blockIdx.x owns column group blockIdx.x %
// col_groups of the chunk's frame pair blockIdx.x / col_groups, the first
// FFT's columns.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
columns_kernel(const T* __restrict__ audio, const float* __restrict__ window,
               const float2* __restrict__ tables, const float2* __restrict__ chirp,
               float2* __restrict__ scratch, int pair0, int n_frames, int hop, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;  // read with the pass index, so from shared memory
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (tid == 0) p = plan;
  __syncthreads();
  const int local = blockIdx.x / plan.col_groups;
  const int c0 = (blockIdx.x % plan.col_groups) * plan.g1;
  const int cols = plan.n2 - c0 < plan.g1 ? plan.n2 - c0 : plan.g1;
  float2* za = reinterpret_cast<float2*>(smem);
  float2* zb = za + plan.n1 * plan.cstride;
  float2* s = scratch + static_cast<long long>(local) * plan.n;
  const float2* t = tables + plan.tw_len;
  const int t0 = 2 * (pair0 + local);
  const T* xa = audio + static_cast<long long>(t0) * hop;
  const bool has_b = t0 + 1 < n_frames;
  columns(ChirpColumns<T>{xa, xa + hop, has_b, chirp, plan.chirp_n, plan.n2, c0}, tables, t, s,
          p, c0, cols, za, zb, tid, nthreads);
}

// The rows of a kernel-2 CTA, row group `group` of a frame pair: the row
// pairs {k1, n1 - k1}, k1 in [lo, hi), as local rows lo.. hi - 1 (alen),
// then the distinct mirrors b0.. b0 + blen - 1 (k1 = 0 and n1 / 2 pair with
// themselves)
struct RowGroup {
  int lo, hi, alen, blen, b0;
  __device__ __forceinline__ RowGroup(const Plan& plan, int group) {
    const int n1 = plan.n1, H = n1 / 2;
    lo = group * plan.g2;
    hi = lo + plan.g2 < H + 1 ? lo + plan.g2 : H + 1;
    // mirrors n1 - k1 > H of the rows k1 in [m_lo, m_hi): rows b0 .. n1 - m_lo
    const int m_lo = lo > 1 ? lo : 1, m_hi = hi < n1 - H ? hi : n1 - H;
    alen = hi - lo;
    blen = m_hi > m_lo ? m_hi - m_lo : 0;
    b0 = n1 - m_hi + 1;
  }
  __device__ __forceinline__ int rows() const { return alen + blen; }
  __device__ __forceinline__ int k1(int l) const { return l < alen ? lo + l : b0 + l - alen; }
};


// The rows of group g (rows_k1) from the scratch s into `za`, element e of
// local row l at e * stride + l: ITEMS values (rows * n2) on `nthreads`
// threads, PER loads a thread issued before their stores
template <int PER>
__device__ __forceinline__ void copy_rows(const float2* __restrict__ s, float2* za, int stride,
                                          const unsigned short* rows_k1, int n2, int items,
                                          int tid, int nthreads) {
  for (int f0 = tid; f0 < items; f0 += PER * nthreads) {
    float2 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = f0 + i * nthreads;
      if (f < items) v[i] = s[rows_k1[f / n2] * n2 + f % n2];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = f0 + i * nthreads;
      if (f < items) za[(f % n2) * stride + f / n2] = v[i];
    }
  }
}

// The FFT mode's untangle: Z[k1 + n1 k2] at k2 * stride + l (local row l
// of row k1 = rows_k1[l]); its mirror Z[N - k] in row (n1 - k1) % n1 at k2'
// = n2 - 1 - k2, or (n2 - k2) % n2 where k1 is 0. Writes the bins k <= N/2
// of the rows of frames t and t + 1.
__device__ __forceinline__ void untangle_rows(const float2* z, int stride,
                                              const unsigned short* rows_k1, const RowGroup& g,
                                              const Plan& plan, float* __restrict__ out, int t,
                                              int n_frames, int tid, int nthreads) {
  const int N = plan.n, n1 = plan.n1, n2 = plan.n2, n_bins = N / 2 + 1;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  for (Walk w(tid, nthreads, g.rows()); w.o <= (N / 2) / n1; w.step()) {
    const int k2 = w.o, l = w.i, k1 = rows_k1[l], k = k1 + n1 * k2;
    if (k > N / 2) continue;
    const int m1 = k1 == 0 ? 0 : n1 - k1;
    const int m2 = k1 != 0 ? n2 - 1 - k2 : k2 == 0 ? 0 : n2 - k2;
    const int lm = m1 >= g.lo && m1 < g.hi ? m1 - g.lo : g.alen + m1 - g.b0;
    write_bin(row_a, n_bins, has_b, k, z[k2 * stride + l], z[m2 * stride + lm]);
  }
}

// Kernel 2 of the FFT mode: CTA blockIdx.x owns row group blockIdx.x %
// row_groups of the chunk's frame pair blockIdx.x / row_groups, untangles
// and writes the pair's magnitudes of its rows. S: Generic, or the Fixed
// row side the plan's is (Rows).
template <class S>
__global__ void __launch_bounds__(S::most_threads, S::ctas)
fft_rows_kernel(const float2* __restrict__ tables, const float2* __restrict__ scratch,
                float* __restrict__ out, int pair0, int n_frames, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;
  __shared__ unsigned short rows_k1[2 * MAX_BATCH];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int local = blockIdx.x / plan.row_groups;
  const RowGroup g(plan, blockIdx.x % plan.row_groups);
  const int rows = g.rows();
  if (!S::compiled && tid == 0) p = plan;
  if (tid < rows) rows_k1[tid] = static_cast<unsigned short>(g.k1(tid));
  float2* za = reinterpret_cast<float2*>(smem);
  const float2* s = scratch + static_cast<long long>(local) * plan.n;
  const int t = 2 * (pair0 + local);
  __syncthreads();
  if constexpr (S::compiled) {
    constexpr int per = S::batch * S::n / S::threads;
    copy_rows<(per < COPY ? per : COPY)>(s, za, S::stride, rows_k1, S::n, rows * S::n, tid,
                                         S::threads);
    __syncthreads();
    // the rows past the group's (l >= rows) are transformed unread and never written out
    S::template fft<true, true>(Local{za, S::stride}, za, tables + plan.row.tw_off, tid,
                          [&](int e, int b, float2 v) { za[e * S::stride + b] = v; });
    __syncthreads();
    untangle_rows(za, S::stride, rows_k1, g, plan, out, t, n_frames, tid, S::threads);
  } else {
    copy_rows<COPY>(s, za, plan.rstride, rows_k1, plan.n2, rows * plan.n2, tid, nthreads);
    __syncthreads();
    const float2* z = batched_fft(Local{za, plan.rstride}, za + plan.n2 * plan.rstride, za,
                                  tables, p.row, plan.rstride, rows, tid, nthreads);
    untangle_rows(z, plan.rstride, rows_k1, g, plan, out, t, n_frames, tid, nthreads);
  }
}

// Kernel 2 of the chirp mode: CTA blockIdx.x owns row group blockIdx.x %
// row_groups (RowGroup) of the chunk's frame pair blockIdx.x / row_groups:
// the product with B and the second FFT's rows, written back over its rows
// of the scratch times W_M^(k1 p2).
__global__ void __launch_bounds__(MAX_THREADS, 2)
rows_kernel(const float2* __restrict__ tables, const float2* __restrict__ chirp,
            float2* __restrict__ scratch, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;
  __shared__ unsigned short rows_k1[2 * MAX_BATCH];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n1 = plan.n1, n2 = plan.n2;
  const int local = blockIdx.x / plan.row_groups;
  const RowGroup group(plan, blockIdx.x % plan.row_groups);
  const int rows = group.rows();
  if (tid == 0) p = plan;
  if (tid < rows) rows_k1[tid] = static_cast<unsigned short>(group.k1(tid));
  float2* za = reinterpret_cast<float2*>(smem);
  float2* zb = za + n2 * plan.rstride;
  float2* s = scratch + static_cast<long long>(local) * plan.n;
  __syncthreads();
  // the rows, each one run of n2 values of the scratch
  for (Walk w(tid, nthreads, n2); w.o < rows; w.step())
    za[w.i * plan.rstride + w.o] = s[rows_k1[w.o] * n2 + w.i];
  __syncthreads();
  float2* z = batched_fft(Local{za, plan.rstride}, zb, za, tables, p.row, plan.rstride, rows,
                          tid, nthreads);
  float2* other = z == za ? zb : za;
  const float2* g = batched_fft(Product{z, plan.rstride, chirp + 2 * plan.chirp_n, rows_k1, n1},
                                other, z, tables, p.row, plan.rstride, rows, tid, nthreads);
  const float2* t = tables + plan.tw_len;
  for (Walk w(tid, nthreads, n2); w.o < rows; w.step()) {
    const int at = rows_k1[w.o] * n2 + w.i;
    s[at] = cmul(g[w.i * plan.rstride + w.o], t[at]);
  }
}
// Kernel 3 of the chirp mode: CTA blockIdx.x owns fold group blockIdx.x %
// fold_groups of the chunk's frame pair blockIdx.x / fold_groups, the
// representatives d in [lo, hi) (lo = e + group * g3): local columns 0 ..
// alen - 1 are the columns f + d, then the partners f + e - d of those d
// that are not their own (d = 0 where e is 0, d = top where 2 top - e is
// n2: only at the ends of the range). It runs their N1-point FFTs over k1
// (u[n2 p1 + p2], p1 < n1, in shared memory) and writes the magnitudes of
// the bins k = n2 p1 + p2 <= n_fft / 2 of its columns: Z[k] = a[k] conj u[k]
// and its mirror Z[n_fft - k] from the partner column, untangled.
__global__ void __launch_bounds__(MAX_THREADS, 2)
columns_untangle_kernel(const float2* __restrict__ tables, const float2* __restrict__ a,
                        const float2* __restrict__ scratch, float* __restrict__ out, int pair0,
                        int n_frames, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;
  __shared__ unsigned short cols[2 * MAX_BATCH], partner[2 * MAX_BATCH];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n2 = plan.n2, f = plan.fold_f, e = plan.fold_e, top = plan.fold_top;
  const int local = blockIdx.x / plan.fold_groups;
  const int lo = e + (blockIdx.x % plan.fold_groups) * plan.g3;
  const int hi = lo + plan.g3 < top + 1 ? lo + plan.g3 : top + 1;
  // the representatives with a partner of their own: [b_lo, b_hi)
  const int b_lo = lo == 0 ? 1 : lo;
  const int b_hi = hi == top + 1 && 2 * top - e == n2 ? top : hi;
  const int alen = hi - lo, blen = b_hi > b_lo ? b_hi - b_lo : 0, ncols = alen + blen;
  if (tid == 0) p = plan;
  if (tid < ncols) {
    const int d = tid < alen ? lo + tid : b_lo + tid - alen;
    const int c = tid < alen ? f + d : f + e - d;  // from -n2 to 2 n2 - 1
    cols[tid] = static_cast<unsigned short>(c < 0 ? c + n2 : c >= n2 ? c - n2 : c);
    partner[tid] = static_cast<unsigned short>(
        tid >= alen ? d - lo : d < b_lo || d >= b_hi ? tid : alen + d - b_lo);
  }
  float2* za = reinterpret_cast<float2*>(smem);
  float2* zb = za + plan.n1 * plan.fstride;
  const float2* s = scratch + static_cast<long long>(local) * plan.n;
  __syncthreads();
  const float2* u = batched_fft(ListColumns{s, cols, n2}, za, zb, tables, p.col, plan.fstride,
                                ncols, tid, nthreads);
  const int nf = plan.chirp_n, n_bins = nf / 2 + 1, t = 2 * (pair0 + local);
  const int q = nf / n2, r = nf - q * n2;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  for (Walk w(tid, nthreads, ncols); w.o <= (nf / 2) / n2; w.step()) {
    const int p1 = w.o, l = w.i, p2 = cols[l], k = p1 * n2 + p2;
    if (k > nf / 2) continue;
    // the mirror n_fft - k at row q - p1 (q - p1 - 1 where p2 > r) of the
    // partner column; bin 0 its own
    const int m = k == 0 ? 0 : nf - k;
    const float2 uk = u[p1 * plan.fstride + l];
    const float2 um = k == 0 ? uk : u[(p2 <= r ? q - p1 : q - p1 - 1) * plan.fstride + partner[l]];
    const float2 ck = a[k], cm = a[m];
    write_bin(row_a, n_bins, has_b, k,
              make_float2(ck.x * uk.x + ck.y * uk.y, ck.y * uk.x - ck.x * uk.y),
              make_float2(cm.x * um.x + cm.y * um.y, cm.y * um.x - cm.x * um.y));
  }
}

template <typename T>
using ColumnsKernel = void (*)(const T*, const float*, const float2*, float2*, int, int, int,
                               const Plan);
using RowsKernel = void (*)(const float2*, const float2*, float*, int, int, const Plan);

// side is the Fixed F's with its batch g
template <class F>
bool same_side(const Side& side, int g) {
  if (side.n != F::n || side.n_passes != F::passes || g != F::g) return false;
  for (int i = 0; i < F::passes; ++i)
    if (side.radix[i] != F::radix[i]) return false;
  return true;
}

// The FFT mode's kernels of a plan: the compiled kernel of each side that
// Columns and Rows hold, else the generic one (the plan's col_fixed and
// row_fixed, and its shared memory, set to what runs)
template <typename T, class... Fs>
ColumnsKernel<T> columns_of(Plan* p, Sides<Fs...>) {
  ColumnsKernel<T> kernel = nullptr;
  if (p->col_fixed)
    ((kernel == nullptr && same_side<Fs>(p->col, p->g1) ? (kernel = fft_columns_kernel<T, Fs>)
                                                        : kernel),
     ...);
  if (kernel == nullptr) kernel = fft_columns_kernel<T, Generic>;
  set_fixed(p, kernel != fft_columns_kernel<T, Generic>, p->row_fixed);
  return kernel;
}

template <class... Fs>
RowsKernel rows_of(Plan* p, Sides<Fs...>) {
  RowsKernel kernel = nullptr;
  if (p->row_fixed)
    ((kernel == nullptr && same_side<Fs>(p->row, p->g2) ? (kernel = fft_rows_kernel<Fs>)
                                                        : kernel),
     ...);
  if (kernel == nullptr) kernel = fft_rows_kernel<Generic>;
  set_fixed(p, p->col_fixed, kernel != fft_rows_kernel<Generic>);
  return kernel;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int run(const void* audio_v, const float* window, const float* tables_f, const float* chirp_f,
        Plan plan, float* scratch_f, int chunk_pairs, float* out, int n_frames, int hop,
        cudaStream_t s, int* launched) {
  const T* audio = static_cast<const T*>(audio_v);
  const float2* tables = reinterpret_cast<const float2*>(tables_f);
  const float2* chirp = reinterpret_cast<const float2*>(chirp_f);
  float2* scratch = reinterpret_cast<float2*>(scratch_f);
  const bool chirp_mode = plan.chirp_n != 0;
  ColumnsKernel<T> fft_columns = nullptr;
  RowsKernel fft_rows = nullptr;
  cudaError_t err;
  if (chirp_mode) {
    err = allow_smem(columns_kernel<T>, plan.col_bytes);
    if (err == cudaSuccess) err = allow_smem(rows_kernel, plan.row_bytes);
    if (err == cudaSuccess) err = allow_smem(columns_untangle_kernel, plan.fold_bytes);
  } else {
    fft_columns = columns_of<T>(&plan, Columns{});
    fft_rows = rows_of(&plan, Rows{});
    err = allow_smem(fft_columns, plan.col_bytes);
    if (err == cudaSuccess) err = allow_smem(fft_rows, plan.row_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = (n_frames + 1) / 2;
  for (int pair0 = 0; pair0 < n_pairs; pair0 += chunk_pairs) {
    const int pairs = n_pairs - pair0 < chunk_pairs ? n_pairs - pair0 : chunk_pairs;
    const dim3 cols_grid(pairs * plan.col_groups), rows_grid(pairs * plan.row_groups);
    if (!chirp_mode) {
      fft_columns<<<cols_grid, plan.col_threads, plan.col_bytes, s>>>(
          audio, window, tables, scratch, pair0, n_frames, hop, plan);
      fft_rows<<<rows_grid, plan.row_threads, plan.row_bytes, s>>>(tables, scratch, out, pair0,
                                                                  n_frames, plan);
    } else {
      columns_kernel<T><<<cols_grid, plan.col_threads, plan.col_bytes, s>>>(
          audio, window, tables, chirp, scratch, pair0, n_frames, hop, plan);
      rows_kernel<<<rows_grid, plan.row_threads, plan.row_bytes, s>>>(tables, chirp, scratch,
                                                                     plan);
      columns_untangle_kernel<<<pairs * plan.fold_groups, plan.fold_threads, plan.fold_bytes,
                                s>>>(tables, chirp + plan.chirp_n, scratch, out, pair0,
                                     n_frames, plan);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *launched += chirp_mode ? 3 : 2;
  }
  return 0;
}

// A kernel's launch as the card takes it, in info[6]: threads a CTA, CTAs
// resident on an SM, dynamic shared memory a CTA, registers and local
// (spilled) bytes a thread, and 1 where it is compiled whole
template <typename Kernel>
int describe(Kernel kernel, int threads, int bytes, bool compiled, int* info) {
  int ctas = 0;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, bytes);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int values[6] = {threads, ctas, bytes, fa.numRegs, static_cast<int>(fa.localSizeBytes),
                         compiled ? 1 : 0};
  for (int i = 0; i < 6; ++i) info[i] = values[i];
  return 0;
}

template <typename T>
int layout(Plan plan, int* info) {
  if (plan.chirp_n != 0) {
    int err = describe(columns_kernel<T>, plan.col_threads, plan.col_bytes, false, info);
    if (err == 0) err = describe(rows_kernel, plan.row_threads, plan.row_bytes, false, info + 6);
    if (err == 0)
      err = describe(columns_untangle_kernel, plan.fold_threads, plan.fold_bytes, false,
                     info + 12);
    return err;
  }
  const ColumnsKernel<T> columns = columns_of<T>(&plan, Columns{});
  const RowsKernel rows = rows_of(&plan, Rows{});
  for (int i = 12; i < 18; ++i) info[i] = 0;
  const int err = describe(columns, plan.col_threads, plan.col_bytes, plan.col_fixed, info);
  return err != 0 ? err
                  : describe(rows, plan.row_threads, plan.row_bytes, plan.row_fixed, info + 6);
}

// The plan's checks: a plan of this n_fft (or, chirp_mode, of a convolution
// length M for it) whose largest odd radix is within this build's; nonzero
// where not.
int check(const int* packed, int n_fft, bool chirp_mode, Plan* p) {
  if (n_fft < 2 || n_fft > MAX_N_FFT || packed == nullptr ||
      make_plan(packed, n_fft, chirp_mode, p))
    return static_cast<int>(cudaErrorInvalidValue);
  int odd = 1;  // the largest odd radix the plan needs: within this build's
  const Side* sides[2] = {&p->col, &p->row};
  for (const Side* side : sides)
    for (int i = 0; i < side->n_passes; ++i)
      if (side->radix[i] % 2 && side->radix[i] > odd) odd = side->radix[i];
  return odd > ORCAI_ODD ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); plan: host int32 [N1, N2, G1,
// G2, len1, len2, P1, radices, P2, radices] and in the chirp mode [G3, f]
// (ops/dft.py::_staged_plan_array); tables: ops/dft.py::staged_tables of N1
// * N2, float32 (re, im): in the FFT mode with product twiddles (the pass
// roots, then the twiddles' two float64 tables), in the chirp mode with
// four_step_roots; scratch: chunk_pairs * N1 * N2 complex float32 on the
// device (chunk_pairs frame pairs a chunk); out: (n_frames, n_fft/2 + 1)
// float32; hop divides n_fft. With chirp null (the FFT mode) N1 * N2 is
// n_fft and window is the (n_fft,) float32 window. Otherwise (the chirp
// mode) N1 * N2 is an M >= 2 n_fft - 1 up to 2^21, chirp is ops/dft.py::
// chirp_tables' (2 n_fft + M, 2) float32 and window is not read. n_fft is
// at most 2^20; the plan's largest odd radix may not pass this build's
// ORCAI_ODD. Launches 2 kernels a chunk (3 in the chirp mode) on `stream`,
// adds the kernels it launched to *launched and returns the first CUDA
// error.
extern "C" int orcai_dft_staged(const void* audio, int dtype, const float* window,
                                const float* tables, const float* chirp, const int* plan,
                                float* scratch, int chunk_pairs, float* out, int n_frames,
                                int n_fft, int hop, void* stream, int* launched) {
  if (hop < 1 || hop > n_fft || n_fft % hop != 0 || n_frames < 1 || tables == nullptr ||
      scratch == nullptr || out == nullptr || chunk_pairs < 1 ||
      (chirp == nullptr && window == nullptr) || launched == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const int err = check(plan, n_fft, chirp != nullptr, &p);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(audio, window, tables, chirp, p, scratch, chunk_pairs, out, n_frames,
                              hop, s, launched);
    case 1: return run<int16_t>(audio, window, tables, chirp, p, scratch, chunk_pairs, out,
                                n_frames, hop, s, launched);
    case 2: return run<uint8_t>(audio, window, tables, chirp, p, scratch, chunk_pairs, out,
                                n_frames, hop, s, launched);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a launch of the plan (the FFT mode at n_fft, or with chirp nonzero
// the chirp mode) takes on the current device, in info[18]: for each of its
// kernels (columns, rows and, in the chirp mode, the columns' untangle;
// zeros past the mode's kernels) threads a CTA, CTAs resident on an SM,
// dynamic shared memory a CTA, registers and local (spilled) bytes a
// thread, and 1 where the kernel is compiled whole. Returns the CUDA error
// a launch would meet.
extern "C" int orcai_dft_staged_layout(int dtype, const int* plan, int n_fft, int chirp,
                                       int* info) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const int err = check(plan, n_fft, chirp != 0, &p);
  if (err != 0) return err;
  switch (dtype) {
    case 0: return layout<float>(p, info);
    case 1: return layout<int16_t>(p, info);
    case 2: return layout<uint8_t>(p, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
