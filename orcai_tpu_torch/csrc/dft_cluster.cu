// Windowed rDFT magnitude of hop-framed audio at any n_fft from 8193 to
// 81920 whose prime factors are all in {2, 3, 5, 7, 11, 13, 17, 19, 23}
// (dft_staged.cu takes those with a 29 or a 31), and, in its chirp-z mode,
// at any n_fft from 4097 to 40960 with a prime factor above 31, from the
// padded samples: out[t, k] = |sum_n w[n] x[t*hop + n] exp(-2 pi i n k / N)|,
// k = 0..N/2, as a batched FFT whose frame pair spans a thread block cluster.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel) at the sizes too large for one SM: dft_mixed.cu keeps a
// frame pair's two exchange buffers of N complex values in one SM's shared
// memory, which caps it at 8192 points (4096 in its chirp mode, whose
// convolution length M >= 2N - 1 must fit). Recordings at 96-192 kHz and
// parameter files with such an nfft reach these sizes.
//
// Bound on the card: bytes. The function reads each sample once and writes
// each magnitude once: at 16384 / 8192 a 32768-frame int16 tile is 0.54 GB
// in and 1.07 GB out, 0.48 ms at 3.35 TB/s (16418 / 8209 the same); at
// 32768 / 16384 twice that, at 65536 / 32768 four times. The FFT's
// operations stay below that (about 2.5 N log2 N a frame: 0.28 ms of fp32
// at 67 TFLOP/s at 16384; the chirp mode's two FFTs of M points about four
// times an FFT of N).
//
// Design. A cluster of C CTAs owns one frame pair at a time, on SMs of one
// GPC that read each other's shared memory (Hopper's distributed shared
// memory, cooperative_groups::this_cluster(); 8 is the portable cluster
// size), so each CTA holds N/C of each of the pair's two exchange buffers.
// C is the fewest CTAs whose CTA fits twice on an SM (ops/dft.py::
// cluster_plan: 4 at 16384, 8 at 32768, 74 and 79 KB), so that two CTAs of
// 256 threads, of two clusters and so of two frame pairs, share each SM:
// while one waits at a barrier, the other runs. Where no cluster of up to 8
// fits so (above about 48000 points: 65536, 81920), 8 CTAs of 512 threads
// take one SM each (dft_cluster_plan.cuh::threads_of). A persistent grid of
// as many clusters as fit (cudaOccupancyMaxActiveClusters; none is an
// error, never a fallback) walks the pairs. The FFT of z = w*x_t +
// i*w*x_t+1 runs as the four-step split N = N1 * N2 (both at most 8192;
// 16384 = 128 x 128, 32768 = 256 x 128, 65536 = 256 x 256):
//   1. rank c takes the columns j in [col_lo[c], col_lo[c+1]) and runs their
//      N1-point FFTs over z[N2 n1 + j], reading the samples straight from
//      device memory (consecutive columns are consecutive samples), with the
//      Stockham passes of fft_plan(N1) batched over the columns;
//   2. cluster.sync() (every rank is done with its scratch buffer), then one
//      exchange: rank c multiplies its values by W_N^(j k1) and stores each
//      into the shared memory of the rank that holds its row k1, as runs of
//      consecutive words (remote stores do not wait for a reply), through
//      each rank's buffer address taken once at the start;
//   3. cluster.sync(), then the N2-point FFTs of its rows (fft_plan(N2)),
//      leaving Z[k1 + N1 k2] on the rank of k1;
//   4. the untangle: X_t[k] = (Z[k] + conj Z[N-k])/2, X_t+1[k] = (Z[k] -
//      conj Z[N-k])/2i for the bins k <= N/2 it holds, and IEEE sqrtf
//      magnitudes written as runs of consecutive bins. The rows go to the
//      ranks in pairs {k1, N1 - k1}, so the mirror bin Z[N-k] lies on the
//      same rank and the untangle reads local memory only.
// Stockham's own strides would put (C-1)/C of every butterfly's inputs on
// other CTAs; the four-step split moves each value between CTAs once a
// pair, with two cluster barriers, and runs every pass on local data. A batch
// of FFTs lies element-major (element e of FFT b at e * stride + b, the
// stride odd), so a warp's butterflies read and write consecutive words
// and the exchange's strided writes fall on distinct banks; the roots are
// the same across the batch (broadcasts) and sit in shared memory in pass
// order (ops/dft.py::pass_roots). The twiddles W_N^m (m = j k1 < N) are
// products of two tables of float64 roots in shared memory, S + N/S values
// (dft_cluster_plan.cuh::twiddle_split), multiplied in float64 and rounded
// once, which gives the float64 root rounded once (ops/dft.py::
// four_step_roots) at every twiddle of the powers of two and all but 2 or 3
// of the chirp lengths' (tests/test_torch_kernels_plain.py): no table of N
// values is read from device memory each pair. With the exchange's multiply
// spelled out (twiddled), the magnitudes are bit for bit those of the
// kernel before this design wherever the twiddles are.
//
// What holds it is instructions and latency, not bytes: taken apart on
// the card (tools/probe_cluster.py), the kernel before this design spent three
// quarters of its time at 16384 without its passes, its twiddle loads 13 %,
// its exchange 1 %; index arithmetic on plans read at run time (a division
// in every walk over a batch, a radix chosen each pass) is much of what is
// left. So the plans whose radices are all powers of two are compiled whole
// (Fixed, Compiled: every size, stride and pass a constant); in the route's
// reach they are the plans of 16384, 32768 and 65536 and no others
// (tests/test_torch_kernels_plain.py enumerates them). Every other plan
// (each of the other 2670 sizes has one of its own, with an odd radix, and
// the chirp mode's) runs the generic kernel, which reads its plan at run
// time. Staging the next pair's samples in shared
// memory ahead of its first pass (cp.async) made it slower, and is not
// done; see PERF.md for the times against the bound and torch.stft.
//
// Where a row or a column lies is a 32-bit lookup, rank << 16 | local
// index. The butterflies are dft_mixed.cu's (dft_butterflies.cuh): radix 16
// as 4 x 4, the odd radices up to 23 direct over symmetric pairs; the
// kernel is built for the largest odd radix its plans need (17, or 23 also
// for the plans of 19), and for each sample type, each a build of its own
// (-DORCAI_ODD, -DORCAI_DTYPE, ops/_build.py), compiled beside the others;
// the compiled plans, which have no odd radix, in the radix-17 builds.
//
// The chirp-z (Bluestein) mode, for an n_fft N with a prime factor above 23
// whose convolution length M (ops/dft.py::chirp_length: 8198 -> 16456 =
// 136 x 121 on 4 CTAs, 16418 -> 32851 = 247 x 133 on 8, two CTAs an SM,
// 24578 -> 50864 = 272 x 187 on 8, one an SM) is above dft_mixed.cu's
// 8192: z = (w a)[n] (x_t + i x_t+1)[n] zero-padded to M, its M-point FFT
// by the four steps above, then the product with B = FFT_M(b) / M and the
// conjugate, taken where the first FFT leaves each value; the second
// forward FFT runs rows first (the N2-point FFTs over k2 of each row k1 the
// rank already holds, W_M^(k1 p2), an exchange back to the columns, the
// N1-point FFTs over k1), so no exchange comes between the two FFTs; then
// Z[k] = a[k] conj(u[k]) and the untangle, whose mirror bins u[n_fft - k]
// lie on other ranks. One kernel (the generic one), six cluster barriers a
// pair. Its tables wa, a and B are read from device memory where each
// value needs them.
//
// uint8 input is mu-law codes (the mulaw8 wire), decoded where a sample is
// read, so the codes and their int16 decode give the same magnitudes. IEEE
// fp32 throughout: no TF32, no fast-math sqrt, sincos or exp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#if !defined(ORCAI_ODD) || (ORCAI_ODD != 17 && ORCAI_ODD != 23)
#error "build with -DORCAI_ODD=17 or 23 (ops/_build.py::VARIANTS)"
#endif
#if !defined(ORCAI_DTYPE) || ORCAI_DTYPE < 0 || ORCAI_DTYPE > 2
#error "build with -DORCAI_DTYPE=0 (float32), 1 (int16) or 2 (uint8 mu-law codes)"
#endif

namespace cg = cooperative_groups;

namespace {

#include "dft_butterflies.cuh"

// ORCAI_ODD, the largest odd radix a build is for (17 or 23), leaves the
// radix-19 and -23 butterflies out of the kernels of the plans that lack
// them
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
  case 17: CALL(17); break;     \
  case 19: if constexpr (ORCAI_ODD >= 19) { CALL(19); } break; \
  case 23: if constexpr (ORCAI_ODD >= 23) { CALL(23); } break;

#include "dft_batched.cuh"
#include "dft_cluster_plan.cuh"

using Sample = std::conditional_t<ORCAI_DTYPE == 0, float,
                                  std::conditional_t<ORCAI_DTYPE == 1, int16_t, uint8_t>>;

// A thread's loads are issued EXCHANGE at a time before its remote stores,
// which the compiler may not move them past: their latencies overlap.
constexpr int EXCHANGE = 4;

// The four-step twiddles' tables in shared memory (twiddle and twiddled,
// the exchange's product with them, are dft_batched.cuh's)
struct Twiddles {
  const double2* lo;
  const double2* hi;
  int s;
  __device__ __forceinline__ float2 operator()(int m) const { return twiddle(lo, hi, s, m); }
};

// Rank `me` sends its columns (`ys`, the column layout) to the ranks that
// hold their rows: element j of row k1 goes to local row l of the rank of
// k1 (home_row[k1]), at j * rstride + l in that rank's buffer at `off`
// from its first (the same buffer on every rank; peer: each rank's first
// buffer), times W_N^(k1 j). Consecutive threads take consecutive rows, so
// each rank receives runs of consecutive words. P: the Plan, or a plan
// compiled whole (Fixed) whose sizes and strides are constants.
template <class P>
__device__ __forceinline__ void push_rows(float2* const* peer, const float2* ys, int off,
                                          const Twiddles& tw, const unsigned* home_row,
                                          const P& p, int c0, int cols, int tid, int nthreads) {
  Walk w(tid, nthreads, p.n1);  // (column b, row k1)
  while (w.o < cols) {
    float2 v[EXCHANGE];
    float2* at[EXCHANGE];
    int n = 0;
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i) {
      if (w.o >= cols) break;
      const int b = w.o, k1 = w.i, j = c0 + b;
      const unsigned h = home_row[k1];
      v[i] = twiddled(ys[k1 * p.cstride + b], tw(j * k1));
      at[i] = peer[h >> HOME_SHIFT] + off + j * p.rstride + (h & HOME_MASK);
      ++n;
      w.step();
    }
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i)
      if (i < n) *at[i] = v[i];
  }
}

// The chirp mode's second exchange: rank `me` sends its rows (`gs`, the row
// layout) to the ranks that hold their columns: element p2 of row k1 goes
// to k1 * cstride + the local column in the buffer at `off` of the rank of
// column p2 (home_col[p2]), times W_M^(k1 p2); consecutive threads take
// consecutive p2.
__device__ __forceinline__ void push_columns(float2* const* peer, const float2* gs, int off,
                                             const Twiddles& tw, const unsigned short* rows_k1,
                                             const unsigned* home_col, const Plan& p, int rows,
                                             int tid, int nthreads) {
  Walk w(tid, nthreads, p.n2);  // (local row l, column p2)
  while (w.o < rows) {
    float2 v[EXCHANGE];
    float2* at[EXCHANGE];
    int n = 0;
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i) {
      if (w.o >= rows) break;
      const int l = w.o, p2 = w.i, k1 = rows_k1[l];
      const unsigned h = home_col[p2];
      v[i] = twiddled(gs[p2 * p.rstride + l], tw(k1 * p2));
      at[i] = peer[h >> HOME_SHIFT] + off + k1 * p.cstride + (h & HOME_MASK);
      ++n;
      w.step();
    }
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i)
      if (i < n) *at[i] = v[i];
  }
}

// The FFT mode's untangle: Z[k1 + n1 k2] lies at k2 * rstride + l on the
// rank of row k1 (local row l), and so does its mirror Z[N - k] (row
// (n1 - k1) % n1, of the same row pair, and k2' = n2 - 1 - k2, or
// (n2 - k2) % n2 where k1 is 0); rank `me` writes the bins k <= N/2 of its
// rows from its own shared memory.
template <class P>
__device__ __forceinline__ void untangle_rows(const float2* zs, const unsigned short* rows_k1,
                                              const unsigned* home_row, const P& p, int rows,
                                              float* __restrict__ out, int t, int n_frames,
                                              int tid, int nthreads) {
  const int N = p.n, n1 = p.n1, n2 = p.n2, n_bins = N / 2 + 1;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  for (Walk w(tid, nthreads, rows); w.o <= (N / 2) / n1; w.step()) {
    const int k2 = w.o, l = w.i, k1 = rows_k1[l], k = k1 + n1 * k2;
    if (k > N / 2) continue;
    const int m1 = k1 == 0 ? 0 : n1 - k1;
    const int m2 = k1 != 0 ? n2 - 1 - k2 : k2 == 0 ? 0 : n2 - k2;
    const int lm = home_row[m1] & HOME_MASK;
    write_bin(row_a, n_bins, has_b, k, zs[k2 * p.rstride + l], zs[m2 * p.rstride + lm]);
  }
}

// The chirp mode's untangle: u[n2 p1 + p2] lies at p1 * cstride + the local
// column on the rank of column p2 (`us`, at `off` from the first buffer),
// Z[k] = a[k] conj(u[k]); rank `me` writes the bins k <= n_fft/2 of its
// columns, the mirror u[n_fft - k] read from the rank that holds it.
__device__ __forceinline__ void untangle_columns(float2* const* peer, const float2* us, int off,
                                                 const float2* __restrict__ a,
                                                 const unsigned* home_col, const Plan& p, int c0,
                                                 int cols, float* __restrict__ out, int t,
                                                 int n_frames, int tid, int nthreads) {
  const int N = p.chirp_n, n_bins = N / 2 + 1;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  Walk w(tid, nthreads, cols);  // (p1, local column b)
  while (w.o <= (N / 2) / p.n2) {
    float2 u[EXCHANGE], v[EXCHANGE], ck[EXCHANGE], cm[EXCHANGE];
    int bin[EXCHANGE];
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i) {
      const int p1 = w.o, b = w.i, k = p.n2 * p1 + c0 + b;
      bin[i] = p1 <= (N / 2) / p.n2 && k <= N / 2 ? k : -1;
      w.step();
      if (bin[i] < 0) continue;
      const int m = k == 0 ? 0 : N - k, m1 = m / p.n2;
      const unsigned h = home_col[m - m1 * p.n2];
      u[i] = us[p1 * p.cstride + b];
      v[i] = peer[h >> HOME_SHIFT][off + m1 * p.cstride + (h & HOME_MASK)];
      ck[i] = a[k];
      cm[i] = a[m];
    }
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i)
      if (bin[i] >= 0)
        write_bin(row_a, n_bins, has_b, bin[i],
                  make_float2(ck[i].x * u[i].x + ck[i].y * u[i].y,
                              ck[i].y * u[i].x - ck[i].x * u[i].y),
                  make_float2(cm[i].x * v[i].x + cm[i].y * v[i].y,
                              cm[i].y * v[i].x - cm[i].x * v[i].y));
  }
}

// The plans read at run time from the Plan.
struct Generic {
  static constexpr bool compiled = false;
  // launched with PAIR_THREADS (two CTAs an SM) or SOLO_THREADS (threads_of):
  // the registers of SOLO_THREADS on one SM hold two CTAs of PAIR_THREADS
  static constexpr int most_threads = SOLO_THREADS, ctas = 1;
};

// A plan compiled whole: N1 = R0 * R1 and N2 = R2 * R3, two passes a side,
// in the FFT mode on RANKS CTAs, each rank N2 / RANKS columns; every size,
// stride and pass a constant, so that no index is divided at run time and
// no radix is chosen. The plans whose radices are all powers of two
// (Compiled).
template <int R0, int R1, int R2, int R3, int RANKS>
struct Fixed {
  static constexpr bool compiled = true;
  static constexpr int n1 = R0 * R1, n2 = R2 * R3, n = n1 * n2, ranks = RANKS;
  static constexpr int len1 = (R1 - 1) * R0, len2 = (R3 - 1) * R2;  // the sides' pass roots
  static constexpr int packed[11] = {RANKS, n1, n2, len1, len2, 2, R0, R1, 2, R2, R3};
  static constexpr Plan planned() {
    Plan p{};
    make_plan(packed, n, false, &p);
    return p;
  }
  static constexpr int cstride = planned().cstride, rstride = planned().rstride;
  static constexpr int cols = n2 / RANKS, threads = threads_of(planned());
  static constexpr int most_threads = threads, ctas = threads == PAIR_THREADS ? 2 : 1;
  static_assert(n2 % RANKS == 0, "every rank holds as many columns");
  static_assert(planned().bytes > 0, "a plan make_plan takes");

  // the plan's two passes of a side: `batch` FFTs of N = A * B points at
  // `stride`, from `load` into `first` and on into `second`, the roots of
  // the second pass at tw
  template <int A, int B, int N, int STRIDE, class Load>
  static __device__ __forceinline__ float2* side(const Load& load, float2* first, float2* second,
                                                 const float2* tw, int batch, int tid) {
    first_pass<A>(load, first, STRIDE, batch, N, tid, threads);
    __syncthreads();
    pass<B>(first, second, STRIDE, batch, tw, N, A, tid, threads);
    __syncthreads();
    return second;
  }

  // one frame pair (frames t0, t0 + 1 from xa): the columns, the exchange,
  // the rows and the untangle, as the generic path runs them
  template <typename T>
  static __device__ __forceinline__ void pair(const T* xa, int hop, bool has_b,
                                              const float* window, float2* za, float2* zb,
                                              const float2* tw, float2* const* peer,
                                              const Twiddles& twiddles, const unsigned* home_row,
                                              const unsigned short* rows_k1, int me, int rows,
                                              float* out, int t0, int n_frames, int tid) {
    cg::cluster_group cluster = cg::this_cluster();
    const int c0 = me * cols;
    float2* y = side<R0, R1, n1, cstride>(PairColumns<T>{xa, xa + hop, has_b, window, n2, c0}, za,
                                         zb, tw, cols, tid);
    cluster.sync();  // every rank is done with its columns and their scratch buffer za
    push_rows(peer, y, 0, twiddles, home_row, Fixed{}, c0, cols, tid, threads);
    cluster.sync();  // every rank's rows are whole
    const float2* z = side<R2, R3, n2, rstride>(Local{za, rstride}, zb, za, tw + len1, rows, tid);
    untangle_rows(z, rows_k1, home_row, Fixed{}, rows, out, t0, n_frames, tid, threads);
    __syncthreads();  // the buffers are free for the next pair
  }
};

// The plans compiled whole, every plan of the route whose radices are all
// powers of two, in the build of the least odd radix (they have none):
// 16384 = 128 x 128 on 4 CTAs and 32768 = 256 x 128 on 8, two CTAs
// an SM, and 65536 = 256 x 256 on 8, one CTA of SOLO_THREADS an SM; each
// is ops/dft.py::cluster_plan's (tests/test_torch_kernels_plain.py holds
// them to it).
template <class... Fs>
struct Plans {};
#if ORCAI_ODD == 17
using Compiled = Plans<Fixed<16, 8, 16, 8, 4>, Fixed<16, 16, 16, 8, 8>, Fixed<16, 16, 16, 16, 8>>;
#else
using Compiled = Plans<>;
#endif

// Each cluster walks the frame pairs (t, t + 1), t even; its CTAs hold the
// pair's two exchange buffers N/C values each. tables: both sides' pass
// roots (tw_len), then the twiddles' two tables of float64 roots (lo, S
// values, and hi), as table_bytes of the plan. Shared memory: the plan, the
// tables, the lookups (home_row[k1], home_col[j], rows_k1[l] of this rank),
// every rank's first buffer, the two buffers. F: Generic, whose CTAs take
// either count of threads (threads_of) within the registers of one CTA of
// SOLO_THREADS an SM, or the Fixed plan the launch's plan is (Compiled).
template <typename T, class F>
__global__ void __launch_bounds__(F::most_threads, F::ctas)
dft_cluster_kernel(const T* __restrict__ audio, const float* __restrict__ window,
                   const float2* __restrict__ tables, const float2* __restrict__ chirp,
                   float* __restrict__ out, int n_frames, int hop, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Plan& p = *reinterpret_cast<Plan*>(smem);  // read with the pass index, so from shared memory
  const float2* tw = reinterpret_cast<const float2*>(smem + PLAN_BYTES);
  const double2* lo = reinterpret_cast<const double2*>(smem + PLAN_BYTES +
                                                       ((plan.tw_len + 1) & ~1) * 8);
  const Twiddles twiddles{lo, lo + (1 << plan.tw_log2), plan.tw_log2};
  unsigned* home_row = reinterpret_cast<unsigned*>(smem + plan.tab_off);
  unsigned* home_col = home_row + plan.n1;
  unsigned short* rows_k1 = reinterpret_cast<unsigned short*>(home_col + plan.n2);
  float2** peer = reinterpret_cast<float2**>(smem + plan.peer_off);
  float2* za = reinterpret_cast<float2*>(smem + plan.z_off);
  float2* zb = za + plan.zbuf;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int me = static_cast<int>(cluster.block_rank());
  const int c0 = plan.col_lo[me], cols = plan.col_lo[me + 1] - c0;
  const int rows = plan.alen[me] + plan.blen[me];
  if (tid == 0) p = plan;
  {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    uint4* dst = reinterpret_cast<uint4*>(smem + PLAN_BYTES);
    for (int i = tid; i < plan.table_bytes / 16; i += nt) dst[i] = src[i];
  }
  __syncthreads();
  for (int k1 = tid; k1 < plan.n1; k1 += nt) home_row[k1] = home_of_row(p, k1);
  for (int l = tid; l < rows; l += nt)
    rows_k1[l] = static_cast<unsigned short>(row_of_local(p, me, l));
  for (int j = tid; j < plan.n2; j += nt) home_col[j] = home_of_col(p, j);
  for (int r = tid; r < plan.ranks; r += nt) peer[r] = cluster.map_shared_rank(za, r);
  __syncthreads();
  const int n_pairs = (n_frames + 1) / 2, n_clusters = gridDim.x / plan.ranks;
  for (int pair = blockIdx.x / plan.ranks; pair < n_pairs; pair += n_clusters) {
    const int t0 = 2 * pair;
    const T* xa = audio + static_cast<long long>(t0) * hop;
    const T* xb = xa + hop;
    const bool has_b = t0 + 1 < n_frames;
    if constexpr (F::compiled) {
      F::pair(xa, hop, has_b, window, za, zb, tw, peer, twiddles, home_row, rows_k1, me, rows,
              out, t0, n_frames, tid);
    } else if (plan.chirp_n == 0) {
      float2* y = batched_fft(PairColumns<T>{xa, xb, has_b, window, plan.n2, c0}, za, zb, tw,
                              p.col, plan.cstride, cols, tid, nt);
      float2* x = y == za ? zb : za;
      cluster.sync();  // every rank is done with its columns and their scratch buffer x
      push_rows(peer, y, static_cast<int>(x - za), twiddles, home_row, p, c0, cols, tid, nt);
      cluster.sync();  // every rank's rows are whole
      const float2* z = batched_fft(Local{x, plan.rstride}, y, x, tw, p.row, plan.rstride, rows,
                                    tid, nt);
      untangle_rows(z, rows_k1, home_row, p, rows, out, t0, n_frames, tid, nt);
      __syncthreads();  // the buffers are free for the next pair
    } else {
      const int nf = plan.chirp_n;
      float2* y = batched_fft(ChirpColumns<T>{xa, xb, has_b, chirp, nf, plan.n2, c0}, za, zb,
                              tw, p.col, plan.cstride, cols, tid, nt);
      float2* x = y == za ? zb : za;
      cluster.sync();
      push_rows(peer, y, static_cast<int>(x - za), twiddles, home_row, p, c0, cols, tid, nt);
      cluster.sync();
      float2* f1 = batched_fft(Local{x, plan.rstride}, y, x, tw, p.row, plan.rstride, rows, tid,
                               nt);
      // the second FFT, rows first, from the product where f1 leaves it
      float2* g = batched_fft(Product{f1, plan.rstride, chirp + 2 * nf, rows_k1, plan.n1},
                              f1 == za ? zb : za, f1, tw, p.row, plan.rstride, rows, tid, nt);
      float2* h = g == za ? zb : za;
      cluster.sync();  // every rank is done with its scratch buffer h
      push_columns(peer, g, static_cast<int>(h - za), twiddles, rows_k1, home_col, p, rows, tid,
                   nt);
      cluster.sync();
      float2* u = batched_fft(Local{h, plan.cstride}, g, h, tw, p.col, plan.cstride, cols, tid,
                              nt);
      cluster.sync();  // u is whole: the untangle reads mirror bins on other ranks
      untangle_columns(peer, u, static_cast<int>(u - za), chirp + nf, home_col, p, c0, cols, out,
                       t0, n_frames, tid, nt);
      cluster.sync();  // every remote read of this pair is done: the buffers are free
    }
  }
}

using Kernel = void (*)(const Sample*, const float*, const float2*, const float2*, float*, int,
                        int, const Plan);

// p and q are one plan: its sizes, CTAs and radices (the FFT mode)
bool same_plan(const Plan& p, const Plan& q) {
  if (p.chirp_n != 0 || p.n1 != q.n1 || p.n2 != q.n2 || p.ranks != q.ranks) return false;
  const Side* a[2] = {&p.col, &p.row};
  const Side* b[2] = {&q.col, &q.row};
  for (int s = 0; s < 2; ++s) {
    if (a[s]->n_passes != b[s]->n_passes) return false;
    for (int i = 0; i < a[s]->n_passes; ++i)
      if (a[s]->radix[i] != b[s]->radix[i]) return false;
  }
  return true;
}

// The kernel of a plan and its threads a CTA: the compiled kernel of the
// FFT mode's plan where Compiled holds it, else the generic one
template <class... Fs>
Kernel kernel_of(const Plan& p, int* threads, Plans<Fs...>) {
  Kernel kernel = nullptr;
  ((kernel == nullptr && same_plan(p, Fs::planned())
        ? (*threads = Fs::threads, kernel = dft_cluster_kernel<Sample, Fs>)
        : kernel),
   ...);
  if (kernel != nullptr) return kernel;
  *threads = threads_of(p);
  return dft_cluster_kernel<Sample, Generic>;
}

// The launch of a plan: its kernel (kernel_of), the kernel's shared memory
// raised to plan.bytes, one cluster of plan.ranks CTAs (config, with its
// attribute in attr), and in *clusters how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters; 0 is an error).
int configure(const Plan& plan, cudaStream_t s, Kernel* kernel, cudaLaunchAttribute* attr,
              cudaLaunchConfig_t* config, int* clusters) {
  const int bytes = plan.bytes;
  int device = 0, optin = 0, threads = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
  *kernel = kernel_of(plan, &threads, Compiled{});
  cudaError_t err =
      cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(plan.ranks, 1, 1);
  config->blockDim = dim3(threads, 1, 1);
  config->dynamicSmemBytes = bytes;
  config->stream = s;
  config->attrs = attr;
  config->numAttrs = 1;
  *clusters = 0;
  err = cudaOccupancyMaxActiveClusters(clusters, *kernel, config);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *clusters < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

// The plan's checks: a plan of this n_fft (or, chirp_mode, of a convolution
// length M for it) whose largest odd radix is within this build's, and the
// build's sample type; nonzero where not.
int check(const int* packed, int dtype, bool chirp_mode, int n_fft, int hop, int n_frames,
          Plan* p) {
  const int max_n = chirp_mode ? CHIRP_MAX_N : MAX_N;
  if (n_fft < 2 || n_fft > max_n || hop < 1 || hop > n_fft || n_fft % hop != 0 ||
      n_frames < 1 || packed == nullptr || dtype != ORCAI_DTYPE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (make_plan(packed, n_fft, chirp_mode, p)) return static_cast<int>(cudaErrorInvalidValue);
  int odd = 1;  // the largest odd radix the plan needs: within this build's
  const Side* sides[2] = {&p->col, &p->row};
  for (const Side* side : sides)
    for (int i = 0; i < side->n_passes; ++i)
      if (side->radix[i] % 2 && side->radix[i] > odd) odd = side->radix[i];
  return odd > ORCAI_ODD ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); plan: host int32 [C, N1, N2,
// len1, len2, P1, radices, P2, radices] (ops/dft.py::_cluster_plan_array);
// tables: ops/dft.py::cluster_tables of N1 * N2 (float32 roots, then the
// twiddles' float64 tables); out: (n_frames, n_fft/2 + 1) float32; hop
// divides n_fft. With chirp null (the FFT mode) N1 * N2 is n_fft, up to
// 81920, and window is the (n_fft,) float32 window. Otherwise (the chirp
// mode, n_fft up to 40960) N1 * N2 is an M >= 2 n_fft - 1 up to 81920,
// chirp is ops/dft.py::chirp_tables' (2 n_fft + M, 2) float32 and window is
// not read. C is 2 to 8 CTAs; the plan's largest odd radix may not pass
// this build's ORCAI_ODD, and dtype must be its ORCAI_DTYPE.
// Launches on `stream` and returns the first CUDA error; a plan that cannot
// launch (no cluster of C CTAs fits on the card) is an error.
extern "C" int orcai_dft_cluster(const void* audio, int dtype, const float* window,
                                 const float* tables, const float* chirp, const int* packed,
                                 float* out, int n_frames, int n_fft, int hop, void* stream) {
  if (out == nullptr || tables == nullptr || (chirp == nullptr && window == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = check(packed, dtype, chirp != nullptr, n_fft, hop, n_frames, &p);
  if (err != 0) return err;
  Kernel kernel;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  int clusters = 0;
  err = configure(p, static_cast<cudaStream_t>(stream), &kernel, &attr, &config, &clusters);
  if (err != 0) return err;
  const int n_pairs = (n_frames + 1) / 2;
  config.gridDim = dim3((n_pairs < clusters ? n_pairs : clusters) * p.ranks, 1, 1);
  const cudaError_t launch = cudaLaunchKernelEx(
      &config, kernel, static_cast<const Sample*>(audio), window,
      reinterpret_cast<const float2*>(tables), reinterpret_cast<const float2*>(chirp), out,
      n_frames, hop, p);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

// What a launch of the plan (the FFT mode at n_fft, or with chirp nonzero
// the chirp mode) takes on the current device, in info[8]: CTAs a cluster,
// threads a CTA, CTAs resident on an SM, clusters resident on the card (the
// size of its persistent grid in clusters), dynamic shared memory a CTA,
// registers and local (spilled) bytes a thread, and 1 where the plan runs a
// kernel compiled whole (Compiled), else 0. Returns the CUDA error a launch
// would meet (a plan whose cluster does not fit is one).
extern "C" int orcai_dft_cluster_layout(int dtype, const int* packed, int n_fft, int hop,
                                        int chirp, int* info) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = check(packed, dtype, chirp != 0, n_fft, hop, 1, &p);
  if (err != 0) return err;
  Kernel kernel;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  int clusters = 0, ctas = 0, threads = 0;
  err = configure(p, nullptr, &kernel, &attr, &config, &clusters);
  if (err != 0) return err;
  const bool compiled = kernel != dft_cluster_kernel<Sample, Generic>;
  threads = static_cast<int>(config.blockDim.x);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, p.bytes);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int values[8] = {p.ranks, threads, ctas, clusters, p.bytes, fa.numRegs,
                         static_cast<int>(fa.localSizeBytes), compiled ? 1 : 0};
  for (int i = 0; i < 8; ++i) info[i] = values[i];
  return 0;
}
