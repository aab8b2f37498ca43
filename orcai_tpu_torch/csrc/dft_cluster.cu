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
// parameter files with such an nfft reach these sizes; before this kernel
// they took dft_gemm.cu's GEMM, whose work grows as N^2 a frame (16418 =
// 2 * 8209 in the chirp mode on 4 CTAs: 7.2 ms on 301 frames there).
//
// Bound on the card: bytes. The function reads each sample once and writes
// each magnitude once: at 16384 / 8192 a 32768-frame int16 tile is 0.54 GB
// in and 1.07 GB out, 0.48 ms at 3.35 TB/s (16418 / 8209 the same); at
// 32768 / 16384 twice that, at 65536 / 32768 four times. The FFT's
// operations stay below that (about 2.5 N log2 N a frame: 0.28 ms of fp32
// at 67 TFLOP/s at 16384; the chirp mode's two FFTs of M points about four
// times an FFT of N).
//
// Design. A cluster of C CTAs (C = 2 up to 20480 points, 4 up to 40960, 8
// up to 81920: the fewest whose buffers fit in 160 KB a CTA; the host
// chooses it, ops/dft.py::cluster_plan) owns one frame pair at a time, on
// SMs of one GPC that read each other's shared memory (Hopper's distributed
// shared memory, cooperative_groups::this_cluster(); 8 is the portable
// cluster size), so each CTA holds N/C of each of the pair's two exchange
// buffers: 128 KB a CTA at 16384 with C = 2, at 32768 with C = 4 and at
// 65536 with C = 8. A persistent grid of as many clusters as fit
// (cudaOccupancyMaxActiveClusters; none is an error, never a fallback)
// walks the pairs. The FFT of z = w*x_t + i*w*x_t+1 runs as the four-step
// split N = N1 * N2 (both at most 8192; 16384 = 128 x 128, 32768 = 256 x
// 128, 65536 = 256 x 256):
//   1. rank c takes the columns j in [col_lo[c], col_lo[c+1]) and runs their
//      N1-point FFTs over z[N2 n1 + j], reading the samples straight from
//      device memory (consecutive columns are consecutive samples), with the
//      Stockham passes of fft_plan(N1) batched over the columns;
//   2. cluster.sync() (every rank is done with its scratch buffer), then one
//      exchange: rank c multiplies its values by W_N^(j k1)
//      (ops/dft.py::four_step_roots, float64 rounded once) and stores each
//      into the shared memory of the rank that holds its row k1, as runs
//      of consecutive words (remote stores do not wait for a reply);
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
// order (ops/dft.py::pass_roots). Where a row or a column lives is a
// 16-bit lookup, rank << 13 | local index, which holds 8 ranks of up to
// 8192 each with no bit to spare (static_assert below). The butterflies
// are dft_mixed.cu's (dft_butterflies.cuh): radix 16 as 4 x 4, the odd
// radices up to 23 direct over symmetric pairs; the kernel is built for
// the largest odd radix its plans need (17, or 23 also for the plans of
// 19), so a plan without a 19 or a 23 runs the kernel it ran before they
// were added; each of those, for each sample type, is a build of its own
// (-DORCAI_ODD, -DORCAI_DTYPE, ops/_build.py), compiled beside the others.
//
// The chirp-z (Bluestein) mode, for an n_fft N with a prime factor above 23
// whose convolution length M (ops/dft.py::chirp_length: 8198 -> 16456 =
// 136 x 121 on 2 CTAs, 16418 -> 32851 = 247 x 133 on 4, 24578 -> 50864 =
// 272 x 187 on 8) is above dft_mixed.cu's 8192: z = (w a)[n] (x_t +
// i x_t+1)[n] zero-padded to M, its M-point FFT by the four steps above,
// then the product with B = FFT_M(b) / M and the conjugate, taken where the
// first FFT leaves each value; the second forward FFT runs rows first (the
// N2-point FFTs over k2 of each row k1 the rank already holds, W_M^(k1 p2),
// an exchange back to the columns, the N1-point FFTs over k1), so no
// exchange comes between the two FFTs; then Z[k] = a[k] conj(u[k]) and the
// untangle, whose mirror bins u[n_fft - k] lie on other ranks. One kernel,
// six cluster barriers a pair.
//
// What holds it: the latency of its synchronised passes and barriers with
// one 512-thread CTA on an SM (its buffers fill the SM's shared memory), and
// the exchange through the SM-to-SM network, which (C-1)/C of the values
// cross (7/8 on 8 CTAs); see PERF.md for its times against the bound and
// torch.stft.
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

constexpr int MAX_N = 81920;        // the largest FFT: n_fft, or M in the chirp mode
constexpr int MAX_SIDE = 8192;      // N1 and N2
constexpr int CHIRP_MAX_N = 40960;  // the chirp mode's largest n_fft (M <= 81920)
constexpr int MAX_RANKS = 8;        // the portable cluster size
constexpr int THREADS = 512;

// Rank r holds the columns j in [col_lo[r], col_lo[r+1]) and the rows of
// the row pairs {k1, n1 - k1} with k1 in [pair_lo[r], pair_lo[r+1]): its
// local rows are a0.. a0 + alen - 1, then b0 .. b0 + blen - 1 (the mirrors),
// so a bin's mirror bin Z[N - k] lies on the rank of Z[k].
struct Plan {
  int n, n1, n2, ranks;        // N = n1 * n2 points on a cluster of `ranks` CTAs
  int chirp_n;                 // the chirp mode's n_fft; 0 in the FFT mode
  int cstride, rstride, zbuf;  // the column and row layouts' strides; one buffer
  int tw_len;                  // both sides' pass roots, in shared memory
  int tab_off, z_off, bytes;   // the lookup tables and the buffers in shared memory
  int col_lo[MAX_RANKS + 1];
  int pair_lo[MAX_RANKS + 1];
  int a0[MAX_RANKS], alen[MAX_RANKS], b0[MAX_RANKS], blen[MAX_RANKS];
  Side col, row;               // col: N1-point FFTs of the columns; row: N2-point
};

constexpr int PLAN_BYTES = (static_cast<int>(sizeof(Plan)) + 15) & ~15;

// the rank whose range [lo[r], lo[r+1]) holds i
__device__ __forceinline__ int owner(const int* lo, int ranks, int i) {
  int r = 0;
  while (r + 1 < ranks && i >= lo[r + 1]) ++r;
  return r;
}

// Where a row or a column lies, as the launch's lookup tables hold it: the
// rank << HOME_SHIFT | the local row or column there (both below 8192), in
// an unsigned short: rank 7 and local 8191 fill its 16 bits exactly.
constexpr int HOME_SHIFT = 13;
constexpr int HOME_MASK = (1 << HOME_SHIFT) - 1;
static_assert(MAX_SIDE <= 1 << HOME_SHIFT, "a local row or column must fit in HOME_MASK");
static_assert(((MAX_RANKS - 1) << HOME_SHIFT | HOME_MASK) <= 0xFFFF,
              "a rank and a local index must fit in an unsigned short");

// A thread's loads are issued EXCHANGE at a time before its remote stores,
// which the compiler may not move them past: their latencies overlap.
constexpr int EXCHANGE = 4;

// Rank `me` sends its columns (`ys`, the column layout) to the ranks that
// hold their rows: element j of row k1 goes to local row l of the rank of
// k1 (home_row[k1]), at j * rstride + l in that rank's `xs` (the same
// buffer on every rank), times tt[j * n1 + k1] = W_N^(k1 j). Consecutive
// threads take consecutive rows, so each rank receives runs of
// consecutive words.
__device__ __forceinline__ void push_rows(cg::cluster_group& cluster, const float2* ys, float2* xs,
                                          const float2* __restrict__ tt,
                                          const unsigned short* home_row, const Plan& p,
                                          int c0, int cols, int tid, int nthreads) {
  Walk w(tid, nthreads, p.n1);  // (column b, row k1)
  while (w.o < cols) {
    float2 v[EXCHANGE];
    float2* at[EXCHANGE];
    int n = 0;
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i) {
      if (w.o >= cols) break;
      const int b = w.o, k1 = w.i, j = c0 + b, h = home_row[k1];
      v[i] = cmul(ys[k1 * p.cstride + b], tt[j * p.n1 + k1]);
      at[i] = cluster.map_shared_rank(xs, h >> HOME_SHIFT) + j * p.rstride + (h & HOME_MASK);
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
// to k1 * cstride + the local column in the `hs` of the rank of column p2
// (home_col[p2]), times t[k1 * n2 + p2] = W_M^(k1 p2); consecutive threads
// take consecutive p2.
__device__ __forceinline__ void push_columns(cg::cluster_group& cluster, const float2* gs,
                                             float2* hs, const float2* __restrict__ t,
                                             const unsigned short* rows_k1,
                                             const unsigned short* home_col, const Plan& p,
                                             int rows, int tid, int nthreads) {
  Walk w(tid, nthreads, p.n2);  // (local row l, column p2)
  while (w.o < rows) {
    float2 v[EXCHANGE];
    float2* at[EXCHANGE];
    int n = 0;
#pragma unroll
    for (int i = 0; i < EXCHANGE; ++i) {
      if (w.o >= rows) break;
      const int l = w.o, p2 = w.i, k1 = rows_k1[l], h = home_col[p2];
      v[i] = cmul(gs[p2 * p.rstride + l], t[k1 * p.n2 + p2]);
      at[i] = cluster.map_shared_rank(hs, h >> HOME_SHIFT) + k1 * p.cstride + (h & HOME_MASK);
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
__device__ __forceinline__ void untangle_rows(const float2* zs, const unsigned short* rows_k1,
                                              const unsigned short* home_row, const Plan& p,
                                              int rows, float* __restrict__ out, int t,
                                              int n_frames, int tid, int nthreads) {
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
// column on the rank of column p2 (`us`), Z[k] = a[k] conj(u[k]); rank `me`
// writes the bins k <= n_fft/2 of its columns, the mirror u[n_fft - k] read
// from the rank that holds it.
__device__ __forceinline__ void untangle_columns(cg::cluster_group& cluster, float2* us,
                                                 const float2* __restrict__ a,
                                                 const unsigned short* home_col, const Plan& p,
                                                 int c0, int cols, float* __restrict__ out,
                                                 int t, int n_frames, int tid, int nthreads) {
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
      const int m = k == 0 ? 0 : N - k, m1 = m / p.n2, h = home_col[m - m1 * p.n2];
      u[i] = us[p1 * p.cstride + b];
      v[i] = cluster.map_shared_rank(us, h >> HOME_SHIFT)[m1 * p.cstride + (h & HOME_MASK)];
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

// Each cluster walks the frame pairs (t, t + 1), t even; its CTAs hold the
// pair's two exchange buffers N/C values each. tables: both sides' pass
// roots (tw_len), then the four-step twiddles at [k1 * n2 + j] (n) and at
// [j * n1 + k1] (n). Shared memory: the plan, the roots, the lookup tables
// (home_row[k1], rows_k1[l] of this rank, home_col[j]), the two buffers.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dft_cluster_kernel(const T* __restrict__ audio, const float* __restrict__ window,
                   const float2* __restrict__ tables, const float2* __restrict__ chirp,
                   float* __restrict__ out, int n_frames, int hop, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Plan& p = *reinterpret_cast<Plan*>(smem);  // read with the pass index, so from shared memory
  float2* tw = reinterpret_cast<float2*>(smem + PLAN_BYTES);
  unsigned short* home_row = reinterpret_cast<unsigned short*>(smem + plan.tab_off);
  unsigned short* rows_k1 = home_row + plan.n1;
  unsigned short* home_col = rows_k1 + plan.n1;
  float2* za = reinterpret_cast<float2*>(smem + plan.z_off);
  float2* zb = za + plan.zbuf;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int me = static_cast<int>(cluster.block_rank());
  const int c0 = plan.col_lo[me], cols = plan.col_lo[me + 1] - c0;
  const int rows = plan.alen[me] + plan.blen[me];
  if (tid == 0) p = plan;
  for (int i = tid; i < plan.tw_len; i += nthreads) tw[i] = tables[i];
  for (int k1 = tid; k1 < plan.n1; k1 += nthreads) {
    const int pair = k1 <= plan.n1 / 2 ? k1 : plan.n1 - k1;
    const int r = owner(plan.pair_lo, plan.ranks, pair);
    const int l = k1 - plan.a0[r] < plan.alen[r] ? k1 - plan.a0[r]
                                                 : plan.alen[r] + k1 - plan.b0[r];
    home_row[k1] = static_cast<unsigned short>(r << HOME_SHIFT | l);
  }
  for (int l = tid; l < rows; l += nthreads)
    rows_k1[l] = static_cast<unsigned short>(
        l < plan.alen[me] ? plan.a0[me] + l : plan.b0[me] + l - plan.alen[me]);
  for (int j = tid; j < plan.n2; j += nthreads) {
    const int r = owner(plan.col_lo, plan.ranks, j);
    home_col[j] = static_cast<unsigned short>(r << HOME_SHIFT | (j - plan.col_lo[r]));
  }
  __syncthreads();
  const float2* t = tables + plan.tw_len;
  const float2* tt = t + plan.n;
  const int n_pairs = (n_frames + 1) / 2, n_clusters = gridDim.x / plan.ranks;
  for (int pair = blockIdx.x / plan.ranks; pair < n_pairs; pair += n_clusters) {
    const int t0 = 2 * pair;
    const T* xa = audio + static_cast<long long>(t0) * hop;
    const T* xb = xa + hop;
    const bool has_b = t0 + 1 < n_frames;
    if (plan.chirp_n == 0) {
      float2* y = batched_fft(PairColumns<T>{xa, xb, has_b, window, plan.n2, c0}, za, zb, tw,
                              p.col, plan.cstride, cols, tid, nthreads);
      float2* x = y == za ? zb : za;
      cluster.sync();  // every rank is done with its columns and their scratch buffer x
      push_rows(cluster, y, x, tt, home_row, p, c0, cols, tid, nthreads);
      cluster.sync();  // every rank's rows are whole
      const float2* z = batched_fft(Local{x, plan.rstride}, y, x, tw, p.row, plan.rstride, rows,
                                    tid, nthreads);
      untangle_rows(z, rows_k1, home_row, p, rows, out, t0, n_frames, tid, nthreads);
      __syncthreads();  // the buffers are free for the next pair
    } else {
      const int nf = plan.chirp_n;
      float2* y = batched_fft(ChirpColumns<T>{xa, xb, has_b, chirp, nf, plan.n2, c0}, za, zb,
                              tw, p.col, plan.cstride, cols, tid, nthreads);
      float2* x = y == za ? zb : za;
      cluster.sync();
      push_rows(cluster, y, x, tt, home_row, p, c0, cols, tid, nthreads);
      cluster.sync();
      float2* f1 = batched_fft(Local{x, plan.rstride}, y, x, tw, p.row, plan.rstride, rows, tid,
                               nthreads);
      // the second FFT, rows first, from the product where f1 leaves it
      float2* g = batched_fft(Product{f1, plan.rstride, chirp + 2 * nf, rows_k1, plan.n1},
                              f1 == za ? zb : za, f1, tw, p.row, plan.rstride, rows, tid,
                              nthreads);
      float2* h = g == za ? zb : za;
      cluster.sync();  // every rank is done with its scratch buffer h
      push_columns(cluster, g, h, t, rows_k1, home_col, p, rows, tid, nthreads);
      cluster.sync();
      float2* u = batched_fft(Local{h, plan.cstride}, g, h, tw, p.col, plan.cstride, cols, tid,
                              nthreads);
      cluster.sync();  // u is whole: the untangle reads mirror bins on other ranks
      untangle_columns(cluster, u, chirp + nf, home_col, p, c0, cols, out, t0, n_frames, tid,
                       nthreads);
      cluster.sync();  // every remote read of this pair is done: the buffers are free
    }
  }
}

// radices[0..P) -> the side's passes; nonzero when they are not of n or
// their roots are not `len` rows (a one-pass plan has one unread row)
int make_side(const int* radices, int P, int n, int tw_off, int len, Side* side) {
  if (P < 1 || P > MAX_PASSES) return 1;
  long long prod = 1;
  int ns = 1, off = 0;
  for (int p = 0; p < P; ++p) {
    const int R = radices[p];
    if (R != 2 && R != 3 && R != 4 && R != 5 && R != 7 && R != 8 && R != 11 && R != 13 &&
        R != 16 && R != 17 && R != 19 && R != 23)
      return 1;
    side->radix[p] = R;
    side->ns[p] = ns;
    side->pass_off[p] = off;
    if (p > 0) off += (R - 1) * ns;
    ns *= R;
    prod *= R;
    if (prod > MAX_SIDE) return 1;
  }
  if (prod != n || (off != len && !(off == 0 && len == 1))) return 1;
  side->n = n;
  side->n_passes = P;
  side->tw_off = tw_off;
  return 0;
}

// [C, N1, N2, len1, len2, P1, radices of N1, P2, radices of N2] -> Plan of
// an FFT of N1 * N2 points: n_fft itself, or in the chirp mode an M from
// 2 n_fft - 1 to MAX_N. Nonzero when it is not such a plan.
int make_plan(const int* packed, int n_fft, bool chirp, Plan* plan) {
  const int ranks = packed[0], n1 = packed[1], n2 = packed[2];
  const int len1 = packed[3], len2 = packed[4], P1 = packed[5];
  if (ranks < 2 || ranks > MAX_RANKS || n1 < ranks || n2 < ranks || n1 > MAX_SIDE ||
      n2 > MAX_SIDE || len1 < 1 || len2 < 1 || P1 < 1 || P1 > MAX_PASSES)
    return 1;
  const long long n = static_cast<long long>(n1) * n2;
  if (n > MAX_N || (chirp ? n < 2LL * n_fft - 1 : n != n_fft)) return 1;
  if (make_side(packed + 6, P1, n1, 0, len1, &plan->col)) return 1;
  if (make_side(packed + 7 + P1, packed[6 + P1], n2, len1, len2, &plan->row)) return 1;
  plan->n = static_cast<int>(n);
  plan->n1 = n1;
  plan->n2 = n2;
  plan->ranks = ranks;
  plan->chirp_n = chirp ? n_fft : 0;
  plan->tw_len = len1 + len2;
  for (int r = 0; r <= MAX_RANKS; ++r) plan->col_lo[r] = (r < ranks ? r : ranks) * n2 / ranks;
  // row pairs {k1, n1 - k1}, k1 = 0 .. n1/2, to the ranks by their rows' count
  const int H = n1 / 2;
  int r = 1, acc = 0;
  plan->pair_lo[0] = 0;
  for (int k = 0; k <= H; ++k) {
    while (r < ranks && acc >= r * n1 / ranks) plan->pair_lo[r++] = k;
    acc += k == 0 || (n1 % 2 == 0 && k == H) ? 1 : 2;
  }
  for (; r <= MAX_RANKS; ++r) plan->pair_lo[r] = H + 1;
  int most = 0;
  for (r = 0; r < ranks; ++r) {
    const int lo = plan->pair_lo[r], hi = plan->pair_lo[r + 1];
    if (hi <= lo) return 1;  // a rank without rows
    const int m_lo = lo > 1 ? lo : 1, m_hi = hi < n1 - H ? hi : n1 - H;  // mirrors n1 - k > H
    plan->a0[r] = lo;
    plan->alen[r] = hi - lo;
    plan->blen[r] = m_hi > m_lo ? m_hi - m_lo : 0;
    plan->b0[r] = n1 - m_hi + 1;
    const int rows = plan->alen[r] + plan->blen[r];
    most = rows > most ? rows : most;
  }
  plan->cstride = ((n2 + ranks - 1) / ranks) | 1;  // odd: strided accesses on distinct banks
  plan->rstride = most | 1;
  const int a = n1 * plan->cstride, b = n2 * plan->rstride;
  plan->zbuf = ((a > b ? a : b) + 1) & ~1;  // even: every buffer 16-byte aligned
  plan->tab_off = PLAN_BYTES + ((plan->tw_len + 1) & ~1) * 8;
  plan->z_off = plan->tab_off + ((2 * n1 + n2) * 2 + 15) / 16 * 16;
  plan->bytes = plan->z_off + 2 * plan->zbuf * 8;
  return 0;
}

// The launch of a plan: the kernel's shared memory raised to plan.bytes,
// one cluster of plan.ranks CTAs (config, with its attribute in attr), and
// in *clusters how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 is an error).
template <typename T>
int configure(const Plan& plan, cudaStream_t s, cudaLaunchAttribute* attr,
              cudaLaunchConfig_t* config, int* clusters) {
  const int bytes = plan.bytes;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(dft_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(plan.ranks, 1, 1);
  config->blockDim = dim3(THREADS, 1, 1);
  config->dynamicSmemBytes = bytes;
  config->stream = s;
  config->attrs = attr;
  config->numAttrs = 1;
  *clusters = 0;
  err = cudaOccupancyMaxActiveClusters(clusters, dft_cluster_kernel<T>, config);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *clusters < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <typename T>
int run(const void* audio, const float* window, const float* tables, const float* chirp,
        const Plan& plan, float* out, int n_frames, int hop, cudaStream_t s, int* active) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  int clusters = 0;
  const int err0 = configure<T>(plan, s, &attr, &config, &clusters);
  if (active) *active = clusters;
  if (err0 != 0 || out == nullptr) return err0;  // no output: the query alone
  const int n_pairs = (n_frames + 1) / 2;
  config.gridDim = dim3((n_pairs < clusters ? n_pairs : clusters) * plan.ranks, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(
      &config, dft_cluster_kernel<T>, static_cast<const T*>(audio), window,
      reinterpret_cast<const float2*>(tables), reinterpret_cast<const float2*>(chirp), out,
      n_frames, hop, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan's checks, then the launch where the largest odd radix of its
// sides is within this build's and the dtype is its; chirp_mode: the plan
// is of a convolution length M for n_fft. With out null, the occupancy
// query alone.
int dispatch(const void* audio, int dtype, const float* window, const float* tables,
             const float* chirp, bool chirp_mode, const int* plan, float* out, int n_frames,
             int n_fft, int hop, cudaStream_t s, int* active) {
  const int max_n = chirp_mode ? CHIRP_MAX_N : MAX_N;
  if (n_fft < 2 || n_fft > max_n || hop < 1 || hop > n_fft || n_fft % hop != 0 ||
      n_frames < 1 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (make_plan(plan, n_fft, chirp_mode, &p)) return static_cast<int>(cudaErrorInvalidValue);
  int odd = 1;  // the largest odd radix the plan needs: within this build's
  const Side* sides[2] = {&p.col, &p.row};
  for (const Side* side : sides)
    for (int i = 0; i < side->n_passes; ++i)
      if (side->radix[i] % 2 && side->radix[i] > odd) odd = side->radix[i];
  if (odd > ORCAI_ODD || dtype != ORCAI_DTYPE) return static_cast<int>(cudaErrorInvalidValue);
  using Sample = std::conditional_t<ORCAI_DTYPE == 0, float,
                                    std::conditional_t<ORCAI_DTYPE == 1, int16_t, uint8_t>>;
  return run<Sample>(audio, window, tables, chirp, p, out, n_frames, hop, s, active);
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); plan: host int32 [C, N1, N2,
// len1, len2, P1, radices, P2, radices] (ops/dft.py::_cluster_plan_array);
// tables: ops/dft.py::cluster_tables of N1 * N2, float32 (re, im); out:
// (n_frames, n_fft/2 + 1) float32; hop divides n_fft. With chirp null (the
// FFT mode) N1 * N2 is n_fft, up to 81920, and window is the (n_fft,)
// float32 window. Otherwise (the chirp mode, n_fft up to 40960) N1 * N2 is
// an M >= 2 n_fft - 1 up to 81920, chirp is ops/dft.py::chirp_tables'
// (2 n_fft + M, 2) float32 and window is not read. C is 2 to 8 CTAs; the
// plan's largest odd radix may not pass this build's ORCAI_ODD, and dtype
// must be its ORCAI_DTYPE.
// Launches on `stream` and returns the first CUDA error; a plan that cannot
// launch (no cluster of C CTAs fits on the card) is an error.
extern "C" int orcai_dft_cluster(const void* audio, int dtype, const float* window,
                                 const float* tables, const float* chirp, const int* plan,
                                 float* out, int n_frames, int n_fft, int hop, void* stream) {
  if (out == nullptr || tables == nullptr || (chirp == nullptr && window == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(audio, dtype, window, tables, chirp, chirp != nullptr, plan, out, n_frames,
                  n_fft, hop, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the plan's kernel (the FFT mode at n_fft, or with
// chirp nonzero the chirp mode) the current device holds at once, in
// *clusters: the size of its persistent grid in clusters. Returns the CUDA
// error a launch would meet (a plan whose cluster does not fit is one).
extern "C" int orcai_dft_cluster_occupancy(int dtype, const int* plan, int n_fft, int hop,
                                           int chirp, int* clusters) {
  if (clusters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(nullptr, dtype, nullptr, nullptr, nullptr, chirp != 0, plan, nullptr, 1, n_fft,
                  hop, nullptr, clusters);
}
