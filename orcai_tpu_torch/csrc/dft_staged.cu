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
//   1. kernel 1 (columns_kernel): a CTA owns G1 adjacent columns of one
//      frame pair and reads them straight from the audio (adjacent columns
//      are adjacent samples: each n1 is one run of G1 samples), runs their
//      N1-point FFTs batched in shared memory (the Stockham passes of
//      fft_plan(N1)), multiplies by W_N^(k1 j) (ops/dft.py::four_step_roots)
//      and stores Y[k1, j] row-major into the pair's scratch, runs of G1
//      complex values;
//   2. kernel 2 (rows_kernel): a CTA owns G2 adjacent row pairs {k1, N1 -
//      k1} (k1 = 0 and N1/2 pair with themselves), copies its rows from the
//      scratch (each row one run of N2 values), runs their N2-point FFTs,
//      and untangles X_t[k] = (Z[k] + conj Z[N-k])/2, X_t+1[k] = (Z[k] -
//      conj Z[N-k])/2i: the mirror of bin k1 + N1 k2 lies in row N1 - k1,
//      on the same CTA. It writes IEEE sqrtf magnitudes as runs of G2
//      adjacent bins (the rows k1 of a CTA are adjacent, and so are their
//      mirrors), where one row pair a CTA would write every N1-th bin.
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
// 200 KB; the roots are read from device memory through L1 (the same
// across a batch: broadcasts).
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

constexpr int MAX_SIDE = 8192;             // N1 and N2
constexpr long long MAX_N = 1LL << 21;     // the largest FFT: n_fft, or M in the chirp mode
constexpr int MAX_N_FFT = 1 << 20;         // the largest n_fft, either mode (STAGED_MAX)
constexpr int MAX_BATCH = 16;              // columns, row pairs or column pairs a CTA
constexpr int MAX_THREADS = 256;
constexpr int MAX_CTA_BYTES = 200 * 1024;  // a CTA's two buffers

struct Plan {
  int n, n1, n2;        // N = n1 * n2 points
  int g1, g2;           // columns a kernel-1 CTA, row pairs a kernel-2 CTA
  int chirp_n;          // the chirp mode's n_fft; 0 in the FFT mode
  int tw_len;           // both sides' pass roots, then the four-step twiddles
  int cstride, rstride; // the column and row batches' strides (odd)
  int col_groups, row_groups;  // kernel-1 and kernel-2 CTAs a frame pair
  int col_threads, row_threads;
  int col_bytes, row_bytes;    // their shared memory
  // the chirp mode's kernel 3: G3 column pairs a CTA, the representatives d
  // = e .. top of the columns f + d (mod n2), each with its partner f + e - d
  int g3, fold_f, fold_e, fold_top;
  int fstride, fold_groups, fold_threads, fold_bytes;
  Side col, row;        // col: N1-point FFTs of the columns; row: N2-point of the rows
};

// the columns cols[b] of the scratch: element e of local column b
struct ListColumns {
  const float2* s;
  const unsigned short* cols;
  int n2;
  __device__ __forceinline__ float2 operator()(int e, int b) const { return s[e * n2 + cols[b]]; }
};

// The G1 (or fewer, at the right edge) columns c0.. of one frame pair: their
// N1-point FFTs from `load`, then element k1 of column j, times t[k1 * n2 +
// j] (the four-step twiddles), stored at s[k1 * n2 + j].
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

// Kernel 1: CTA blockIdx.x owns column group blockIdx.x % col_groups of the
// chunk's frame pair blockIdx.x / col_groups, whose scratch is scratch +
// that pair * n. MODE 0: the FFT mode's columns of the audio; 1: the chirp
// mode's first FFT.
template <typename T, int MODE>
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
  if constexpr (MODE == 0)
    columns(PairColumns<T>{xa, xa + hop, has_b, window, plan.n2, c0}, tables, t, s, p, c0, cols,
            za, zb, tid, nthreads);
  else
    columns(ChirpColumns<T>{xa, xa + hop, has_b, chirp, plan.chirp_n, plan.n2, c0}, tables, t, s,
            p, c0, cols, za, zb, tid, nthreads);
}

// Kernel 2: CTA blockIdx.x owns row group blockIdx.x % row_groups (the row
// pairs {k1, n1 - k1}, k1 in [lo, hi), as local rows lo.. hi - 1 then the
// distinct mirrors b0.. b0 + blen - 1) of the chunk's frame pair blockIdx.x /
// row_groups. The FFT mode untangles and writes the pair's magnitudes; the
// chirp mode takes the product with B and runs the second FFT's rows, then
// writes them back over its rows of the scratch times W_M^(k1 p2).
template <bool CHIRP>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rows_kernel(const float2* __restrict__ tables, const float2* __restrict__ chirp,
            float2* __restrict__ scratch, float* __restrict__ out, int pair0, int n_frames,
            const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan p;
  __shared__ unsigned short rows_k1[2 * MAX_BATCH];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n1 = plan.n1, n2 = plan.n2, H = n1 / 2;
  const int local = blockIdx.x / plan.row_groups;
  const int lo = (blockIdx.x % plan.row_groups) * plan.g2;
  const int hi = lo + plan.g2 < H + 1 ? lo + plan.g2 : H + 1;
  // mirrors n1 - k1 > H of the rows k1 in [m_lo, m_hi): rows b0 .. n1 - m_lo
  const int m_lo = lo > 1 ? lo : 1, m_hi = hi < n1 - H ? hi : n1 - H;
  const int alen = hi - lo, blen = m_hi > m_lo ? m_hi - m_lo : 0, b0 = n1 - m_hi + 1;
  const int rows = alen + blen;
  if (tid == 0) p = plan;
  if (tid < rows) rows_k1[tid] = static_cast<unsigned short>(tid < alen ? lo + tid : b0 + tid - alen);
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
  if constexpr (!CHIRP) {
    // Z[k1 + n1 k2] at k2 * rstride + l; its mirror Z[N - k] in row
    // (n1 - k1) % n1 at k2' = n2 - 1 - k2, or (n2 - k2) % n2 where k1 is 0
    const int N = plan.n, n_bins = N / 2 + 1, t = 2 * (pair0 + local);
    float* row_a = out + static_cast<long long>(t) * n_bins;
    const bool has_b = t + 1 < n_frames;
    for (Walk w(tid, nthreads, rows); w.o <= (N / 2) / n1; w.step()) {
      const int k2 = w.o, l = w.i, k1 = rows_k1[l], k = k1 + n1 * k2;
      if (k > N / 2) continue;
      const int m1 = k1 == 0 ? 0 : n1 - k1;
      const int m2 = k1 != 0 ? n2 - 1 - k2 : k2 == 0 ? 0 : n2 - k2;
      const int lm = m1 >= lo && m1 < hi ? m1 - lo : alen + m1 - b0;
      write_bin(row_a, n_bins, has_b, k, z[k2 * plan.rstride + l], z[m2 * plan.rstride + lm]);
    }
  } else {
    float2* other = z == za ? zb : za;
    const float2* g = batched_fft(Product{z, plan.rstride, chirp + 2 * plan.chirp_n, rows_k1, n1},
                                  other, z, tables, p.row, plan.rstride, rows, tid, nthreads);
    const float2* t = tables + plan.tw_len;
    for (Walk w(tid, nthreads, n2); w.o < rows; w.step()) {
      const int at = rows_k1[w.o] * n2 + w.i;
      s[at] = cmul(g[w.i * plan.rstride + w.o], t[at]);
    }
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

// radices[0..P) -> the side's passes; nonzero when they are not of n or
// their roots are not `len` rows (a one-pass plan has one unread row)
int make_side(const int* radices, int P, int n, int tw_off, int len, Side* side) {
  if (P < 1 || P > MAX_PASSES) return 1;
  long long prod = 1;
  int ns = 1, off = 0;
  for (int p = 0; p < P; ++p) {
    const int R = radices[p];
    if (R != 2 && R != 3 && R != 4 && R != 5 && R != 7 && R != 8 && R != 11 && R != 13 &&
        R != 16 && R != 17 && R != 19 && R != 23 && R != 29 && R != 31)
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

int largest_radix(const Side& side) {
  int r = 1;
  for (int p = 0; p < side.n_passes; ++p) r = side.radix[p] > r ? side.radix[p] : r;
  return r;
}

// threads for `batch` FFTs of a side: as many butterflies as its pass of
// the largest radix has, in warps, from 64 to MAX_THREADS
int threads_for(const Side& side, int batch) {
  int t = (batch * side.n / largest_radix(side) + 31) / 32 * 32;
  return t < 64 ? 64 : t > MAX_THREADS ? MAX_THREADS : t;
}

// [N1, N2, G1, G2, len1, len2, P1, radices of N1, P2, radices of N2] and,
// in the chirp mode, [G3, f] -> Plan of an FFT of N1 * N2 points: n_fft
// itself, or in the chirp mode an M from 2 n_fft - 1 to MAX_N whose kernel 3
// takes G3 column pairs a CTA about the centre f, e = (n_fft - 2 f) mod N2
// being 0 or 1. Nonzero when it is not such a plan.
int make_plan(const int* packed, int n_fft, bool chirp, Plan* plan) {
  const int n1 = packed[0], n2 = packed[1], g1 = packed[2], g2 = packed[3];
  const int len1 = packed[4], len2 = packed[5], P1 = packed[6];
  if (n1 < 2 || n2 < 2 || n1 > MAX_SIDE || n2 > MAX_SIDE || g1 < 1 || g1 > MAX_BATCH ||
      g2 < 1 || g2 > MAX_BATCH || len1 < 1 || len2 < 1 || P1 < 1 || P1 > MAX_PASSES)
    return 1;
  const long long n = static_cast<long long>(n1) * n2;
  if (n > MAX_N || (chirp ? n < 2LL * n_fft - 1 : n != n_fft)) return 1;
  if (make_side(packed + 7, P1, n1, 0, len1, &plan->col)) return 1;
  if (make_side(packed + 8 + P1, packed[7 + P1], n2, len1, len2, &plan->row)) return 1;
  plan->n = static_cast<int>(n);
  plan->n1 = n1;
  plan->n2 = n2;
  plan->g1 = g1;
  plan->g2 = g2;
  plan->chirp_n = chirp ? n_fft : 0;
  plan->tw_len = len1 + len2;
  plan->cstride = g1 | 1;
  plan->rstride = (2 * g2) | 1;
  plan->col_groups = (n2 + g1 - 1) / g1;
  plan->row_groups = (n1 / 2 + 1 + g2 - 1) / g2;
  plan->col_threads = threads_for(plan->col, g1);
  plan->row_threads = threads_for(plan->row, 2 * g2);
  plan->col_bytes = 2 * n1 * plan->cstride * 8;
  plan->row_bytes = 2 * n2 * plan->rstride * 8;
  if (plan->col_bytes > MAX_CTA_BYTES || plan->row_bytes > MAX_CTA_BYTES) return 1;
  plan->g3 = plan->fold_f = plan->fold_e = plan->fold_top = 0;
  plan->fstride = plan->fold_groups = plan->fold_threads = plan->fold_bytes = 0;
  if (!chirp) return 0;
  const int* fold = packed + 8 + P1 + packed[7 + P1];
  const int g3 = fold[0], f = fold[1], e = ((n_fft - 2 * f) % n2 + n2) % n2;
  if (g3 < 1 || g3 > MAX_BATCH || f < 0 || f >= n2 || e > 1) return 1;
  plan->g3 = g3;
  plan->fold_f = f;
  plan->fold_e = e;
  plan->fold_top = (n2 + e) / 2;
  plan->fstride = (2 * g3) | 1;
  plan->fold_groups = (plan->fold_top - e + g3) / g3;
  plan->fold_threads = threads_for(plan->col, 2 * g3);
  plan->fold_bytes = 2 * n1 * plan->fstride * 8;
  return plan->fold_bytes > MAX_CTA_BYTES;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int run(const void* audio_v, const float* window, const float* tables_f, const float* chirp_f,
        const Plan& plan, float* scratch_f, int chunk_pairs, float* out, int n_frames, int hop,
        cudaStream_t s, int* launched) {
  const T* audio = static_cast<const T*>(audio_v);
  const float2* tables = reinterpret_cast<const float2*>(tables_f);
  const float2* chirp = reinterpret_cast<const float2*>(chirp_f);
  float2* scratch = reinterpret_cast<float2*>(scratch_f);
  const bool chirp_mode = plan.chirp_n != 0;
  cudaError_t err = chirp_mode ? allow_smem(columns_kernel<T, 1>, plan.col_bytes)
                               : allow_smem(columns_kernel<T, 0>, plan.col_bytes);
  if (err == cudaSuccess)
    err = chirp_mode ? allow_smem(rows_kernel<true>, plan.row_bytes)
                     : allow_smem(rows_kernel<false>, plan.row_bytes);
  if (err == cudaSuccess && chirp_mode) err = allow_smem(columns_untangle_kernel, plan.fold_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = (n_frames + 1) / 2;
  for (int pair0 = 0; pair0 < n_pairs; pair0 += chunk_pairs) {
    const int pairs = n_pairs - pair0 < chunk_pairs ? n_pairs - pair0 : chunk_pairs;
    const dim3 cols_grid(pairs * plan.col_groups), rows_grid(pairs * plan.row_groups);
    if (!chirp_mode) {
      columns_kernel<T, 0><<<cols_grid, plan.col_threads, plan.col_bytes, s>>>(
          audio, window, tables, chirp, scratch, pair0, n_frames, hop, plan);
      rows_kernel<false><<<rows_grid, plan.row_threads, plan.row_bytes, s>>>(
          tables, chirp, scratch, out, pair0, n_frames, plan);
    } else {
      columns_kernel<T, 1><<<cols_grid, plan.col_threads, plan.col_bytes, s>>>(
          audio, window, tables, chirp, scratch, pair0, n_frames, hop, plan);
      rows_kernel<true><<<rows_grid, plan.row_threads, plan.row_bytes, s>>>(
          tables, chirp, scratch, out, pair0, n_frames, plan);
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

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); plan: host int32 [N1, N2, G1,
// G2, len1, len2, P1, radices, P2, radices] and in the chirp mode [G3, f]
// (ops/dft.py::_staged_plan_array); tables: ops/dft.py::staged_tables of N1 * N2,
// float32 (re, im); scratch: chunk_pairs * N1 * N2 complex float32 on the
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
  if (n_fft < 2 || n_fft > MAX_N_FFT || hop < 1 || hop > n_fft || n_fft % hop != 0 ||
      n_frames < 1 || plan == nullptr || tables == nullptr || scratch == nullptr ||
      out == nullptr || chunk_pairs < 1 || (chirp == nullptr && window == nullptr) ||
      launched == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (make_plan(plan, n_fft, chirp != nullptr, &p)) return static_cast<int>(cudaErrorInvalidValue);
  int odd = 1;  // the largest odd radix the plan needs: within this build's
  const Side* sides[2] = {&p.col, &p.row};
  for (const Side* side : sides)
    for (int i = 0; i < side->n_passes; ++i)
      if (side->radix[i] % 2 && side->radix[i] > odd) odd = side->radix[i];
  if (odd > ORCAI_ODD) return static_cast<int>(cudaErrorInvalidValue);
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
