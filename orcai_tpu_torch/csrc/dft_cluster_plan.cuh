// The plan of csrc/dft_cluster.cu: where each column and row of a frame
// pair's four-step FFT N = N1 * N2 lies on the CTAs of a cluster, how the
// kernel lays out a CTA's shared memory and how many threads a CTA runs.
// Plain C++ (the functions the kernel calls are __host__ __device__, and
// those that build a plan constexpr, so that a plan compiled whole is built
// at compile time), so that the host builds it too: the kernel's host code
// checks a launch with it, and tests/test_torch_kernels_plain.py compiles
// it with g++ to check that the ranks' columns and rows cover each column
// and row exactly once and that its shared memory is ops/dft.py::
// cluster_bytes. Included inside the kernel's anonymous namespace.

#pragma once

#include "dft_side.cuh"

constexpr int MAX_N = 81920;        // the largest FFT: n_fft, or M in the chirp mode
constexpr int MAX_SIDE = 8192;      // N1 and N2
constexpr int CHIRP_MAX_N = 40960;  // the chirp mode's largest n_fft (M <= 81920)
constexpr int MAX_RANKS = 8;        // CTAs a cluster: the portable most
// A CTA's threads: PAIR_THREADS where two CTAs of a plan fit on an SM (its
// shared memory within PAIR_CTA_BYTES, half an SM's 228 KB less the 1 KB
// each CTA keeps), so that two frame pairs are in flight on every SM; else
// SOLO_THREADS, one CTA an SM (threads_of).
constexpr int PAIR_THREADS = 256;
constexpr int SOLO_THREADS = 512;
constexpr int PAIR_CTA_BYTES = 233472 / 2 - 1024;

// Where a row or a column lies, as the launch's lookup tables hold it: the
// rank << HOME_SHIFT | the local row or column there, in 32 bits.
constexpr int HOME_SHIFT = 16;
constexpr unsigned HOME_MASK = (1u << HOME_SHIFT) - 1;
static_assert(MAX_SIDE <= static_cast<int>(HOME_MASK) + 1, "a local index must fit in HOME_MASK");
static_assert(MAX_RANKS <= (1 << (32 - HOME_SHIFT)), "a rank must fit above HOME_SHIFT");

// Rank r holds the columns j in [col_lo[r], col_lo[r+1]) and the rows of
// the row pairs {k1, n1 - k1} with k1 in [pair_lo[r], pair_lo[r+1]): its
// local rows are a0.. a0 + alen - 1, then b0 .. b0 + blen - 1 (the mirrors),
// so a bin's mirror bin Z[N - k] lies on the rank of Z[k].
struct Plan {
  int n, n1, n2, ranks;        // N = n1 * n2 points on a cluster of `ranks` CTAs
  int chirp_n;                 // the chirp mode's n_fft; 0 in the FFT mode
  int cstride, rstride, zbuf;  // the column and row layouts' strides; one buffer
  int tw_len;                  // both sides' pass roots (float2), in shared memory
  int tw_log2;                 // the four-step twiddles' split S = 1 << tw_log2 (twiddle_split)
  int table_bytes;             // the roots and the twiddles' two tables, as the host lays them out
  int tab_off, peer_off, z_off, bytes;  // shared memory, from its start
  int col_lo[MAX_RANKS + 1];
  int pair_lo[MAX_RANKS + 1];
  int a0[MAX_RANKS], alen[MAX_RANKS], b0[MAX_RANKS], blen[MAX_RANKS];
  Side col, row;               // col: N1-point FFTs of the columns; row: N2-point
};

constexpr int PLAN_BYTES = (static_cast<int>(sizeof(Plan)) + 15) & ~15;

// The four-step twiddles W_N^m, m = j k1 < N, as products of two tables
// of float64 roots, lo[m % S] and hi[m / S] (S + ceil(N / S) values): S =
// 2^s for the least s with 4^s >= N (ops/dft.py::twiddle_split, the same
// rule).
__host__ __device__ constexpr int twiddle_split(int n) {
  int s = 0;
  while ((1LL << (2 * s)) < n) ++s;
  return s;
}

// the rank whose range [lo[r], lo[r+1]) holds i
__host__ __device__ __forceinline__ int owner(const int* lo, int ranks, int i) {
  int r = 0;
  while (r + 1 < ranks && i >= lo[r + 1]) ++r;
  return r;
}

// where row k1 lies: its row pair's rank, and its local row there
__host__ __device__ __forceinline__ unsigned home_of_row(const Plan& p, int k1) {
  const int pair = k1 <= p.n1 / 2 ? k1 : p.n1 - k1;
  const int r = owner(p.pair_lo, p.ranks, pair);
  const int l = k1 - p.a0[r] < p.alen[r] ? k1 - p.a0[r] : p.alen[r] + k1 - p.b0[r];
  return static_cast<unsigned>(r) << HOME_SHIFT | static_cast<unsigned>(l);
}

// the row k1 of rank me's local row l
__host__ __device__ __forceinline__ int row_of_local(const Plan& p, int me, int l) {
  return l < p.alen[me] ? p.a0[me] + l : p.b0[me] + l - p.alen[me];
}

// where column j lies: its rank, and its local column there
__host__ __device__ __forceinline__ unsigned home_of_col(const Plan& p, int j) {
  const int r = owner(p.col_lo, p.ranks, j);
  return static_cast<unsigned>(r) << HOME_SHIFT | static_cast<unsigned>(j - p.col_lo[r]);
}

// radices[0..P) -> the side's passes; nonzero when they are not of n or
// their roots are not `len` rows (a one-pass plan has one unread row)
__host__ __device__ constexpr int make_side(const int* radices, int P, int n, int tw_off, int len,
                                           Side* side) {
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
__host__ __device__ constexpr int make_plan(const int* packed, int n_fft, bool chirp,
                                           Plan* plan) {
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
  plan->tw_log2 = twiddle_split(plan->n);
  const int split = 1 << plan->tw_log2;
  plan->table_bytes = ((plan->tw_len + 1) & ~1) * 8 + (split + (plan->n + split - 1) / split) * 16;
  plan->tab_off = PLAN_BYTES + plan->table_bytes;
  plan->peer_off = plan->tab_off + ((n1 + n2) * 4 + n1 * 2 + 15) / 16 * 16;
  plan->z_off = plan->peer_off + MAX_RANKS * 8;
  plan->bytes = plan->z_off + 2 * plan->zbuf * 8;
  return 0;
}

// A CTA's threads for the plan: PAIR_THREADS where two of its CTAs fit on
// an SM, else SOLO_THREADS.
__host__ __device__ constexpr int threads_of(const Plan& p) {
  return p.bytes <= PAIR_CTA_BYTES ? PAIR_THREADS : SOLO_THREADS;
}
