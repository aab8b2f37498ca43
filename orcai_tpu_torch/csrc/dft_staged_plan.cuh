// The plan of csrc/dft_staged.cu: the four-step split N = N1 * N2 of a
// frame pair's FFT, the batches its kernels take, their threads and their
// shared memory. Plain C++ (the functions are __host__ __device__ and
// constexpr, so that a side compiled whole is checked at compile time), so
// that the host builds it too: the kernels' host code checks a launch with
// it, and tests/test_torch_dft_staged.py compiles it with g++ and checks
// every plan of the FFT mode's reach (the compiled sides the rule of
// ops/dft.py::staged_sides_compiled, one buffer where compiled, the
// twiddle tables' offsets, every CTA within the card's shared memory).
// Included inside the kernel's anonymous namespace.

#pragma once

#include "dft_side.cuh"

constexpr int MAX_SIDE = 8192;             // N1 and N2
constexpr long long MAX_N = 1LL << 21;     // the largest FFT: n_fft, or M in the chirp mode
constexpr int MAX_N_FFT = 1 << 20;         // the largest n_fft, either mode (STAGED_MAX)
constexpr int MAX_BATCH = 16;              // columns, row pairs or column pairs a CTA
constexpr int MAX_THREADS = 256;
constexpr int MAX_CTA_BYTES = 200 * 1024;  // a CTA's two buffers
constexpr int CARD_CTA_BYTES = 232448;     // the most dynamic shared memory a CTA takes on the card

struct Plan {
  int n, n1, n2;        // N = n1 * n2 points
  int g1, g2;           // columns a kernel-1 CTA, row pairs a kernel-2 CTA
  int chirp_n;          // the chirp mode's n_fft; 0 in the FFT mode
  int tw_len;           // both sides' pass roots, then (tables) the four-step twiddles
  int cstride, rstride; // the column and row batches' strides (odd)
  int col_groups, row_groups;  // kernel-1 and kernel-2 CTAs a frame pair
  int col_threads, row_threads;
  int col_bytes, row_bytes;    // their shared memory
  // the four-step twiddles W_N^m, products of two tables of float64 roots
  // (lo, S = 2^tw_log2 values, then hi) at float2 row tab_off of the tables,
  // tab_bytes of them; whether each side runs a kernel compiled whole
  int tw_log2, tab_off, tab_bytes;
  int col_fixed, row_fixed;
  // the chirp mode's kernel 2 keeps the tables in shared memory after its
  // buffers where they fit on the card (row_tab_bytes, else 0: it reads
  // them through L1)
  int row_tab_bytes;
  // the chirp mode's kernel 3: G3 column pairs a CTA, the representatives d
  // = e .. top of the columns f + d (mod n2), each with its partner f + e - d;
  // whether it runs a kernel compiled whole (on the column side's radices)
  int g3, fold_f, fold_e, fold_top;
  int fstride, fold_groups, fold_threads, fold_bytes, fold_fixed;
  Side col, row;        // col: N1-point FFTs of the columns; row: N2-point of the rows
};

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

__host__ __device__ constexpr int largest_radix(const Side& side) {
  int r = 1;
  for (int p = 0; p < side.n_passes; ++p) r = side.radix[p] > r ? side.radix[p] : r;
  return r;
}

// threads for `batch` FFTs of n points whose largest radix is `largest`:
// as many butterflies as its pass of the largest radix has, in warps, from
// 64 to MAX_THREADS
__host__ __device__ constexpr int threads_for(int n, int largest, int batch) {
  const int t = (batch * n / largest + 31) / 32 * 32;
  return t < 64 ? 64 : t > MAX_THREADS ? MAX_THREADS : t;
}

// The rule of the sides compiled whole (csrc/dft_staged.cu's Columns, Rows
// and Folds): a side whose radices are all powers of two, in two passes or
// more (a side of one pass keeps no buffer between passes, and compiled
// whole it read slower than the generic kernel: PERF.md); in the chirp
// mode the column side alone (its kernels 1 and 3), its kernel 2 running
// two FFTs of its rows on the generic kernel
__host__ __device__ constexpr bool powers_of_two(const Side& side) {
  for (int p = 0; p < side.n_passes; ++p)
    if (side.radix[p] & (side.radix[p] - 1)) return false;
  return side.n_passes >= 2;
}

// ... and one more row side, which the card singled out: 98304's rows of
// 384 = 16 x 8 x 3, 4 row pairs a CTA, whose generic kernel took two
// thirds of that size's call (tools/probe_staged.py, PERF.md). No other
// size of the FFT mode's reach has this side: it serves 98304 alone
__host__ __device__ constexpr bool extra_row(const Side& side, int g2) {
  return g2 == 4 && side.n_passes == 3 && side.radix[0] == 16 && side.radix[1] == 8 &&
         side.radix[2] == 3;
}

// s of the split S = 2^s of the FFT mode's twiddles at n points: the
// least s with 4^s >= n (ops/dft.py::twiddle_split, the same rule)
__host__ __device__ constexpr int twiddle_split(int n) {
  int s = 0;
  while ((1LL << (2 * s)) < n) ++s;
  return s;
}

// Whether each side of a plan runs a kernel compiled whole, and its
// kernels' shared memory: a CTA's buffers of `batch` FFTs at an odd stride,
// two, or one where its side is compiled whole (the passes run in place),
// and there, in kernel 1, the twiddle tables before them; in the chirp
// mode kernel 2's tables after its buffers where they fit (row_tab_bytes)
// and kernel 3's buffers (fold_fixed: one)
__host__ __device__ constexpr void set_fixed(Plan* plan, bool col_fixed, bool row_fixed,
                                             bool fold_fixed = false) {
  plan->col_fixed = col_fixed;
  plan->row_fixed = row_fixed;
  plan->fold_fixed = fold_fixed;
  plan->col_bytes = (col_fixed ? plan->tab_bytes : 0) +
                    (col_fixed ? 1 : 2) * plan->n1 * plan->cstride * 8;
  const int rows = (row_fixed ? 1 : 2) * plan->n2 * plan->rstride * 8;
  plan->row_tab_bytes =
      plan->chirp_n != 0 && rows + plan->tab_bytes <= CARD_CTA_BYTES ? plan->tab_bytes : 0;
  plan->row_bytes = rows + plan->row_tab_bytes;
  plan->fold_bytes = (fold_fixed ? 1 : 2) * plan->n1 * plan->fstride * 8;
}

// [N1, N2, G1, G2, len1, len2, P1, radices of N1, P2, radices of N2] and,
// in the chirp mode, [G3, f] -> Plan of an FFT of N1 * N2 points: n_fft
// itself, or in the chirp mode an M from 2 n_fft - 1 to MAX_N whose kernel 3
// takes G3 column pairs a CTA about the centre f, e = (n_fft - 2 f) mod N2
// being 0 or 1. Nonzero when it is not such a plan. The sides whose
// radices are all powers of two (in the chirp mode the column side, for its
// kernels 1 and 3), and extra_row's, are taken as compiled whole
// (set_fixed), which the kernels' host code undoes for a side its tables
// lack (a split or batch of the tools').
__host__ __device__ constexpr int make_plan(const int* packed, int n_fft, bool chirp, Plan* plan) {
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
  plan->col_threads = threads_for(n1, largest_radix(plan->col), g1);
  plan->row_threads = threads_for(n2, largest_radix(plan->row), 2 * g2);
  const int split = 1 << twiddle_split(plan->n);
  plan->tw_log2 = twiddle_split(plan->n);
  plan->tab_off = (plan->tw_len + 1) & ~1;
  plan->tab_bytes = (split + (plan->n + split - 1) / split) * 16;
  if (2 * n1 * plan->cstride * 8 > MAX_CTA_BYTES || 2 * n2 * plan->rstride * 8 > MAX_CTA_BYTES)
    return 1;
  plan->g3 = plan->fold_f = plan->fold_e = plan->fold_top = 0;
  plan->fstride = plan->fold_groups = plan->fold_threads = 0;
  set_fixed(plan, powers_of_two(plan->col),
            !chirp && (powers_of_two(plan->row) || extra_row(plan->row, g2)));
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
  plan->fold_threads = threads_for(n1, largest_radix(plan->col), 2 * g3);
  set_fixed(plan, plan->col_fixed, false, plan->col_fixed);
  return 2 * n1 * plan->fstride * 8 > MAX_CTA_BYTES;
}
