// Masked conditional digit histograms of float32 bit patterns, and the
// pick that turns a histogram into the next digit of an order statistic:
// the two kernels of exact radix selection.
//
// orcai_digit_histograms: for targets t = 0, 1, count the elements
// e < n_valid whose bits satisfy (bits >> prefix_shift) == prefix[t] (with
// no prefix, prefix_shift < 0, only t = 0 counts, unconditionally), binned
// by (bits >> digit_shift) & (2^digit_bits - 1). Output (2, 2^digit_bits)
// int32, which the caller zeroes. Replaces the TPU kernel
// orcai_tpu/ops/pallas_hist.py::digit_histograms (kernel _hist_kernel).
// The TPU has no vector scatter, so that kernel builds one-hot bf16
// matrices and counts with MXU matmuls over inputs padded to 262144
// elements; both are TPU artifacts and are gone here.
//
// Bound on the card: bytes. One sweep reads n * 4 bytes once (154 MB for a
// 20-minute recording's 38.5 M magnitudes, 0.046 ms at 3.35 TB/s) and does
// a handful of integer operations per element.
//
// Design: a streaming read. A persistent grid (a few 512-thread blocks per
// SM) walks the valid prefix in tiles; each thread starts four 16-byte
// loads before it touches the first, so 64 bytes a thread are in flight.
// The input may start at any 4-byte boundary: up to three head elements
// before the first 16-byte boundary and up to three tail elements after the
// last whole vector are counted by block 0, one thread each, straight into
// the output. Each block counts into a private shared-memory histogram and
// adds its nonzero bins to the output with integer atomics at the end, so
// the result is bit-exact whatever order the blocks run in. n_valid and
// the prefixes are read from device memory, so the sweeps of a selection
// chain on the stream with no host round trip.
//
//  - Prefixed levels: almost no element matches a prefix, so a thread
//    compares its four words with both prefixes and moves on; the few
//    matches take a plain shared atomicAdd. No warp votes.
//  - Level 0 (no prefix): every element counts and magnitudes crowd into
//    few top digits (88 of 2048 on a 20-minute recording, 15 % of the
//    values in one), so same-address shared atomics serialize. A thread
//    thins them itself: equal digits among its own four neighbouring
//    words (adjacent frequency bins) are added with one atomic. Timed on
//    the card against a __match_any_sync merge across the warp and against
//    eight replicated sub-histograms, this was the fastest on real and on
//    synthetic magnitudes; with the loads vectorized the atomics are a
//    small part of the sweep.
//
// orcai_radix_pick: one block per target. From a level's counts and the
// target's running rank k it finds b, the number of bins whose cumulative
// count is <= k, and the rank left inside bin b, k - cum[b - 1]; it writes
// the next prefix (prefix << digit_bits) | b, the new rank and, when asked,
// the prefix's bits as the float32 result. This is the plain-jnp helper
// orcai_tpu/ops/pallas_hist.py::_pick plus the shifts and ors around it in
// select_order_statistics, in one launch per level in place of about
// seven small ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_BINS = 2048;
constexpr int IN_FLIGHT = 4;  // 16-byte loads per thread per trip

template <bool PREFIXED>
__global__ void __launch_bounds__(THREADS)
digit_hist_kernel(const uint32_t* __restrict__ bits, long long n,
                  const int* __restrict__ n_valid,
                  const uint32_t* __restrict__ prefixes, int digit_shift,
                  int digit_bits, int prefix_shift, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int n_bins = 1 << digit_bits;
  const unsigned mask = static_cast<unsigned>(n_bins - 1);
  const int n_slots = (PREFIXED ? 2 : 1) * n_bins;
  for (int i = threadIdx.x; i < n_slots; i += THREADS) hist[i] = 0;
  __syncthreads();

  long long nv = static_cast<long long>(*n_valid);
  nv = nv < n ? nv : n;
  nv = nv > 0 ? nv : 0;
  uint32_t p0 = 0, p1 = 0;
  if (PREFIXED) { p0 = prefixes[0]; p1 = prefixes[1]; }

  // head: elements before the first 16-byte boundary
  long long head = ((16 - (reinterpret_cast<uintptr_t>(bits) & 15)) & 15) >> 2;
  head = head < nv ? head : nv;
  const long long n_vec = (nv - head) >> 2;
  const uint4* vec = reinterpret_cast<const uint4*>(bits + head);

  constexpr long long TILE = static_cast<long long>(THREADS) * IN_FLIGHT;
  for (long long base = blockIdx.x * TILE; base < n_vec; base += gridDim.x * TILE) {
    uint4 v[IN_FLIGHT];
    bool in[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const long long i = base + u * THREADS + threadIdx.x;
      in[u] = i < n_vec;
      v[u] = in[u] ? __ldg(vec + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (!in[u]) continue;
      if (PREFIXED) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t p = w[c] >> prefix_shift;
          any |= (p == p0) | (p == p1);
        }
        if (!any) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t p = w[c] >> prefix_shift;
          const unsigned d = (w[c] >> digit_shift) & mask;
          if (p == p0) atomicAdd(&hist[d], 1);
          if (p == p1) atomicAdd(&hist[n_bins + d], 1);
        }
      } else {  // run lengths of the four
        unsigned cur = (w[0] >> digit_shift) & mask;
        int run = 1;
#pragma unroll
        for (int c = 1; c < 4; ++c) {
          const unsigned d = (w[c] >> digit_shift) & mask;
          if (d == cur) {
            ++run;
          } else {
            atomicAdd(&hist[cur], run);
            cur = d;
            run = 1;
          }
        }
        atomicAdd(&hist[cur], run);
      }
    }
  }

  // head and tail elements, at most three each
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long tail0 = head + 4 * n_vec;
    const long long e = threadIdx.x < 4 ? threadIdx.x : tail0 + (threadIdx.x - 4);
    const bool mine = threadIdx.x < 4 ? e < head : e < nv;
    if (mine) {
      const uint32_t b = bits[e];
      const unsigned d = (b >> digit_shift) & mask;
      if (PREFIXED) {
        const uint32_t p = b >> prefix_shift;
        if (p == p0) atomicAdd(&out[d], 1);
        if (p == p1) atomicAdd(&out[n_bins + d], 1);
      } else {
        atomicAdd(&out[d], 1);
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_slots; i += THREADS) {
    const int c = hist[i];
    if (c) atomicAdd(&out[i], c);
  }
}

template <bool PREFIXED>
int launch_hist(const void* flat, long long n, const int* n_valid,
                const void* prefixes, int digit_shift, int digit_bits,
                int prefix_shift, int* out, int grid, cudaStream_t s) {
  const int smem = (PREFIXED ? 2 : 1) * (1 << digit_bits) * 4;  // <= 16 KB
  digit_hist_kernel<PREFIXED><<<grid, THREADS, smem, s>>>(
      static_cast<const uint32_t*>(flat), n, n_valid,
      static_cast<const uint32_t*>(prefixes), digit_shift, digit_bits,
      prefix_shift, out);
  return static_cast<int>(cudaGetLastError());
}

constexpr int PICK_THREADS = 1024;

__global__ void __launch_bounds__(PICK_THREADS)
radix_pick_kernel(const int* __restrict__ hists, int digit_bits, int shared_row,
                  const long long* k_lo, const long long* k_hi, int* prefixes,
                  long long* k_out, float* result) {
  __shared__ long long cum[MAX_BINS];
  __shared__ long long warp_total[PICK_THREADS / 32];
  const int t = blockIdx.x;
  const int n_bins = 1 << digit_bits;
  const int* row = hists + (shared_row ? 0 : t * n_bins);
  const long long k = t == 0 ? *k_lo : *k_hi;
  const int per = (n_bins + PICK_THREADS - 1) / PICK_THREADS;  // 1 or 2
  const int first = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  long long mine = 0;
  for (int q = 0; q < per; ++q)
    if (first + q < n_bins) mine += row[first + q];
  long long scan = mine;  // inclusive scan over the block
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += up;
  }
  if (lane == 31) warp_total[warp] = scan;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_total[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  long long running = scan - mine + (warp > 0 ? warp_total[warp - 1] : 0);
  int b = 0;  // bins whose cumulative count is <= k
  for (int q = 0; q < per; ++q) {
    const bool have = first + q < n_bins;
    if (have) {
      running += row[first + q];
      cum[first + q] = running;
    }
    b += __syncthreads_count(have && running <= k);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long prev = b > 0 ? cum[b - 1] : 0;
    const int next = static_cast<int>(
        (static_cast<unsigned>(prefixes[t]) << digit_bits) | static_cast<unsigned>(b));
    prefixes[t] = next;
    k_out[t] = k - prev;
    if (result != nullptr) result[t] = __int_as_float(next);
  }
}

}  // namespace

// flat: n float32 values (read as their bit patterns) at any 4-byte
// boundary; n_valid: one int32 on the device; prefixes: two uint32 on the
// device (not read when prefix_shift < 0); out: (2, 2^digit_bits) int32,
// zeroed. Launches `grid` blocks on `stream`; returns cudaGetLastError().
extern "C" int orcai_digit_histograms(const void* flat, long long n,
                                      const int* n_valid, const void* prefixes,
                                      int digit_shift, int digit_bits,
                                      int prefix_shift, int* out, int grid,
                                      void* stream) {
  if (digit_bits < 1 || digit_bits > 11 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prefix_shift >= 0)
    return launch_hist<true>(flat, n, n_valid, prefixes, digit_shift,
                             digit_bits, prefix_shift, out, grid, s);
  return launch_hist<false>(flat, n, n_valid, prefixes, digit_shift,
                            digit_bits, prefix_shift, out, grid, s);
}

// hists: a level's counts, (2, 2^digit_bits) int32 (both targets read row 0
// when shared_row); k_lo, k_hi: the targets' ranks, one int64 each;
// prefixes: two int32, updated in place to (prefix << digit_bits) | digit;
// k_out: two int64, the ranks inside the picked bins (may alias k_lo and
// k_hi as k_out[0] and k_out[1]); result: two float32, the new prefixes'
// bit patterns, or null. Launches two blocks on `stream`; returns
// cudaGetLastError().
extern "C" int orcai_radix_pick(const int* hists, int digit_bits,
                                int shared_row, const long long* k_lo,
                                const long long* k_hi, int* prefixes,
                                long long* k_out, float* result, void* stream) {
  if (digit_bits < 1 || digit_bits > 11)
    return static_cast<int>(cudaErrorInvalidValue);
  radix_pick_kernel<<<2, PICK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      hists, digit_bits, shared_row, k_lo, k_hi, prefixes, k_out, result);
  return static_cast<int>(cudaGetLastError());
}
