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
// the result is bit-exact whatever order the blocks run in. Two threads of
// a block read the two prefixes through L2 and share them (a pick may have
// written them in the same kernel; 528 blocks of 16 warps each reading
// them would queue at one L2 slice).
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
// The pick: from a level's counts and a target's running rank k it finds
// b, the number of bins whose cumulative count is <= k, and the rank left
// inside bin b, k - cum[b - 1]; it writes the next prefix
// (prefix << digit_bits) | b and the new rank. This is the plain-jnp helper
// orcai_tpu/ops/pallas_hist.py::_pick plus the shifts and ors around it in
// select_order_statistics. Half a 512-thread block takes each target: a
// thread loads its run of bins (eight of 2048) with every load in flight,
// a shuffle scan over the warps gives each run its count below, and the
// one thread whose run holds the first bin past k writes the digit (the
// thread of the last bin where no bin passes k, as _pick gives
// b = 2^digit_bits then).
//
//  - orcai_select, a selection's levels in one kernel: each level is the
//    sweep above with the pick as its tail. Each block adds its counts to
//    the output, fences, and takes a ticket from a zeroed counter; the
//    block that takes the last one (threadFenceReduction's pattern) reads
//    the finished counts through L2 and picks both targets. Between levels
//    the grid waits at a grid-wide barrier (a cooperative launch: the grid
//    is cut to the blocks the card holds at once, four of 512 threads an
//    SM), so a selection is a zeroing and one launch, with no kernel of
//    the pick's own and no kernel boundary between its levels. Its state
//    stays in the zeroed scratch, every level's apart (SCRATCH below), so
//    the checks read each level of the run that produced the result.
//  - orcai_radix_pick, the pick alone on int64 counts: the streaming
//    path adds each tile's counts into int64 (a recording's total passes
//    2^31) and picks on the card, so its three levels chain on the stream
//    with no fetch between them.
// A rank and n_valid come either from device memory or as a value.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int BLOCKS_PER_SM = 4;  // 32 registers a thread at most, the pick tail included
constexpr int IN_FLIGHT = 4;  // 16-byte loads per thread per trip
constexpr int MAX_BINS = 2048;

// the selection's levels (digit_shift, digit_bits, prefix_shift; -1: no
// prefix), as ops/radix_select.py::_LEVELS
__constant__ int LEVELS[3][3] = {{21, 11, -1}, {10, 11, 21}, {0, 10, 10}};
// the selection's zeroed scratch, in int32 words, as ops/radix_select.py
// lays it out: each level's (2, 2048) counts; the prefixes (4, 2), slot l
// the digits found before level l; the int64 ranks (4, 2), slot l the
// ranks level l picks (slot 0 unused: level 0 takes the caller's); a
// ticket a level
constexpr int O_PREFIX = 3 * 2 * MAX_BINS;
constexpr int O_RANK = O_PREFIX + 8;
constexpr int O_TICKET = O_RANK + 16;
static_assert(O_RANK % 2 == 0, "the int64 ranks lie on 8-byte boundaries");

// where a pick reads its ranks and old prefixes and writes its results
struct Pick {
  const long long* k_lo;  // the targets' ranks, or null: k_value[t]
  const long long* k_hi;
  long long k_value[2];
  const int* prefixes_in;  // the digits found so far
  int* prefixes_out;       // (prefix << digit_bits) | digit
  long long* k_out;        // the ranks inside the picked bins; may alias k_lo, k_hi
  int shared_row;          // both targets read row 0 (the unprefixed level)
};

// One level's counts of the elements e < nv into `out`, through the
// block's shared histogram `hist` ((PREFIXED ? 2 : 1) * 2^digit_bits ints).
template <bool PREFIXED>
__device__ __forceinline__ void sweep(const uint32_t* __restrict__ bits, long long n,
                                      long long nv, const int* prefixes, int digit_shift,
                                      int digit_bits, int prefix_shift, int* hist, int* out) {
  __shared__ uint32_t prefix[2];
  const int n_bins = 1 << digit_bits;
  const unsigned mask = static_cast<unsigned>(n_bins - 1);
  const int n_slots = (PREFIXED ? 2 : 1) * n_bins;
  if (PREFIXED && threadIdx.x < 2)
    prefix[threadIdx.x] = static_cast<uint32_t>(__ldcg(prefixes + threadIdx.x));
  for (int i = threadIdx.x; i < n_slots; i += THREADS) hist[i] = 0;
  __syncthreads();

  nv = nv < n ? nv : n;
  nv = nv > 0 ? nv : 0;
  const uint32_t p0 = PREFIXED ? prefix[0] : 0u, p1 = PREFIXED ? prefix[1] : 0u;
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

// Both targets' picks by one block of THREADS threads, half a target, from
// (2, 2^digit_bits) counts of type C (int32 in a selection, int64 on the
// streaming path) read through L2 (another block's atomics may have
// written them in this kernel). The sums are of type C too: a selection's
// int32 counts add up to n_valid < 2^31.
template <typename C>
__device__ __forceinline__ void pick_targets(const C* hists, int digit_bits, Pick pk) {
  constexpr int HALF = THREADS / 2, WARPS = HALF / 32, PER = MAX_BINS / HALF;
  __shared__ C warp_sum[2 * WARPS];
  const int t = threadIdx.x / HALF, i = threadIdx.x % HALF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_bins = 1 << digit_bits;
  const C* row = hists + (pk.shared_row ? 0 : t * n_bins);
  const long long* k_ptr = t == 0 ? pk.k_lo : pk.k_hi;
  const long long k =
      k_ptr != nullptr ? __ldcg(k_ptr) : (t == 0 ? pk.k_value[0] : pk.k_value[1]);
  const int per = (n_bins + HALF - 1) / HALF;  // <= PER
  const int first = min(i * per, n_bins), last = min(first + per, n_bins);

  C c[PER];  // this thread's run of bins, every load in flight
#pragma unroll
  for (int q = 0; q < PER; ++q) c[q] = first + q < last ? __ldcg(row + first + q) : C(0);
  C mine = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) mine += c[q];
  C scan = mine;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const C up = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += up;
  }
  if (lane == 31) warp_sum[warp] = scan;
  __syncthreads();  // every rank is read before any is written
  C below = scan - mine;  // the target's count below bin `first`
  for (int w = t * WARPS; w < warp; ++w) below += warp_sum[w];

  int b = -1;
  C prev = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const C upto = below + c[q];
    if (first + q < last && below <= k && upto > k) {  // the k-th lies in bin first + q
      b = first + q;
      prev = below;
    }
    below = upto;
  }
  if (last == n_bins && first < last && below <= k) {  // no bin passes k
    b = n_bins;
    prev = below;
  }
  if (b >= 0) {
    const unsigned p = static_cast<unsigned>(__ldcg(pk.prefixes_in + t));
    pk.prefixes_out[t] = static_cast<int>((p << digit_bits) | static_cast<unsigned>(b));
    pk.k_out[t] = k - prev;
  }
}

// True in the block that finishes last; its threads then see every other
// block's writes to device memory.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();  // this thread's atomics on the counts, before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <bool PREFIXED>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
digit_hist_kernel(const uint32_t* __restrict__ bits, long long n, const int* __restrict__ n_valid,
                  const int* prefixes, int digit_shift, int digit_bits, int prefix_shift,
                  int* out) {
  extern __shared__ int hist[];
  sweep<PREFIXED>(bits, n, *n_valid, prefixes, digit_shift, digit_bits, prefix_shift, hist, out);
}

// The three levels of a selection over the zeroed scratch, in a
// cooperative launch.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
select_kernel(const uint32_t* __restrict__ bits, long long n, const int* n_valid,
              long long n_valid_value, const long long* k_lo, const long long* k_hi,
              long long k_lo_value, long long k_hi_value, int* scratch) {
  extern __shared__ int hist[];
  const long long nv = n_valid != nullptr ? static_cast<long long>(*n_valid) : n_valid_value;
  int* prefixes = scratch + O_PREFIX;
  long long* ranks = reinterpret_cast<long long*>(scratch + O_RANK);
  unsigned* tickets = reinterpret_cast<unsigned*>(scratch + O_TICKET);
  for (int level = 0; level < 3; ++level) {
    if (level > 0) cooperative_groups::this_grid().sync();
    const int shift = LEVELS[level][0], digit_bits = LEVELS[level][1];
    const int prefix_shift = LEVELS[level][2];
    int* counts = scratch + level * 2 * MAX_BINS;
    if (prefix_shift < 0)
      sweep<false>(bits, n, nv, nullptr, shift, digit_bits, prefix_shift, hist, counts);
    else
      sweep<true>(bits, n, nv, prefixes + 2 * level, shift, digit_bits, prefix_shift, hist,
                  counts);
    if (last_block(tickets + level)) {
      Pick pk;
      pk.k_lo = level == 0 ? k_lo : ranks + 2 * level;
      pk.k_hi = level == 0 ? k_hi : ranks + 2 * level + 1;
      pk.k_value[0] = k_lo_value;
      pk.k_value[1] = k_hi_value;
      pk.prefixes_in = prefixes + 2 * level;
      pk.prefixes_out = prefixes + 2 * (level + 1);
      pk.k_out = ranks + 2 * (level + 1);
      pk.shared_row = prefix_shift < 0;
      pick_targets<int>(counts, digit_bits, pk);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
radix_pick_kernel(const long long* __restrict__ hists, int digit_bits, Pick pick) {
  pick_targets<long long>(hists, digit_bits, pick);
}

// the blocks of select_kernel the card holds at once, by device
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_kernel, THREADS,
                                                  2 * MAX_BINS * 4);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// flat: n float32 values (read as their bit patterns) at any 4-byte
// boundary; n_valid: one int32 on the device; prefixes: two int32 on the
// device (not read when prefix_shift < 0); out: (2, 2^digit_bits) int32,
// zeroed. Launches `grid` blocks on `stream`; returns cudaGetLastError().
extern "C" int orcai_digit_histograms(const void* flat, long long n,
                                      const int* n_valid, const void* prefixes,
                                      int digit_shift, int digit_bits,
                                      int prefix_shift, int* out, int grid,
                                      void* stream) {
  if (digit_bits < 1 || digit_bits > 11 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* bits = static_cast<const uint32_t*>(flat);
  const int* pref = static_cast<const int*>(prefixes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prefix_shift >= 0)
    digit_hist_kernel<true><<<grid, THREADS, 2 * (1 << digit_bits) * 4, s>>>(
        bits, n, n_valid, pref, digit_shift, digit_bits, prefix_shift, out);
  else
    digit_hist_kernel<false><<<grid, THREADS, (1 << digit_bits) * 4, s>>>(
        bits, n, n_valid, pref, digit_shift, digit_bits, prefix_shift, out);
  return static_cast<int>(cudaGetLastError());
}

// A selection of the k_lo-th and k_hi-th smallest of the first n_valid of
// n float32 values: n_valid from device memory, or n_valid_value (below
// 2^31) where it is null; k_lo, k_hi one int64 each on the device, or null
// and the values. scratch: O_TICKET + 3 int32, zeroed. One cooperative
// launch of up to `grid` blocks, cut to the blocks the card holds at once.
// Returns the launch's error, or cudaGetLastError().
extern "C" int orcai_select(const void* flat, long long n, const int* n_valid,
                            long long n_valid_value, const long long* k_lo,
                            const long long* k_hi, long long k_lo_value, long long k_hi_value,
                            int* scratch, int grid, void* stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* bits = static_cast<const uint32_t*>(flat);
  const int resident = resident_blocks();
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  grid = grid < resident ? grid : resident;
  void* args[] = {&bits, &n, &n_valid, &n_valid_value, &k_lo, &k_hi, &k_lo_value,
                  &k_hi_value, &scratch};
  const int smem = 2 * MAX_BINS * 4;  // the prefixed levels' two rows
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(select_kernel), dim3(grid), dim3(THREADS), args, smem,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// hists: a level's int64 counts, (2, 2^digit_bits); both targets read row
// 0 when shared_row. k_lo, k_hi: the ranks, one int64 each on the device,
// or null and the values; prefixes_in: the two digits found so far;
// prefixes_out, k_out: two int32 and two int64 written (k_out may alias
// k_lo and k_hi). Launches one block on `stream`; returns
// cudaGetLastError().
extern "C" int orcai_radix_pick(const long long* hists, int digit_bits, int shared_row,
                                const long long* k_lo, const long long* k_hi,
                                long long k_lo_value, long long k_hi_value,
                                const int* prefixes_in, int* prefixes_out, long long* k_out,
                                void* stream) {
  if (digit_bits < 1 || digit_bits > 11) return static_cast<int>(cudaErrorInvalidValue);
  Pick pick;
  pick.k_lo = k_lo;
  pick.k_hi = k_hi;
  pick.k_value[0] = k_lo_value;
  pick.k_value[1] = k_hi_value;
  pick.prefixes_in = prefixes_in;
  pick.prefixes_out = prefixes_out;
  pick.k_out = k_out;
  pick.shared_row = shared_row;
  radix_pick_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(hists, digit_bits,
                                                                          pick);
  return static_cast<int>(cudaGetLastError());
}
