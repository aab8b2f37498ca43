// Masked conditional digit histograms of float32 bit patterns, for exact
// radix selection: for targets t = 0, 1, count the elements e < n_valid
// whose bits satisfy (bits >> prefix_shift) == prefix[t] (with no prefix,
// prefix_shift < 0, only t = 0 counts, unconditionally), binned by
// (bits >> digit_shift) & (2^digit_bits - 1). Output (2, 2^digit_bits)
// int32, which the caller zeroes.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_hist.py::digit_histograms
// (kernel _hist_kernel). The TPU has no vector scatter, so that kernel
// builds one-hot bf16 matrices and counts with MXU matmuls over inputs
// padded to 262144 elements; both are TPU artifacts and are gone here.
//
// Bound on the card: bytes. One sweep reads n * 4 bytes once (154 MB for
// a 20-minute recording's 38.5 M magnitudes, 46 us at 3.35 TB/s) and does
// a handful of integer operations per element.
//
// Design: a grid-stride loop (about four 512-thread blocks per SM) over
// the flat input, coalesced 128-byte warp reads, and a block-private
// shared-memory histogram of 2 x 2048 int32 (16 KB). Magnitudes crowd into
// few top-level digits, so same-bin updates are first merged inside the
// warp (__match_any_sync, one shared atomic per distinct bin) before
// touching shared memory. At the end each block adds its nonzero bins to
// the global output with atomics. Integer counts make the result
// bit-exact whatever order the blocks run in. n_valid and the prefixes
// are read from device memory, so the three sweeps of a selection chain
// on the stream with no host round trip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_BINS = 2048;

// one shared atomic per distinct key among the lanes where pred holds
__device__ __forceinline__ void warp_count(int* hist, unsigned key, bool pred) {
  const unsigned want = __ballot_sync(0xffffffffu, pred);
  if (pred) {
    const unsigned peers = __match_any_sync(want, key);
    if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&hist[key], __popc(peers));
  }
}

__global__ void __launch_bounds__(THREADS)
digit_hist_kernel(const uint32_t* __restrict__ bits, long long n,
                  const int* __restrict__ n_valid,
                  const uint32_t* __restrict__ prefixes, int digit_shift,
                  int digit_bits, int prefix_shift, int* __restrict__ out) {
  __shared__ int hist[2 * MAX_BINS];
  const int n_bins = 1 << digit_bits;
  const unsigned mask = static_cast<unsigned>(n_bins - 1);
  for (int i = threadIdx.x; i < 2 * n_bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  long long nv = static_cast<long long>(*n_valid);
  nv = nv < n ? nv : n;
  const uint32_t p0 = prefixes[0];
  const uint32_t p1 = prefixes[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the trip count depends only on the block, so whole warps stay
  // converged for the warp-wide votes below
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < nv; base += stride) {
    const long long e = base + threadIdx.x;
    const bool in = e < nv;
    const uint32_t b = in ? bits[e] : 0u;
    const unsigned digit = (b >> digit_shift) & mask;
    if (prefix_shift < 0) {
      warp_count(hist, digit, in);
    } else {
      const uint32_t p = b >> prefix_shift;
      warp_count(hist, digit, in && p == p0);
      warp_count(hist + n_bins, digit, in && p == p1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n_bins; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(&out[i], v);
  }
}

}  // namespace

// flat: n float32 values (read as their bit patterns); n_valid: one int32
// on the device; prefixes: two uint32 on the device; out: (2, 2^digit_bits)
// int32, zeroed. Launches `grid` blocks on `stream`; returns
// cudaGetLastError().
extern "C" int orcai_digit_histograms(const void* flat, long long n,
                                      const int* n_valid, const void* prefixes,
                                      int digit_shift, int digit_bits,
                                      int prefix_shift, int* out, int grid,
                                      void* stream) {
  if (digit_bits < 1 || digit_bits > 11) return static_cast<int>(cudaErrorInvalidValue);
  digit_hist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(flat), n, n_valid,
      static_cast<const uint32_t*>(prefixes), digit_shift, digit_bits,
      prefix_shift, out);
  return static_cast<int>(cudaGetLastError());
}
