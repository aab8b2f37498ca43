// Windowed rDFT magnitude of one-point frames, n_fft 1 (hop 1): frame t is
// the sample x[t] alone, its one bin |w[0] s(x[t])|, where s is the sample
// as float32 (int16 scaled by 1/32768, uint8 mu-law codes decoded where they
// are loaded, float32 as it is).
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel) at n_fft 1, which dft_gemm.cu's tiled GEMM took before:
// a 64-frame x 64-bin tile computing one bin and one product a frame left
// almost every thread idle (0.91 ms on a minute of int16 audio on the H100,
// where torch.stft(...).abs() takes 0.09, PERF.md).
//
// Bound on the card: bytes. Each sample is read once and each magnitude
// written once, (sizeof(T) + 4) bytes a frame: a minute of int16 audio at
// 48 kHz, 2,880,000 frames, is 17.3 MB, 0.0052 ms at 3.35 TB/s; a launch
// takes a few microseconds more. So the kernel is one grid-stride pass in
// which each thread takes four samples with one load (4, 8 or 16 bytes)
// and writes their four magnitudes with one 16-byte store, UNROLL such
// loads of a thread in flight: a warp's stores are 512 adjacent bytes. (A
// 16-byte load of 8 int16 or 16 uint8 samples a thread, stored as 2 or 4
// float4 each, left every store instruction of a warp strided: 0.0109 and
// 0.0116 ms against float32's 0.0064 on the H100, PERF.md.) Audio whose
// address is not aligned to its four samples (a code view one byte off)
// takes the same pass a sample at a time, and so do the last samples past
// a multiple of four.
//
// The plain version (ops/dft.py::dft_magnitude_plain) computes re = s
// C[0, 0], im = s S[0, 0] = +-0 and sqrtf(re^2 + im^2) = sqrtf(fl(re^2));
// this kernel computes re = s w[0] (C[0, 0] is w[0] rounded to float32)
// and sqrtf(fl(re^2)) with IEEE multiplies and square root, so it gives
// the plain version's bits (|re| itself would differ where re^2
// underflows). No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

#include "dft_butterflies.cuh"

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // eight CTAs on each SM of an H100, then the grid strides
constexpr int UNROLL = 4;            // a thread's loads in flight

template <int BYTES>
struct Four;  // four samples of BYTES bytes each, as one load
template <>
struct Four<1> {
  using type = unsigned int;
};
template <>
struct Four<2> {
  using type = uint2;
};
template <>
struct Four<4> {
  using type = uint4;
};

__device__ __forceinline__ float magnitude(float s, float w) {
  const float re = __fmul_rn(s, w);
  return __fsqrt_rn(__fmul_rn(re, re));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
point_kernel(const T* __restrict__ audio, float w, float* __restrict__ out, long long n,
             bool aligned) {
  using In = typename Four<sizeof(T)>::type;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long fours = aligned ? n / 4 : 0;
  for (long long g0 = first; g0 < fours; g0 += UNROLL * stride) {
    union {
      In v;
      T s[4];
    } in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g0 + u * stride < fours) in[u].v = reinterpret_cast<const In*>(audio)[g0 + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g0 + u * stride < fours)
        reinterpret_cast<float4*>(out)[g0 + u * stride] =
            make_float4(magnitude(sample_to_f32(in[u].s[0]), w),
                        magnitude(sample_to_f32(in[u].s[1]), w),
                        magnitude(sample_to_f32(in[u].s[2]), w),
                        magnitude(sample_to_f32(in[u].s[3]), w));
  }
  for (long long t = fours * 4 + first; t < n; t += stride)
    out[t] = magnitude(sample_to_f32(audio[t]), w);
}

template <typename T>
int run(const void* audio_v, float w, float* out, long long n, cudaStream_t s) {
  const T* audio = static_cast<const T*>(audio_v);
  const bool aligned = reinterpret_cast<uintptr_t>(audio) % (4 * sizeof(T)) == 0;
  const long long items = aligned ? (n / 4 + UNROLL - 1) / UNROLL + 4 : n;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  point_kernel<T><<<blocks, THREADS, 0, s>>>(audio, w, out, n, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio: n_frames samples of float32 (dtype 0), int16 (dtype 1) or uint8
// mu-law codes (dtype 2), any alignment; w: the window's one value as
// float32; out: (n_frames,) float32, 16-byte aligned. Launches one kernel on
// `stream` and returns its CUDA error.
extern "C" int orcai_dft_point(const void* audio, int dtype, float w, float* out,
                               long long n_frames, void* stream) {
  if (audio == nullptr || out == nullptr || n_frames < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(audio, w, out, n_frames, s);
    case 1: return run<int16_t>(audio, w, out, n_frames, s);
    case 2: return run<uint8_t>(audio, w, out, n_frames, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
