// Hann-windowed rDFT magnitude of hop-framed audio, straight from the
// padded samples: out[t, b] = |sum_n x[t*hop + n] * (C[n, b] + i S[n, b])|.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel), which sums n_fft/hop partial MXU GEMMs over shifted
// hop-blocks so the (T, n_fft) frames matrix never reaches HBM.
//
// Bound on the card: operations. One 32768-frame tile is 4*T*512*257 =
// 17.2 GFLOP of IEEE fp32 FMA (TF32 cannot hold the 2e-4 bar; the
// reference runs at Precision.HIGHEST) against ~69 MB of traffic, i.e.
// ~250 FLOP per byte, far above the fp32 ridge.
//
// Design: a tiled fp32 GEMM without the frames matrix. Each 256-thread
// block owns a 64-frame x 64-bin output tile and walks n in 32-sample
// steps. It stages frame samples As[k][f] = x[(f0+f)*hop + k0+k] directly
// from the padded audio (int16 is scaled by 1/32768 on load), and the
// matching C/S rows, in shared memory; each thread keeps a 4x4 micro-tile
// of re and im in registers (32 FMAs per three 16-byte shared loads) and
// writes sqrt(re^2 + im^2). The ragged bin edge (257 = 4*64 + 1) and any
// partial frame tile are masked, never padded into C/S. The staging map
// puts 8 consecutive samples of 4 frames in each warp, so global reads
// use whole 32-byte sectors and the transposing shared store (row stride
// 68 floats) is free of bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // frames per block
constexpr int BN = 64;        // bins per block
constexpr int BK = 32;        // samples per step
constexpr int A_LD = BM + 4;  // padded row of As: 16-byte aligned, no conflicts
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float sample_to_f32(float v) { return v; }
__device__ __forceinline__ float sample_to_f32(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dft_magnitude_kernel(const T* __restrict__ audio, const float* __restrict__ C,
                     const float* __restrict__ S, float* __restrict__ out,
                     int n_frames, int n_fft, int hop, int n_bins) {
  __shared__ __align__(16) float As[BK][A_LD];
  __shared__ __align__(16) float Cs[BK][BN];
  __shared__ __align__(16) float Ss[BK][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;  // bin group: bins tx*4 .. tx*4+3
  const int ty = tid >> 4;  // frame group: frames ty*4 .. ty*4+3
  const int b0 = blockIdx.x * BN;
  const int f0 = blockIdx.y * BM;

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    // frames: each warp covers 8 consecutive samples x 4 frames
#pragma unroll
    for (int it = 0; it < (BK * BM) / THREADS; ++it) {
      const int w = it * (THREADS / 32) + (tid >> 5);  // 0 .. 63
      const int kk = (lane & 7) + 8 * (w & 3);
      const int f = (lane >> 3) + 4 * (w >> 2);
      const int frame = f0 + f;
      const int k = k0 + kk;
      float v = 0.0f;
      if (frame < n_frames && k < n_fft)
        v = sample_to_f32(audio[static_cast<long long>(frame) * hop + k]);
      As[kk][f] = v;
    }
    // DFT rows k0 .. k0+BK of C and S, bins b0 .. b0+BN (masked edge)
#pragma unroll
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int i = it * THREADS + tid;
      const int b = i % BN;
      const int kk = i / BN;
      const int bin = b0 + b;
      const int k = k0 + kk;
      const bool ok = bin < n_bins && k < n_fft;
      const long long off = static_cast<long long>(k) * n_bins + bin;
      Cs[kk][b] = ok ? C[off] : 0.0f;
      Ss[kk][b] = ok ? S[off] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Cs[kk][tx * 4]);
      const float4 s = *reinterpret_cast<const float4*>(&Ss[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(av[i], cv[j], re[i][j]);
          im[i][j] = fmaf(av[i], sv[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int frame = f0 + ty * 4 + i;
    if (frame >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = b0 + tx * 4 + j;
      if (bin < n_bins)
        out[static_cast<long long>(frame) * n_bins + bin] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples, float32 or int16 (by
// audio_is_int16); C, S: (n_fft, n_bins) float32; out: (n_frames, n_bins)
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int orcai_dft_magnitude(const void* audio, int audio_is_int16,
                                   const float* C, const float* S, float* out,
                                   int n_frames, int n_fft, int hop,
                                   int n_bins, void* stream) {
  const dim3 grid((n_bins + BN - 1) / BN, (n_frames + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (audio_is_int16)
    dft_magnitude_kernel<int16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int16_t*>(audio), C, S, out, n_frames, n_fft, hop,
        n_bins);
  else
    dft_magnitude_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(audio), C, S, out, n_frames, n_fft, hop,
        n_bins);
  return static_cast<int>(cudaGetLastError());
}
