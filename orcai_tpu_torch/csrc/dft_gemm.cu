// Windowed rDFT magnitude of hop-framed audio at any n_fft that hop
// divides, as a tiled IEEE fp32 GEMM read straight from the padded samples:
// out[t, b] = |sum_n x[t*hop + n] * (C[n, b] + i S[n, b])|, with the window
// folded into C and S.
//
// The TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude's own
// algorithm (kernel _kernel), which no route of ops/dft.py reaches any
// more: dft_point.cu takes n_fft 1 (this kernel's last size: a 64-frame x
// 64-bin tile for one product a frame, 0.91 ms on a minute of int16 audio
// on the H100, where torch.stft(...).abs() takes 0.09, PERF.md), and above
// 2^20 B1 raises, since its window-folded C and S (4 N (N/2 + 1) bytes,
// 4.4 TB there) fit on no card. It stays as the yardstick that
// chip_smoke.py and the tools call directly, beside the FFT routes.
// dft_magnitude.cu takes 512; dft_mixed.cu every other smooth n_fft up to
// 8192 and, in its chirp-z mode, every other n_fft up to 4096;
// dft_cluster.cu the {2, ..., 23}-smooth n_fft up to 81920 (clusters of up
// to 8 CTAs) and, in its chirp-z mode, every other n_fft up to 40960;
// dft_staged.cu every other n_fft up to 2^20 (40962 = 2 * 3 * 6827, which
// this kernel took until then: 6.7 GB of tables, 40.5 ms for 301 frames on
// the H100 where the staged route takes 0.5). The Pallas
// kernel sums n_fft/hop partial MXU GEMMs over shifted hop-blocks, so the
// (T, n_fft) frames matrix never reaches HBM; so does this one, and it
// decodes uint8 mu-law codes where it loads them, as the Pallas kernel does.
//
// Bound on the card: operations, for this algorithm. A 301-frame tile at
// n_fft 40962 / hop 20481 is 4 * T * 40962 * 20482 = 1.01 TFLOP of fp32 FMA
// against 12 MB in and 25 MB out (0.011 ms of bytes at 3.35 TB/s), about
// 15 ms at the card's 67 TFLOP/s of fp32 outside the tensor cores; a
// 32768-frame tile would be 109 times that. TF32 cannot hold the 2e-4 bar
// (the reference runs Precision.HIGHEST), so the tensor cores are closed to
// it. An FFT needs far less; this route is the simple kernel that is right
// for any size, and no wire, parameter file or entry point reaches it.
//
// Design (the tiled kernel of the port's first B1, generalised): each
// 256-thread block owns a 64-frame x 64-bin output tile and walks n in
// 32-sample steps. It stages frame samples As[k][f] = x[(f0+f)*hop + k0+k]
// straight from the padded audio (int16 scaled by 1/32768, uint8 decoded,
// on load) and the matching C/S rows in shared memory; each thread keeps a
// 4x4 micro-tile of re and im in registers (32 FMAs per three 16-byte
// shared loads) and writes sqrt(re^2 + im^2). The ragged edges (n_fft not a
// multiple of 32, n_bins not of 64, a partial frame tile) are masked, never
// padded into C/S. The staging map puts 8 consecutive samples of 4 frames
// in each warp, so global reads take whole 32-byte sectors and the
// transposing shared store (row stride 68 floats) has no bank conflicts.
// Frame tiles run along grid.x, so any frame count fits.

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
// a mu-law code, decoded by the integer steps of ops/wire_codec.py (the
// same as dft_magnitude.cu's), then scaled as int16 is
__device__ __forceinline__ float sample_to_f32(uint8_t c) {
  const int e = (c >> 4) & 7, mant = c & 15;
  const int x16 = (((2 * mant + 33) << e) - 33) << 2;
  return static_cast<float>((c & 0x80) ? -x16 : x16) * (1.0f / 32768.0f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dft_gemm_kernel(const T* __restrict__ audio, const float* __restrict__ C,
                const float* __restrict__ S, float* __restrict__ out,
                int n_frames, int n_fft, int hop, int n_bins) {
  __shared__ __align__(16) float As[BK][A_LD];
  __shared__ __align__(16) float Cs[BK][BN];
  __shared__ __align__(16) float Ss[BK][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;  // bin group: bins tx*4 .. tx*4+3
  const int ty = tid >> 4;  // frame group: frames ty*4 .. ty*4+3
  const long long f0 = static_cast<long long>(blockIdx.x) * BM;
  const int b0 = blockIdx.y * BN;

  // The sums over n: each BK-sample step sums its products into a partial
  // (pre, pim), which is added to the running sum (re, im); the part of the
  // partial that addition rounds away starts the next step's partial, so
  // it is not lost (compensated summation: a single running fp32 sum over
  // all n_fft products drifts by about eps * sqrt(n_fft) of the magnitude,
  // past the 2e-4 bar at 16418). Without fast-math the compiler keeps the
  // order.
  float re[4][4], im[4][4], pre[4][4], pim[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = pre[i][j] = pim[i][j] = 0.0f;

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    // frames: each warp covers 8 consecutive samples x 4 frames
#pragma unroll
    for (int it = 0; it < (BK * BM) / THREADS; ++it) {
      const int w = it * (THREADS / 32) + (tid >> 5);  // 0 .. 63
      const int kk = (lane & 7) + 8 * (w & 3);
      const int f = (lane >> 3) + 4 * (w >> 2);
      const long long frame = f0 + f;
      const int k = k0 + kk;
      float v = 0.0f;
      if (frame < n_frames && k < n_fft) v = sample_to_f32(audio[frame * hop + k]);
      As[kk][f] = v;
    }
    // rows k0 .. k0+BK of C and S, bins b0 .. b0+BN (masked edges)
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
          pre[i][j] = fmaf(av[i], cv[j], pre[i][j]);
          pim[i][j] = fmaf(av[i], sv[j], pim[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float tr = re[i][j] + pre[i][j], ti = im[i][j] + pim[i][j];
        pre[i][j] -= tr - re[i][j];
        pim[i][j] -= ti - im[i][j];
        re[i][j] = tr;
        im[i][j] = ti;
      }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long frame = f0 + ty * 4 + i;
    if (frame >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = b0 + tx * 4 + j;
      const float r = re[i][j] + pre[i][j], m = im[i][j] + pim[i][j];
      if (bin < n_bins) out[frame * n_bins + bin] = sqrtf(r * r + m * m);
    }
  }
}

template <typename T>
int launch(const void* audio, const float* C, const float* S, float* out,
           int n_frames, int n_fft, int hop, int n_bins, cudaStream_t s) {
  const dim3 grid((n_frames + BM - 1) / BM, (n_bins + BN - 1) / BN);
  dft_gemm_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(audio), C, S,
                                              out, n_frames, n_fft, hop, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); C, S: (n_fft, n_fft/2 + 1)
// float32, window folded in; out: (n_frames, n_fft/2 + 1) float32. hop must
// divide n_fft. Launches on `stream` and returns cudaGetLastError().
extern "C" int orcai_dft_gemm(const void* audio, int dtype, const float* C,
                              const float* S, float* out, int n_frames,
                              int n_fft, int hop, void* stream) {
  if (n_fft < 1 || hop < 1 || hop > n_fft || n_fft % hop != 0 || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bins = n_fft / 2 + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(audio, C, S, out, n_frames, n_fft, hop, n_bins, s);
    case 1:
      return launch<int16_t>(audio, C, S, out, n_frames, n_fft, hop, n_bins, s);
    case 2:
      return launch<uint8_t>(audio, C, S, out, n_frames, n_fft, hop, n_bins, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
