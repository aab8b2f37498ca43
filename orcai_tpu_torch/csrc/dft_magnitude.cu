// Windowed rDFT magnitude of hop-framed audio, straight from the padded
// samples: out[t, k] = |sum_n w[n] x[t*hop + n] exp(-2 pi i n k / 512)|,
// k = 0..256, as a batched 512-point FFT in shared memory.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel), which sums n_fft/hop partial MXU GEMMs over shifted
// hop-blocks so the (T, n_fft) frames matrix never reaches HBM.
//
// Bound on the card: bytes. The function must read each sample once and
// write each magnitude once: for a 32768-frame tile at hop 256 that is
// 33.6 MB of float32 (16.8 MB of int16) in and 33.7 MB out, 0.020 ms
// (0.015 ms) at 3.35 TB/s. The FFT's arithmetic, about 23 kFLOP for two
// frames, is a few microseconds a tile.
//
// Why not the GEMM form. The TPU multiplies by a (512, 257) DFT matrix
// because it has a matrix unit and no FFT: 526 kFLOP a frame. That form
// must stay IEEE fp32 here (the reference runs Precision.HIGHEST and TF32
// cannot hold the 2e-4 bar), so the tensor cores are closed to it and a
// CUDA-core SGEMM needs 17.2 GFLOP a tile, 0.26 ms at peak. The operation
// count belongs to that algorithm, not to the function.
//
// Design. Frames are taken in groups of 16. A persistent grid (three
// 256-thread blocks per SM) walks the groups; for each, the block copies
// the one contiguous span of 15*hop + 512 samples the group covers into
// shared memory with 16-byte cp.async copies (int16 stays int16), so
// overlapping frames are served from shared memory and each sample leaves
// HBM once (plus one hop of overlap per group). Two span buffers alternate:
// the next group's copy is in flight while this group is transformed.
// Each warp transforms two frames at a time: z = w*x_t + i*w*x_t+1, one
// complex FFT as three radix-8 Stockham passes. A lane owns butterflies
// j = lane and lane + 32, 16 complex values in registers; the passes
// exchange through a per-warp buffer of complex values (8-byte accesses)
// whose index is padded per exchange (a + a/16 after pass 1, a + 8*(a/64)
// after pass 2) so that both the strided writes and the unit-stride reads
// are free of bank conflicts. The last pass leaves Z in natural order; the
// untangle X_t[k] = (Z[k] + conj Z[N-k])/2, X_t+1[k] = (Z[k] - conj Z[N-k])/2i
// reads Z[k] and Z[(N-k) mod N], which covers k = 0 and k = N/2, and writes
// sqrt(re^2 + im^2) as 128-byte warp stores along each output row. The
// window and the roots of unity come from the host, computed in float64
// and rounded once to float32. The lane's 16 window values stay in
// registers; the roots are copied into shared memory in the order the
// passes read them ([r][j % 8] for pass 2, [r][j] for pass 3), so a warp
// reads consecutive words or one broadcast word, never a strided table.
// Frames past n_frames are neither computed nor written; a phantom second
// frame of an odd count reads zeros.
//
// What holds it: instruction throughput, not HBM. Per frame pair a lane does
// six 8-point DFTs, 28 complex twiddle products, 18 IEEE square roots and
// about 150 shared-memory accesses; float32 and int16 input take nearly
// the same time although int16 halves the bytes read.
//
// uint8 input is mu-law codes (the mulaw8 wire), staged as bytes and
// decoded where a sample is read. The 16-byte copies need a 16-byte aligned
// source and a hop that is a multiple of 16 samples; a tile view that
// starts at any other byte (a slice of the streaming path's resident
// buffer) takes the one-sample-a-thread copy instead, as float32 and int16
// views do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 512;            // FFT size
constexpr int NBINS = N / 2 + 1;  // 257
constexpr int FRAMES = 16;        // frames per group
constexpr int WARPS = 8;
constexpr int BLOCKS_PER_SM = 3;
constexpr int THREADS = WARPS * 32;
constexpr int ZBUF = 576;  // per-warp exchange buffer, complex values (padded 512)
constexpr int TW_BYTES = 7 * (8 + 64) * 8;  // the two twiddle tables
constexpr int Z_BYTES = WARPS * ZBUF * 8;

__device__ __forceinline__ float sample_to_f32(float v) { return v; }
__device__ __forceinline__ float sample_to_f32(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);
}
// a mu-law code (ops/wire_codec.py): sign = bit 7, e = bits 6:4, mant =
// bits 3:0, m14 = ((2 mant + 33) << e) - 33, the sample +-(m14 << 2) as an
// int16 value, scaled as int16 is; so the codes and their host decode to
// int16 give the same float samples
__device__ __forceinline__ float sample_to_f32(uint8_t c) {
  const int e = (c >> 4) & 7, mant = c & 15;
  const int x16 = (((2 * mant + 33) << e) - 33) << 2;
  return static_cast<float>((c & 0x80) ? -x16 : x16) * (1.0f / 32768.0f);
}

__device__ __forceinline__ int pad_a(int a) { return a + (a >> 4); }
__device__ __forceinline__ int pad_b(int a) { return a + ((a >> 6) << 3); }

// 4-point DFT, natural order, in place
__device__ __forceinline__ void fft4(float& r0, float& i0, float& r1, float& i1,
                                     float& r2, float& i2, float& r3, float& i3) {
  const float s02r = r0 + r2, s02i = i0 + i2, d02r = r0 - r2, d02i = i0 - i2;
  const float s13r = r1 + r3, s13i = i1 + i3, d13r = r1 - r3, d13i = i1 - i3;
  r0 = s02r + s13r; i0 = s02i + s13i;
  r1 = d02r + d13i; i1 = d02i - d13r;
  r2 = s02r - s13r; i2 = s02i - s13i;
  r3 = d02r - d13i; i3 = d02i + d13r;
}

// 8-point DFT. On return X[2*k1] is in slot k1 and X[2*k1 + 1] in slot
// 4 + k1, i.e. output X[q] sits in slot (q >> 1) + 4 * (q & 1).
__device__ __forceinline__ void fft8(float (&re)[8], float (&im)[8]) {
  constexpr float C = 0.70710678118654752440f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float ar = re[n] + re[n + 4], ai = im[n] + im[n + 4];
    const float br = re[n] - re[n + 4], bi = im[n] - im[n + 4];
    re[n] = ar; im[n] = ai; re[n + 4] = br; im[n + 4] = bi;
  }
  {  // slot 4 + n times W8^n
    const float r5 = C * (re[5] + im[5]), i5 = C * (im[5] - re[5]);
    const float r6 = im[6], i6 = -re[6];
    const float r7 = C * (im[7] - re[7]), i7 = -C * (re[7] + im[7]);
    re[5] = r5; im[5] = i5; re[6] = r6; im[6] = i6; re[7] = r7; im[7] = i7;
  }
  fft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
  fft4(re[4], im[4], re[5], im[5], re[6], im[6], re[7], im[7]);
}

__device__ __forceinline__ int slot_of(int q) { return (q >> 1) + 4 * (q & 1); }

// multiply slots 1..7 by the twiddles at tr/ti[(r - 1) * stride], then the
// 8-point DFT
__device__ __forceinline__ void twiddle_fft8(float (&re)[8], float (&im)[8],
                                             const float* tr, const float* ti,
                                             int stride) {
#pragma unroll
  for (int r = 1; r < 8; ++r) {
    const float wx = tr[(r - 1) * stride], wy = ti[(r - 1) * stride];
    const float vr = re[r] * wx - im[r] * wy;
    const float vi = re[r] * wy + im[r] * wx;
    re[r] = vr; im[r] = vi;
  }
  fft8(re, im);
}

// 16-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void async_copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// commit what was started; then wait until at most PENDING groups are open
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Start the copy of frame group g's samples into `dst` (zero past the end
// of the audio) and commit it as one asynchronous group.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ audio,
                                      long long n_samples, T* dst, int span_len,
                                      int g, int hop, int vec_ok, int tid) {
  const long long s0 = static_cast<long long>(g) * FRAMES * hop;
  const long long left = n_samples - s0;
  const int avail = left < span_len ? static_cast<int>(left) : span_len;
  constexpr int PER = 16 / sizeof(T);  // samples per 16-byte copy
  int done = 0;
  if (vec_ok) {
    done = (avail / PER) * PER;
    for (int i = tid * PER; i < done; i += THREADS * PER)
      async_copy16(dst + i, audio + s0 + i);
  }
  for (int i = done + tid; i < avail; i += THREADS) dst[i] = audio[s0 + i];
  for (int i = avail + tid; i < span_len; i += THREADS) dst[i] = T(0);
  async_commit();
}

// Transform frames t and t + 1, whose samples start at xa and xb, and write
// their magnitude rows. One warp; z is its exchange buffer.
template <typename T>
__device__ __forceinline__ void transform_pair(
    const T* xa, const T* xb, const float (&win)[16], float2* z,
    const float* t2r, const float* t2i, const float* t3r, const float* t3i,
    float* __restrict__ out, int t, int n_frames, int lane) {
  float re[2][8], im[2][8];

  // pass 1 (Ns = 1): z[j + 64 r] from the samples, no twiddles;
  // butterfly j writes z'[8 j + q]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float w = win[h + 2 * r];
      re[h][r] = w * sample_to_f32(xa[j + 64 * r]);
      im[h][r] = w * sample_to_f32(xb[j + 64 * r]);
    }
    fft8(re[h], im[h]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      z[pad_a(8 * j + q)] = make_float2(re[h][slot_of(q)], im[h][slot_of(q)]);
    }
  }
  __syncwarp();

  // pass 2 (Ns = 8): twiddle tw[r * (j % 8) * 8]; butterfly j writes
  // z'[(j / 8) * 64 + j % 8 + 8 q]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 v = z[pad_a(j + 64 * r)];
      re[h][r] = v.x;
      im[h][r] = v.y;
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    twiddle_fft8(re[h], im[h], t2r + (j & 7), t2i + (j & 7), 8);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      z[pad_b((j >> 3) * 64 + (j & 7) + 8 * q)] =
          make_float2(re[h][slot_of(q)], im[h][slot_of(q)]);
    }
  }
  __syncwarp();

  // pass 3 (Ns = 64): twiddle tw[r * j]; butterfly j writes Z[j + 64 q]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 v = z[pad_b(j + 64 * r)];
      re[h][r] = v.x;
      im[h][r] = v.y;
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    twiddle_fft8(re[h], im[h], t3r + j, t3i + j, 64);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      z[j + 64 * q] = make_float2(re[h][slot_of(q)], im[h][slot_of(q)]);
    }
  }
  __syncwarp();

  // untangle the two real frames and write their magnitudes
  float* row_a = out + static_cast<long long>(t) * NBINS;
  const bool has_b = t + 1 < n_frames;
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const int k = lane + 32 * m;
    if (k < NBINS) {
      const int mk = (N - k) & (N - 1);
      const float2 za = z[k], zy = z[mk];
      const float ar = za.x, ai = za.y, yr = zy.x, yi = zy.y;
      const float pr = ar + yr, pi = ai - yi;  // 2 X_t[k]
      const float qr = ai + yi, qi = ar - yr;  // 2 |X_t+1[k]| parts
      row_a[k] = 0.5f * sqrtf(pr * pr + pi * pi);
      if (has_b) row_a[NBINS + k] = 0.5f * sqrtf(qr * qr + qi * qi);
    }
  }
  __syncwarp();  // the buffer is free for the next pair
}

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
dft_fft_kernel(const T* __restrict__ audio, long long n_samples,
               const float* __restrict__ window,
               const float2* __restrict__ twiddle, float* __restrict__ out,
               int n_frames, int hop, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  // twiddles laid out as the passes read them: pass 2 wants tw[r * (j % 8) * 8]
  // at [r - 1][j % 8], pass 3 wants tw[r * j] at [r - 1][j], so that a
  // warp's reads are consecutive words or broadcasts
  float* t2r = reinterpret_cast<float*>(smem);
  float* t2i = t2r + 7 * 8;
  float* t3r = t2i + 7 * 8;
  float* t3i = t3r + 7 * 64;
  float2* zbase = reinterpret_cast<float2*>(smem + TW_BYTES);
  T* span = reinterpret_cast<T*>(smem + TW_BYTES + Z_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float2* z = zbase + warp * ZBUF;

  const int span_len = (FRAMES - 1) * hop + N;
  for (int i = tid; i < 7 * 8; i += THREADS) {
    const float2 w = twiddle[(i / 8 + 1) * (i % 8) * 8];
    t2r[i] = w.x; t2i[i] = w.y;
  }
  for (int i = tid; i < 7 * 64; i += THREADS) {
    const float2 w = twiddle[(i / 64 + 1) * (i % 64)];
    t3r[i] = w.x; t3i[i] = w.y;
  }
  float win[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) win[m] = window[lane + 32 * m];

  const int n_groups = (n_frames + FRAMES - 1) / FRAMES;
  int cur = 0;
  if (static_cast<int>(blockIdx.x) < n_groups)
    stage(audio, n_samples, span, span_len, blockIdx.x, hop, vec_ok, tid);
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int next = g + gridDim.x;
    if (next < n_groups) {
      stage(audio, n_samples, span + (cur ^ 1) * span_len, span_len, next, hop,
            vec_ok, tid);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();  // group g's samples (and the tables) are in place
    for (int pair = warp; pair < FRAMES / 2; pair += WARPS) {
      const int t = g * FRAMES + 2 * pair;
      if (t >= n_frames) break;  // the same for the whole warp
      const T* xa = span + cur * span_len + 2 * pair * hop;
      transform_pair(xa, xa + hop, win, z, t2r, t2i, t3r, t3i, out, t, n_frames, lane);
    }
    __syncthreads();  // every warp is done with this span buffer
    cur ^= 1;
  }
}

template <typename T>
int launch(const void* audio, long long n_samples, const float* window,
           const float* twiddle, float* out, int n_frames, int hop,
           cudaStream_t s) {
  const int span_len = (FRAMES - 1) * hop + N;
  const int smem = TW_BYTES + Z_BYTES + 2 * span_len * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      dft_fft_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = 16 / static_cast<int>(sizeof(T));
  const int vec_ok =
      reinterpret_cast<uintptr_t>(audio) % 16 == 0 && hop % per == 0;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_groups = (n_frames + FRAMES - 1) / FRAMES;
  const int grid = n_groups < BLOCKS_PER_SM * n_sm ? n_groups : BLOCKS_PER_SM * n_sm;
  dft_fft_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(audio), n_samples, window,
      reinterpret_cast<const float2*>(twiddle), out, n_frames, hop, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); window: (n_fft,) float32;
// twiddle: (n_fft, 2) float32 (cos, -sin)(2 pi m / n_fft); out: (n_frames,
// n_fft/2 + 1) float32. n_fft must be 512 and hop must divide it. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int orcai_dft_magnitude(const void* audio, int dtype,
                                   const float* window, const float* twiddle,
                                   float* out, int n_frames, int n_fft, int hop,
                                   void* stream) {
  if (n_fft != N || hop < 1 || hop > N || N % hop != 0 || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_samples = static_cast<long long>(n_frames - 1) * hop + N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(audio, n_samples, window, twiddle, out, n_frames, hop, s);
    case 1:
      return launch<int16_t>(audio, n_samples, window, twiddle, out, n_frames, hop, s);
    case 2:
      return launch<uint8_t>(audio, n_samples, window, twiddle, out, n_frames, hop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
