// Windowed rDFT magnitude of hop-framed audio at any n_fft from 2 to 2048
// whose prime factors are all in {2, 3, 5, 7, 11}, straight from the padded
// samples: out[t, k] = |sum_n w[n] x[t*hop + n] exp(-2 pi i n k / N)|,
// k = 0..N/2, as a batched mixed-radix FFT in shared memory.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel) at the sizes the radix-8 FFT route (dft_magnitude.cu,
// n_fft 512) does not take: the spectral wires' 384 / 192 (384 = 16*8*3)
// and 352 / 176 (8*4*11), 768 and 704 for a parameter file at n_fft 1024,
// and 256, 1024, 2048, ... The Pallas kernel multiplies each frame by the
// (N, N/2 + 1) DFT matrix because a TPU has a matrix unit and no FFT; an
// fp32 GEMM on this card's CUDA cores needs 9.7 GFLOP for a 32768-frame
// tile at 384 (dft_gemm.cu, which keeps the n_fft this kernel does not).
//
// Bound on the card: bytes. The function reads each sample once and writes
// each magnitude once: at 384 / 192 a 32768-frame tile is 12.6 MB of int16
// in and 25.3 MB out, 0.0113 ms at 3.35 TB/s. Its FFT is about
// 5 N log2(N) / 2 FLOP a frame, 0.27 GFLOP a tile, 0.004 ms at 67 TFLOP/s.
//
// Design (dft_magnitude.cu's shape without its fixed radix). Frames are
// taken in groups of F. A persistent grid walks the groups; for each, the
// block copies the one contiguous span of (F - 1)*hop + N samples the group
// covers into shared memory with 16-byte cp.async copies (int16 stays int16,
// mu-law codes stay bytes), so each sample leaves device memory once (plus
// the overlap of N - hop per group). Two span buffers alternate: the next
// group's copy is in flight while this group is transformed. Each warp
// transforms two frames at a time, z = w*x_t + i*w*x_t+1, one complex FFT as
// one Stockham pass per radix of a plan the host chooses
// (ops/dft.py::fft_plan: the power-of-two part in the fewest passes of
// radix 16 at most, as even as possible, then 3, 5, 7, 11; 384 = 16*8*3,
// 352 = 8*4*11, 1024 = 16*8*8). Butterfly j of a pass of radix R, Ns the
// product of the earlier radices, reads z[j + r*N/R], multiplies by
// tw[r * (j % Ns) * N/(Ns*R)], takes an R-point DFT and writes
// z'[(j / Ns)*Ns*R + j % Ns + r*Ns]; the last pass leaves Z in natural
// order. A lane takes whole butterflies j = lane, lane + 32, ...; the last
// ones of a pass may leave lanes idle (384/16 = 24 butterflies). Radix 16
// is 4 x 4 with its W16 twiddles; the odd radices are direct R-point DFTs
// over symmetric pairs; their float32 constants are rounded once from
// float64 (ops/dft.py::_odd_roots, _C16). The passes exchange through two
// buffers of N complex values per warp; the host lays each buffer out as
// a + ((a >> s) << g), the (s, g) that leaves its writes and the next
// reads with the fewest shared-memory wavefronts (ops/dft.py::exchange_pads;
// none left at 384, 768, 1024 or 2048). The roots of unity (one table,
// tw[m] = exp(-2 pi i m/N), from the host in float64 rounded once) are
// copied into shared memory in the order the passes read them, [r - 1][j %
// Ns] per pass, so a warp reads consecutive words or broadcasts. The
// untangle X_t[k] = (Z[k] + conj Z[(N-k) % N])/2, X_t+1[k] = (Z[k] - conj
// Z[(N-k) % N])/2i, k = 0..N/2, holds for odd N too; it writes IEEE
// sqrtf magnitudes as coalesced row stores. Frames past n_frames are
// neither computed nor written; a phantom second frame of an odd count
// reads zeros. F and the warps per block are chosen on the host for each
// N, hop and sample type to keep the most warps resident within the SM's
// shared memory (two span buffers beside two exchange buffers a warp).
//
// What holds it: shared memory and the latency of its warp-synchronous
// passes, not HBM. Every pass reads and writes N complex values (two
// wavefronts a warp access) and reads (R-1)/R*N roots, so the plan takes
// the fewest passes: radix 16 made 384, 768 and 1024 about 15 % faster
// than radix 8 with one pass more (PERF.md; tools/bench_dft_plans.py).
//
// uint8 input is mu-law codes (the mulaw8 wire), staged as bytes and
// decoded where a sample is read, by the integer steps dft_magnitude.cu and
// dft_gemm.cu use, so the codes and their int16 decode give the same
// magnitudes. The 16-byte copies need a 16-byte aligned source and a hop of
// a multiple of 16 bytes; any other tile (a view of resident codes one
// byte off) takes the one-sample-a-thread copy. IEEE fp32 throughout: no
// TF32, no fast-math sqrt or sincos.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 2048;
constexpr int MAX_PASSES = 12;
constexpr int MAX_WARPS = 8;
constexpr int NO_PAD = 31;  // a >> 31 is 0 for every index

struct Plan {
  int n, n_passes, tw_len, zbuf;  // zbuf: one exchange buffer, complex values
  int radix[MAX_PASSES];
  int ns[MAX_PASSES];      // product of the earlier radices
  int tw_off[MAX_PASSES];  // the pass's roots in the shared layout
  int pad_s[MAX_PASSES];   // the buffer the pass writes: a + ((a >> s) << g)
  int pad_g[MAX_PASSES];
};

struct Layout {  // the block's dynamic shared memory; offsets in bytes
  int warps, frames, span_len, span_stride, win_off, z_off, span_off, bytes;
};

__device__ __forceinline__ float sample_to_f32(float v) { return v; }
__device__ __forceinline__ float sample_to_f32(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);
}
// a mu-law code (ops/wire_codec.py): sign = bit 7, e = bits 6:4, mant =
// bits 3:0, m14 = ((2 mant + 33) << e) - 33, the sample +-(m14 << 2) as an
// int16 value, scaled as int16 is
__device__ __forceinline__ float sample_to_f32(uint8_t c) {
  const int e = (c >> 4) & 7, mant = c & 15;
  const int x16 = (((2 * mant + 33) << e) - 33) << 2;
  return static_cast<float>((c & 0x80) ? -x16 : x16) * (1.0f / 32768.0f);
}

__device__ __forceinline__ int padded(int a, int s, int g) { return a + ((a >> s) << g); }

// cos and sin of 2 pi m / R for m = 1 .. (R - 1) / 2, float64 values rounded
// once to float32 (ops/dft.py::_odd_roots)
__device__ __forceinline__ float root_cos(int R, int m) {
  switch (R * 16 + m) {
    case 3 * 16 + 1: return -0.5f;
    case 5 * 16 + 1: return 0.309017003f;
    case 5 * 16 + 2: return -0.809017003f;
    case 7 * 16 + 1: return 0.623489797f;
    case 7 * 16 + 2: return -0.222520933f;
    case 7 * 16 + 3: return -0.900968850f;
    case 11 * 16 + 1: return 0.841253519f;
    case 11 * 16 + 2: return 0.415415019f;
    case 11 * 16 + 3: return -0.142314836f;
    case 11 * 16 + 4: return -0.654860735f;
    case 11 * 16 + 5: return -0.959492981f;
  }
  return 0.0f;
}
__device__ __forceinline__ float root_sin(int R, int m) {
  switch (R * 16 + m) {
    case 3 * 16 + 1: return 0.866025388f;
    case 5 * 16 + 1: return 0.951056540f;
    case 5 * 16 + 2: return 0.587785244f;
    case 7 * 16 + 1: return 0.781831503f;
    case 7 * 16 + 2: return 0.974927902f;
    case 7 * 16 + 3: return 0.433883727f;
    case 11 * 16 + 1: return 0.540640831f;
    case 11 * 16 + 2: return 0.909631968f;
    case 11 * 16 + 3: return 0.989821434f;
    case 11 * 16 + 4: return 0.755749583f;
    case 11 * 16 + 5: return 0.281732559f;
  }
  return 0.0f;
}

// R-point DFTs in place, outputs in natural order

__device__ __forceinline__ void dft(float (&re)[2], float (&im)[2]) {
  const float r0 = re[0] + re[1], i0 = im[0] + im[1];
  re[1] = re[0] - re[1];
  im[1] = im[0] - im[1];
  re[0] = r0;
  im[0] = i0;
}

__device__ __forceinline__ void fft4(float& r0, float& i0, float& r1, float& i1,
                                     float& r2, float& i2, float& r3, float& i3) {
  const float s02r = r0 + r2, s02i = i0 + i2, d02r = r0 - r2, d02i = i0 - i2;
  const float s13r = r1 + r3, s13i = i1 + i3, d13r = r1 - r3, d13i = i1 - i3;
  r0 = s02r + s13r; i0 = s02i + s13i;
  r1 = d02r + d13i; i1 = d02i - d13r;
  r2 = s02r - s13r; i2 = s02i - s13i;
  r3 = d02r - d13i; i3 = d02i + d13r;
}

__device__ __forceinline__ void dft(float (&re)[4], float (&im)[4]) {
  fft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
}

// radix-2 on (n, n + 4), the W8 twiddles, two 4-point DFTs (the even and
// the odd outputs), as dft_magnitude.cu's fft8 and ops/dft.py::_fft8
__device__ __forceinline__ void dft(float (&re)[8], float (&im)[8]) {
  constexpr float C = 0.70710678118654752440f;
  float ar[4], ai[4], br[4], bi[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    ar[n] = re[n] + re[n + 4]; ai[n] = im[n] + im[n + 4];
    br[n] = re[n] - re[n + 4]; bi[n] = im[n] - im[n + 4];
  }
  {  // b[n] times W8^n
    const float r1 = C * (br[1] + bi[1]), i1 = C * (bi[1] - br[1]);
    const float r2 = bi[2], i2 = -br[2];
    const float r3 = C * (bi[3] - br[3]), i3 = -C * (br[3] + bi[3]);
    br[1] = r1; bi[1] = i1; br[2] = r2; bi[2] = i2; br[3] = r3; bi[3] = i3;
  }
  fft4(ar[0], ai[0], ar[1], ai[1], ar[2], ai[2], ar[3], ai[3]);
  fft4(br[0], bi[0], br[1], bi[1], br[2], bi[2], br[3], bi[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[2 * k] = ar[k]; im[2 * k] = ai[k];
    re[2 * k + 1] = br[k]; im[2 * k + 1] = bi[k];
  }
}

// 16 points as 4 x 4: a 4-point DFT over n1 of x[4 n1 + n2] for each n2,
// times W16^(n2 k1), a 4-point DFT over n2 giving X[k1 + 4 k2]
__device__ __forceinline__ void dft(float (&re)[16], float (&im)[16]) {
  // cos and sin of 2 pi m / 16, float64 rounded once (ops/dft.py::_C16, _S16)
  const float wc[10] = {1.0f, 0.923879504f, 0.707106769f, 0.382683426f, 0.0f, -0.382683426f, -0.707106769f, -0.923879504f, -1.0f, -0.923879504f};
  const float ws[10] = {0.0f, 0.382683426f, 0.707106769f, 0.923879504f, 1.0f, 0.923879504f, 0.707106769f, 0.382683426f, 0.0f, -0.382683426f};
  float ar[4][4], ai[4][4];  // [n2][k1]
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
    for (int n1 = 0; n1 < 4; ++n1) {
      ar[n2][n1] = re[4 * n1 + n2];
      ai[n2][n1] = im[4 * n1 + n2];
    }
    fft4(ar[n2][0], ai[n2][0], ar[n2][1], ai[n2][1], ar[n2][2], ai[n2][2], ar[n2][3], ai[n2][3]);
  }
#pragma unroll
  for (int n2 = 1; n2 < 4; ++n2) {
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1) {  // times exp(-2 pi i n2 k1 / 16)
      const float c = wc[n2 * k1], s = ws[n2 * k1];
      const float vr = ar[n2][k1] * c + ai[n2][k1] * s;
      const float vi = ai[n2][k1] * c - ar[n2][k1] * s;
      ar[n2][k1] = vr;
      ai[n2][k1] = vi;
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    fft4(ar[0][k1], ai[0][k1], ar[1][k1], ai[1][k1], ar[2][k1], ai[2][k1], ar[3][k1], ai[3][k1]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      re[k1 + 4 * k2] = ar[k2][k1];
      im[k1 + 4 * k2] = ai[k2][k1];
    }
  }
}

// odd R, over symmetric pairs: X[k] = A_k - i B_k, X[R-k] = A_k + i B_k with
// A_k = x0 + sum_n cos(2 pi nk/R) (x_n + x_R-n), B_k = sum_n sin(2 pi nk/R)
// (x_n - x_R-n), n = 1 .. (R-1)/2
template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R]) {
  constexpr int H = (R - 1) / 2;
  float sr[H], si[H], dr[H], di[H];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    sr[n - 1] = re[n] + re[R - n]; si[n - 1] = im[n] + im[R - n];
    dr[n - 1] = re[n] - re[R - n]; di[n - 1] = im[n] - im[R - n];
  }
  const float x0r = re[0], x0i = im[0];
  float o0r = x0r, o0i = x0i;
#pragma unroll
  for (int n = 0; n < H; ++n) {
    o0r += sr[n];
    o0i += si[n];
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float ar = x0r, ai = x0i, br = 0.0f, bi = 0.0f;
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int m = n * k % R;
      const float c = m <= H ? root_cos(R, m) : root_cos(R, R - m);
      const float s = m <= H ? root_sin(R, m) : -root_sin(R, R - m);
      ar += c * sr[n - 1]; ai += c * si[n - 1];
      br += s * dr[n - 1]; bi += s * di[n - 1];
    }
    re[k] = ar + bi; im[k] = ai - br;
    re[R - k] = ar - bi; im[R - k] = ai + br;
  }
  re[0] = o0r;
  im[0] = o0i;
}

// the first pass (Ns = 1, no roots): butterfly j reads the windowed samples
// n = j + r*N/R of both frames and writes z'[j*R + r]
template <int R, typename T>
__device__ __forceinline__ void first_pass(const T* xa, const T* xb, const float* win,
                                           float2* dst, int ds, int dg, int N, int lane) {
  const int nb = N / R;
  for (int j = lane; j < nb; j += 32) {
    float re[R], im[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * nb;
      const float w = win[n];
      re[r] = w * sample_to_f32(xa[n]);
      im[r] = w * sample_to_f32(xb[n]);
    }
    dft(re, im);
#pragma unroll
    for (int r = 0; r < R; ++r) dst[padded(j * R + r, ds, dg)] = make_float2(re[r], im[r]);
  }
}

// a later pass: butterfly j reads z[j + r*N/R], multiplies by the roots at
// tw[(r - 1)*Ns + j % Ns], and writes z'[(j / Ns)*Ns*R + j % Ns + r*Ns]
template <int R>
__device__ __forceinline__ void pass(const float2* src, int ss, int sg, float2* dst,
                                     int ds, int dg, const float2* tw, int N, int ns,
                                     int lane) {
  const int nb = N / R;
  int jm = lane % ns, q = lane / ns;  // j % ns and j / ns, stepped with j
  const int step_m = 32 % ns, step_q = 32 / ns;
  for (int j = lane; j < nb; j += 32) {
    float re[R], im[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = src[padded(j + r * nb, ss, sg)];
      re[r] = v.x;
      im[r] = v.y;
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 w = tw[(r - 1) * ns + jm];
      const float vr = re[r] * w.x - im[r] * w.y;
      const float vi = re[r] * w.y + im[r] * w.x;
      re[r] = vr;
      im[r] = vi;
    }
    dft(re, im);
    const int base = q * ns * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[padded(base + r * ns, ds, dg)] = make_float2(re[r], im[r]);
    jm += step_m;
    q += step_q;
    if (jm >= ns) {
      jm -= ns;
      ++q;
    }
  }
}

#define ORCAI_RADIX_CASES(CALL)  \
  case 2: CALL(2); break;        \
  case 3: CALL(3); break;        \
  case 4: CALL(4); break;        \
  case 5: CALL(5); break;        \
  case 7: CALL(7); break;        \
  case 8: CALL(8); break;        \
  case 11: CALL(11); break;      \
  case 16: CALL(16); break;

// Transform frames t and t + 1, whose samples start at xa and xa + hop, and
// write their magnitude rows. One warp; za and zb are its exchange buffers.
template <typename T>
__device__ __forceinline__ void transform_pair(const T* xa, int hop, const float* win,
                                               const float2* tw, float2* za, float2* zb,
                                               const Plan& plan, float* __restrict__ out,
                                               int t, int n_frames, int lane) {
  const int N = plan.n;
  const T* xb = xa + hop;
  switch (plan.radix[0]) {
#define ORCAI_FIRST(R) first_pass<R>(xa, xb, win, za, plan.pad_s[0], plan.pad_g[0], N, lane)
    ORCAI_RADIX_CASES(ORCAI_FIRST)
#undef ORCAI_FIRST
  }
  __syncwarp();
  float2* src = za;
  float2* dst = zb;
  for (int p = 1; p < plan.n_passes; ++p) {
    const int ss = plan.pad_s[p - 1], sg = plan.pad_g[p - 1];
    const int ds = plan.pad_s[p], dg = plan.pad_g[p], ns = plan.ns[p];
    const float2* twp = tw + plan.tw_off[p];
    switch (plan.radix[p]) {
#define ORCAI_PASS(R) pass<R>(src, ss, sg, dst, ds, dg, twp, N, ns, lane)
      ORCAI_RADIX_CASES(ORCAI_PASS)
#undef ORCAI_PASS
    }
    __syncwarp();
    float2* tmp = src;
    src = dst;
    dst = tmp;
  }

  // untangle the two real frames and write their magnitudes
  const int last = plan.n_passes - 1;
  const int s = plan.pad_s[last], g = plan.pad_g[last];
  const int n_bins = N / 2 + 1;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  for (int k = lane; k < n_bins; k += 32) {
    const float2 za_k = src[padded(k, s, g)];
    const float2 zy = src[padded(k == 0 ? 0 : N - k, s, g)];
    const float pr = za_k.x + zy.x, pi = za_k.y - zy.y;  // 2 X_t[k]
    const float qr = za_k.y + zy.y, qi = za_k.x - zy.x;  // 2 |X_t+1[k]| parts
    row_a[k] = 0.5f * sqrtf(pr * pr + pi * pi);
    if (has_b) row_a[n_bins + k] = 0.5f * sqrtf(qr * qr + qi * qi);
  }
  __syncwarp();  // the buffers are free for the next pair
}

// 16-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void async_copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Start the copy of the span that starts at sample s0 into `dst` (zero past
// the end of the audio) and commit it as one asynchronous group.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ audio, long long n_samples,
                                      T* dst, int span_len, long long s0, int vec_ok,
                                      int tid, int n_threads) {
  const long long left = n_samples - s0;
  const int avail = left < span_len ? static_cast<int>(left) : span_len;
  constexpr int PER = 16 / sizeof(T);  // samples per 16-byte copy
  int done = 0;
  if (vec_ok) {
    done = (avail / PER) * PER;
    for (int i = tid * PER; i < done; i += n_threads * PER)
      async_copy16(dst + i, audio + s0 + i);
  }
  for (int i = done + tid; i < avail; i += n_threads) dst[i] = audio[s0 + i];
  for (int i = avail + tid; i < span_len; i += n_threads) dst[i] = T(0);
  async_commit();
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
dft_mixed_kernel(const T* __restrict__ audio, long long n_samples,
                 const float* __restrict__ window, const float2* __restrict__ roots,
                 float* __restrict__ out, int n_frames, int hop, int vec_ok,
                 const Plan plan, const Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan sp;  // read with the pass index, so from shared memory
  float2* tw = reinterpret_cast<float2*>(smem);
  float* win = reinterpret_cast<float*>(smem + lay.win_off);
  T* span = reinterpret_cast<T*>(smem + lay.span_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_threads = blockDim.x;
  float2* za = reinterpret_cast<float2*>(smem + lay.z_off) + 2 * warp * plan.zbuf;
  float2* zb = za + plan.zbuf;

  const int frames = lay.frames;
  const int n_groups = (n_frames + frames - 1) / frames;
  if (static_cast<int>(blockIdx.x) < n_groups)
    stage(audio, n_samples, span, lay.span_len,
          static_cast<long long>(blockIdx.x) * frames * hop, vec_ok, tid, n_threads);
  if (tid == 0) sp = plan;
  for (int n = tid; n < plan.n; n += n_threads) win[n] = window[n];
  __syncthreads();  // sp
  // the roots as the passes read them: pass p's tw[r * jm * N / (Ns * R)]
  // at [r - 1][jm], jm < Ns
  for (int p = 1; p < sp.n_passes; ++p) {
    const int R = sp.radix[p], ns = sp.ns[p], stride = sp.n / (ns * R);
    for (int i = tid; i < (R - 1) * ns; i += n_threads) {
      const int r = i / ns + 1, jm = i - (r - 1) * ns;
      tw[sp.tw_off[p] + i] = roots[r * jm * stride];
    }
  }

  int cur = 0;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int next = g + gridDim.x;
    if (next < n_groups) {
      stage(audio, n_samples, span + (cur ^ 1) * lay.span_stride, lay.span_len,
            static_cast<long long>(next) * frames * hop, vec_ok, tid, n_threads);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();  // group g's samples (and the tables) are in place
    for (int pair = warp; pair < frames / 2; pair += lay.warps) {
      const int t = g * frames + 2 * pair;
      if (t >= n_frames) break;  // the same for the whole warp
      const T* xa = span + cur * lay.span_stride + 2 * pair * hop;
      transform_pair(xa, hop, win, tw, za, zb, sp, out, t, n_frames, lane);
    }
    __syncthreads();  // every warp is done with this span buffer
    cur ^= 1;
  }
}

// [P, R_1..R_P, s_1..s_P, g_1..g_P] -> Plan; nonzero when it is not a plan
// of n_fft
int make_plan(const int* packed, int n_fft, Plan* plan) {
  const int P = packed[0];
  if (P < 1 || P > MAX_PASSES) return 1;
  plan->n = n_fft;
  plan->n_passes = P;
  int prod = 1, tw = 0, zbuf = 0;
  for (int p = 0; p < P; ++p) {
    const int R = packed[1 + p], s = packed[1 + P + p], g = packed[1 + 2 * P + p];
    if (R != 2 && R != 3 && R != 4 && R != 5 && R != 7 && R != 8 && R != 11 && R != 16)
      return 1;
    if (s < 0 || s > 16 || g < 0 || (s > 0 && g > s - 2) || (s == 0 && g != 0)) return 1;
    plan->radix[p] = R;
    plan->ns[p] = prod;
    plan->tw_off[p] = tw;
    if (p > 0) tw += (R - 1) * prod;
    prod *= R;
    plan->pad_s[p] = s ? s : NO_PAD;
    plan->pad_g[p] = g;
    const int top = (n_fft - 1) + (((n_fft - 1) >> plan->pad_s[p]) << g) + 1;
    zbuf = top > zbuf ? top : zbuf;
  }
  if (prod != n_fft) return 1;
  plan->tw_len = tw;
  plan->zbuf = (zbuf + 1) & ~1;  // even: every buffer 16-byte aligned
  return 0;
}

int round16(int bytes) { return (bytes + 15) & ~15; }

// The block's shape for this plan, hop and sample size: of 8, 4, 2 or 1
// warps and 1, 2 or 4 frame pairs a warp per group, the one that keeps the
// most warps resident on an SM (at most 16: __launch_bounds__ gives each
// thread up to 128 registers), then the most frames a group.
int choose_layout(const Plan& plan, int hop, int elem, Layout* best) {
  int device = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  const int reserved = 1024 + static_cast<int>(sizeof(Plan));  // per block
  int best_key = -1;
  for (int warps = MAX_WARPS; warps >= 1; warps /= 2) {
    for (int per_warp = 1; per_warp <= 4; per_warp *= 2) {
      Layout lay;
      lay.warps = warps;
      lay.frames = 2 * warps * per_warp;
      lay.span_len = (lay.frames - 1) * hop + plan.n;
      lay.span_stride = round16(lay.span_len * elem) / elem;
      lay.win_off = plan.tw_len * 8;
      lay.z_off = round16(lay.win_off + 4 * plan.n);
      lay.span_off = lay.z_off + warps * 2 * plan.zbuf * 8;
      lay.bytes = lay.span_off + 2 * lay.span_stride * elem;
      if (lay.bytes + static_cast<int>(sizeof(Plan)) > optin) continue;
      int blocks = per_sm / (lay.bytes + reserved);
      if (blocks > 16 / warps) blocks = 16 / warps;
      const int key = blocks * warps * 64 + (lay.frames > 32 ? 0 : lay.frames);
      if (blocks > 0 && key > best_key) {
        best_key = key;
        *best = lay;
      }
    }
  }
  return best_key < 0;
}

template <typename T>
int launch(const void* audio, const float* window, const float* roots, const Plan& plan,
           float* out, int n_frames, int hop, cudaStream_t s) {
  Layout lay;
  if (choose_layout(plan, hop, static_cast<int>(sizeof(T)), &lay))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      dft_mixed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dft_mixed_kernel<T>,
                                                      lay.warps * 32, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per = 16 / static_cast<int>(sizeof(T));
  const int vec_ok = reinterpret_cast<uintptr_t>(audio) % 16 == 0 && hop % per == 0;
  const long long n_samples = static_cast<long long>(n_frames - 1) * hop + plan.n;
  const int n_groups = (n_frames + lay.frames - 1) / lay.frames;
  const int grid = n_groups < per_sm * n_sm ? n_groups : per_sm * n_sm;
  dft_mixed_kernel<T><<<grid, lay.warps * 32, lay.bytes, s>>>(
      static_cast<const T*>(audio), n_samples, window,
      reinterpret_cast<const float2*>(roots), out, n_frames, hop, vec_ok, plan, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); window: (n_fft,) float32;
// roots: (n_fft, 2) float32 (cos, -sin)(2 pi m / n_fft); plan: host int32
// [P, R_1..R_P, s_1..s_P, g_1..g_P] (ops/dft.py::_plan_array), the radices
// multiplying to n_fft; out: (n_frames, n_fft/2 + 1) float32. n_fft from 2
// to 2048, hop dividing it. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int orcai_dft_mixed(const void* audio, int dtype, const float* window,
                               const float* roots, const int* plan, float* out,
                               int n_frames, int n_fft, int hop, void* stream) {
  if (n_fft < 2 || n_fft > MAX_N || hop < 1 || hop > n_fft || n_fft % hop != 0 ||
      n_frames < 1 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (make_plan(plan, n_fft, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(audio, window, roots, p, out, n_frames, hop, s);
    case 1:
      return launch<int16_t>(audio, window, roots, p, out, n_frames, hop, s);
    case 2:
      return launch<uint8_t>(audio, window, roots, p, out, n_frames, hop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
