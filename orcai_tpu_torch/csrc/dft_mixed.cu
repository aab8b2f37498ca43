// Windowed rDFT magnitude of hop-framed audio at any n_fft from 2 to 8192
// whose prime factors are all in {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31}, and, in
// its chirp-z mode, at any other n_fft from 2 to 4096, straight from the
// padded samples: out[t, k] = |sum_n w[n] x[t*hop + n] exp(-2 pi i n k / N)|,
// k = 0..N/2, as a batched mixed-radix FFT in shared memory.
//
// Replaces the TPU kernel orcai_tpu/ops/pallas_dft.py::dft_magnitude
// (kernel _kernel) at the sizes the radix-8 FFT route (dft_magnitude.cu,
// n_fft 512) does not take: the spectral wires' 384 / 192 (384 = 16*8*3)
// and 352 / 176 (8*4*11), 768 and 704 for a parameter file at n_fft 1024,
// 416 = 8*4*13, 1088 = 8*8*17, 1216 = 8*8*19, 1472 = 8*8*23, 464 = 16*29,
// 496 = 16*31, 1856 = 8*8*29, 1984 = 8*8*31, the 4096,
// 4352 = 16*16*17 and 8192 of recordings at 96-192 kHz, and in the chirp
// mode every n_fft with a prime factor above 31 (470 = 2*5*47, 2038,
// primes) up to 4096. The
// Pallas kernel multiplies each frame by the (N, N/2 + 1) DFT matrix
// because a TPU has a matrix unit and no FFT; an IEEE fp32 GEMM on this
// card's CUDA cores needs 4 T N (N/2 + 1) FLOP, 1.1 TFLOP for a
// 32768-frame tile at 4096, where an FFT needs about 5 N log2(N) / 2 a
// frame. Larger sizes go to dft_cluster.cu (a frame pair across a cluster
// of up to 8 CTAs, up to 81920, and its chirp mode up to 40960) and to
// dft_staged.cu (up to 2^20, through device memory).
//
// Bound on the card: bytes. The function reads each sample once and writes
// each magnitude once: at 384 / 192 a 32768-frame tile is 12.6 MB of int16
// in and 25.3 MB out, 0.0113 ms at 3.35 TB/s; at 1216 / 608 39.8 MB in and
// 79.8 MB out, 0.0357 ms; at 4096 / 2048 134 MB in and 268.6 MB out, 0.120
// ms. The FFT's operations are far below that (0.27
// GFLOP a tile at 384, 0.004 ms at 67 TFLOP/s of fp32; the chirp mode's
// two FFTs of M >= 2N - 1 points about four times an FFT of N).
//
// Design (dft_magnitude.cu's shape without its fixed radix). Frames are
// taken in groups of F. A persistent grid walks the groups; for each, the
// block copies the one contiguous span of (F - 1)*hop + N samples the group
// covers into shared memory with 16-byte cp.async copies (int16 stays int16,
// mu-law codes stay bytes), so each sample leaves device memory once (plus
// the overlap of N - hop per group). Span buffers alternate where two fit:
// the next group's copy is in flight while this group is transformed. Two
// frames at a time become one complex FFT, z = w*x_t + i*w*x_t+1, as one
// Stockham pass per radix of a plan the host chooses (ops/dft.py::fft_plan:
// the power-of-two part in the fewest passes of radix 16 at most, as even
// as possible, then 3, 5, 7, 11, 13, 17, 19, 23, 29, 31; 384 = 16*8*3, 352 =
// 8*4*11, 1088 = 8*8*17, 1216 = 8*8*19, 4096 = 16*16*16). Butterfly j of
// a pass of radix R, Ns the product of the earlier radices, reads
// z[j + r*N/R], multiplies by tw[r * (j % Ns) * N/(Ns*R)], takes an
// R-point DFT and writes z'[(j / Ns)*Ns*R + j % Ns + r*Ns]; the last pass
// leaves Z in natural order. The butterflies (dft_butterflies.cuh, shared with dft_cluster.cu)
// are radix 16 as 4 x 4 with its W16 twiddles and the odd radices as
// direct R-point DFTs over symmetric pairs (29 and 31 storing each output
// pair as it is summed, dft_emit); their float32 constants are
// rounded once from float64 (ops/dft.py::_odd_roots, _C16). The passes
// exchange through two buffers of N complex values, laid out as
// a + ((a >> s) << g), the (s, g) that leaves a pass's writes and the next
// reads with the fewest shared-memory wavefronts (ops/dft.py::exchange_pads).
// The roots of unity come from the host in the order the passes read them,
// [r - 1][j % Ns] per pass (ops/dft.py::pass_roots, float64 rounded once),
// so a warp reads consecutive words or broadcasts. The untangle
// X_t[k] = (Z[k] + conj Z[(N-k) % N])/2, X_t+1[k] = (Z[k] - conj
// Z[(N-k) % N])/2i, k = 0..N/2, holds for odd N too; it writes IEEE sqrtf
// magnitudes as coalesced row stores. Frames past n_frames are neither
// computed nor written; a phantom second frame of an odd count reads zeros.
//
// Three layouts, chosen on the host for each plan, hop and sample type
// (choose_layout). The compiled layout, for the plans of COMPILED: those of
// the spectral wires' 384 and 352 (ops/spectral.py), the sizes of this
// route that a configuration of the repo runs. Each plan is compiled whole
// into a kernel of its own, in the build of its largest odd radix, so that
// every pass's radix, stride, root offset, exchange layout (derived from
// the radices at compile time: dft_pads.cuh) and round count is a
// constant: no switch on the radix, no division or shift by a pad at run
// time, and only a last part-full round tests its lanes. Each warp owns a
// frame pair and its two exchange buffers, lane l takes butterflies l,
// l + 32, ... of each pass, and a pass's rounds are unrolled. The window
// carries the samples' scale (1/32768, mu-law's 4/32768: exact), a lane's
// first-pass window values stay in registers where they are 16 or fewer,
// int16 becomes float by an add and a subtract on 1.5 * 2^23 and a mu-law
// code by its bits, all exact, in place of the quarter-rate conversion
// unit. Its radices are 16 at most, so a thread keeps 80 registers and an
// SM three blocks of 8 warps (24 warps). A plan is compiled in only for a
// size a configuration runs: each costs the build a kernel for each sample
// type. The warp layout: the same shape for every other plan, read at run
// time (the radix switched on a pass, the pads shifted by), 128 registers a
// thread and 16 warps an SM. Both are taken where they keep at least 4
// warps resident on an SM (every n_fft up to 2048 at the spectral and
// default hops, 1088, 1216). The block layout, for every larger n_fft
// and the chirp mode, in two kernels. Its plans compiled whole
// (BLOCK_COMPILED, by a rule: every power of two above the warp layout's
// reach, 4096 = 16*16*16 and 8192 = 16*8*8*8, in the FFT mode and as the
// chirp mode's M; ops/dft.py::block_compiled): a group of threads owns a
// frame pair (256 at 4096, 512 at 8192), several groups share a block
// (three at 4096, so 24 warps and three pairs in flight on an SM, where
// the parent's layout held one pair and 8 warps), each with one exchange
// buffer whose passes run in place (a thread's butterflies read, the
// group's barrier, then written) and a named barrier of its own (bar.sync
// 1 + group), so that one group's barrier waits while another's passes
// run; the block holds the pass-ordered roots once in shared memory (in
// the chirp mode B, and a where it fits); the samples are read where they
// lie, a butterfly's loads of a frame in flight together, the first pass's
// window in registers with the samples' scale. The passes are the compiled
// layout's rounds (round_load, round_sums) widened from a warp to a group,
// every radix, stride, root offset, pad and round a constant (BlockFixed;
// the pads held in the table, tests/test_torch_dft_mixed.py checks them
// against exchange_pads). Any other plan (4352 = 16*16*17, the chirp
// mode's 952 = 8*7*17 at 470, 1984 in f32) runs the generic block kernel:
// the whole block (up to 512 threads) owns one frame pair at a time, with
// __syncthreads() between the passes and two exchange buffers; the roots
// and the window stay in shared memory where they fit beside the buffers
// and are read from device memory through L1 where they do not; at 128
// registers a thread an SM holds 16 of its warps, which fewer buffers
// would not raise. A kernel is built for the
// largest odd radix its plans need (11, 13, 17, 23 also for the plans of
// 19, or 31 also for those of 29): the larger butterflies' registers would
// cost the passes of the plans that lack them a few percent, so each plan
// runs the kernel of its own largest odd radix. Each of those, for each
// sample type, is a build of its own (-DORCAI_ODD, -DORCAI_DTYPE,
// ops/_build.py: its warp, its block and its compiled kernels, the
// compiled block kernels in the radix-11 build, whose plans they are), so
// that the kernels compile side by side; the host picks the build
// (ops/dft.py::_build_variant) and a build refuses another sample type or
// a plan with a larger odd radix.
//
// The chirp-z (Bluestein) mode, for an n_fft N with a prime factor above
// 31: X[k] = a[k] sum_n (w a)[n] x[n] b[k - n] with a[n] = exp(-i pi (n^2
// mod 2N) / N) and b[m] = conj a[|m|], a circular convolution of length M,
// a {2, ..., 19}-smooth M >= 2N - 1 whose passes move the fewest values
// (ops/dft.py::chirp_length: 470 -> 952 = 8*7*17, 2038 -> 4096). On
// the block layout: z = (w a)[n] (x_t + i x_t+1)[n] zero-padded to M, its
// M-point FFT by the same passes, the product with B = FFT_M(b) / M folded
// into the first pass of a second forward FFT of the conjugate (the
// inverse as conj -> forward -> conj), then Z[k] = a[k] conj(u[k]) and the
// same untangle: Bluestein is linear, so two real frames still share one
// complex transform. The tables (w a, a, B: ops/dft.py::chirp_tables) are
// computed on the host from n^2 mod 2N in integers and the angle in
// float64, rounded once to float32. The compiled kernel does less of that
// work: N <= M/2, so its first pass of radix 16 reads and sums only the
// lower half of each butterfly's inputs (its inputs 8..15 are zeros:
// dft16_half); where the first and the last radix agree (M =
// 4096) the first FFT's last pass and the second's first take the same
// points on the same thread, so the product with B stays in registers and
// an exchange goes; the second FFT's last pass writes only the outputs
// below M/2, the ones the untangle reads; B (and a where it fits) sits in
// shared memory, w a is read through L1. The generic kernel reads its
// tables through L1.
//
// What holds it: the passes' instructions, not HBM. Taken apart at 384 /
// 192 on int16 (tools/probe_mixed.py, which builds its own copy of this
// source with the passes or the row stores left out), the warp layout read
// 0.0172 and 0.0440 of its 0.0472 ms on an H100; the compiled layout
// 0.0160 and 0.0248 of 0.0281, and at 32 warps an SM (one exchange buffer,
// the values in registers across it) no faster than at 24: issue, not
// latency. Every pass reads and writes N
// complex values (two wavefronts a warp access) and reads (R-1)/R*N roots,
// so the plan takes the fewest passes. The block layout's bytes bound it at
// 0.120 ms for a 32768-frame int16 tile at 4096 / 2048 and 0.240 at 8192 /
// 4096, but its shared memory has a floor of its own: the first pass
// writes 8 bytes a point of a pair, each later pass reads and writes 16,
// the untangle reads 16, and the roots add 8 a point a pass, so at 8192
// (four passes) about 11 GB a tile against about 30 TB/s of shared memory
// on the card, some 0.35 ms, above its byte bound. Taken apart on an H100
// (tools/probe_mixed.py, int16, 32768 frames; PERF.md), the generic block
// kernel spent 0.25 of its 0.446 ms at 4096 / 2048, 0.70 of 1.091 at 8192
// and 0.61 of 0.961 at 2038 in its passes (two blocks of one pair, or one,
// on an SM, every warp at each pass's barrier; half its instructions
// integer work on the run-time plan), the chirp mode 0.31 in its second
// FFT, and 0.05-0.20 reading its tables through L1; its row stores
// 0.02-0.06. The compiled kernels took 4096 to 0.279 ms, 8192 to 0.82 and
// 2038 to 0.458, bit-equal to the generic kernel in the chirp mode.
//
// uint8 input is mu-law codes (the mulaw8 wire), staged as bytes and
// decoded where a sample is read, by the integer steps dft_magnitude.cu and
// dft_gemm.cu use (the compiled layout by the code's bits, to the same
// float), so the codes and their int16 decode give the same
// magnitudes. The 16-byte copies need a 16-byte aligned source and a hop of
// a multiple of 16 bytes; any other tile (a view of resident codes one
// byte off) takes the one-sample-a-thread copy. IEEE fp32 throughout: no
// TF32, no fast-math sqrt, sincos or exp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#if !defined(ORCAI_ODD) || (ORCAI_ODD != 11 && ORCAI_ODD != 13 && ORCAI_ODD != 17 && \
                             ORCAI_ODD != 23 && ORCAI_ODD != 31)
#error "build with -DORCAI_ODD=11, 13, 17, 23 or 31 (ops/_build.py::VARIANTS)"
#endif
#if !defined(ORCAI_DTYPE) || ORCAI_DTYPE < 0 || ORCAI_DTYPE > 2
#error "build with -DORCAI_DTYPE=0 (float32), 1 (int16) or 2 (uint8 mu-law codes)"
#endif
namespace {

#include "dft_butterflies.cuh"
#include "dft_pads.cuh"

constexpr int MAX_N = 8192;        // the largest FFT: n_fft, or M in the chirp mode
constexpr int CHIRP_MAX_N = 4096;  // the chirp mode's largest n_fft (M <= 8192)
constexpr int MAX_PASSES = 12;
constexpr int MAX_WARPS = 8;            // the warp layout's largest block
constexpr int MAX_BLOCK_THREADS = 512;  // the block layout's largest block
constexpr int MIN_RESIDENT_WARPS = 4;   // the warp layout's floor on an SM
constexpr int NO_PAD = 31;              // a >> 31 is 0 for every index

struct Plan {
  int n, n_passes, tw_len, zbuf;  // n: the FFT's size; zbuf: one exchange buffer
  int chirp_n;                    // the chirp mode's n_fft; 0 in the FFT mode
  int radix[MAX_PASSES];
  int ns[MAX_PASSES];      // product of the earlier radices
  int tw_off[MAX_PASSES];  // the pass's roots in the pass-ordered table
  int pad_s[MAX_PASSES];   // the buffer the pass writes: a + ((a >> s) << g)
  int pad_g[MAX_PASSES];
};

struct Layout {  // the block's shape and dynamic shared memory; offsets in bytes
  int block;     // 1: the whole block owns a frame pair; 0: each warp owns one
  int compiled;  // the warp layout's plan in COMPILED (the compiled layout), or -1
  int threads, units;  // threads a block; owners of frame pairs (warps, or 1)
  int frames, spans;   // frames a group; span buffers (2: the copy overlaps)
  int tables;          // 1: roots and window in shared memory
  int span_len, span_stride, win_off, z_off, span_off, bytes;
};

__device__ __forceinline__ int padded(int a, int s, int g) { return a + ((a >> s) << g); }

// The first pass (Ns = 1, no roots): butterfly j reads its inputs
// n = j + r*N/R through `load` and writes z'[j*R + r]. Thread `lane` of
// the `width` that share the FFT takes butterflies lane, lane + width, ...
template <int R, typename Load>
__device__ __forceinline__ void first_pass(const Load& load, float2* dst, int ds, int dg,
                                           int N, int lane, int width) {
  const int nb = N / R;
  for (int j = lane; j < nb; j += width) {
    float re[R], im[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = load(j + r * nb);
      re[r] = v.x;
      im[r] = v.y;
    }
    if constexpr (EMITS<R>) {
      dft_emit(re, im, [&](int r, float x, float y) {
        dst[padded(j * R + r, ds, dg)] = make_float2(x, y);
      });
    } else {
      dft(re, im);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[padded(j * R + r, ds, dg)] = make_float2(re[r], im[r]);
    }
  }
}

// a later pass: butterfly j reads z[j + r*N/R], multiplies by the roots at
// tw[(r - 1)*Ns + j % Ns], and writes z'[(j / Ns)*Ns*R + j % Ns + r*Ns]
template <int R>
__device__ __forceinline__ void pass(const float2* src, int ss, int sg, float2* dst,
                                     int ds, int dg, const float2* tw, int N, int ns,
                                     int lane, int width) {
  const int nb = N / R;
  int jm = lane % ns, q = lane / ns;  // j % ns and j / ns, stepped with j
  const int step_m = width % ns, step_q = width / ns;
  for (int j = lane; j < nb; j += width) {
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
    const int base = q * ns * R + jm;
    if constexpr (EMITS<R>) {
      dft_emit(re, im, [&](int r, float x, float y) {
        dst[padded(base + r * ns, ds, dg)] = make_float2(x, y);
      });
    } else {
      dft(re, im);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[padded(base + r * ns, ds, dg)] = make_float2(re[r], im[r]);
    }
    jm += step_m;
    q += step_q;
    if (jm >= ns) {
      jm -= ns;
      ++q;
    }
  }
}

// ODD, the largest odd radix a kernel is built for (11, 13, 17, 23 or 31),
// leaves the radix-13, -17, -19, -23, -29 and -31 butterflies out of a
// kernel whose plans lack them: their registers would cost the other passes
// a few percent
#define ORCAI_RADIX_CASES(CALL)  \
  case 2: CALL(2); break;        \
  case 3: CALL(3); break;        \
  case 4: CALL(4); break;        \
  case 5: CALL(5); break;        \
  case 7: CALL(7); break;        \
  case 8: CALL(8); break;        \
  case 11: CALL(11); break;      \
  case 13: if constexpr (ODD >= 13) { CALL(13); } break; \
  case 16: CALL(16); break;      \
  case 17: if constexpr (ODD >= 17) { CALL(17); } break; \
  case 19: if constexpr (ODD >= 19) { CALL(19); } break; \
  case 23: if constexpr (ODD >= 23) { CALL(23); } break; \
  case 29: if constexpr (ODD >= 29) { CALL(29); } break; \
  case 31: if constexpr (ODD >= 31) { CALL(31); } break;

// the warp layout synchronises the warp that owns the pair, the block
// layout the block
template <bool BLOCK>
__device__ __forceinline__ void fft_sync() {
  if (BLOCK) __syncthreads();
  else __syncwarp();
}

// One complex FFT of plan.n points by the plan's passes. The first pass
// reads its input through `load` and writes `first`; the later passes
// alternate between the two buffers. Returns the buffer that holds the
// result, in natural order in the last pass's layout.
template <bool BLOCK, int ODD, typename Load>
__device__ __forceinline__ float2* fft(const Load& load, float2* first, float2* second,
                                       const float2* tw, const Plan& plan, int lane,
                                       int width) {
  const int N = plan.n;
  switch (plan.radix[0]) {
#define ORCAI_FIRST(R) first_pass<R>(load, first, plan.pad_s[0], plan.pad_g[0], N, lane, width)
    ORCAI_RADIX_CASES(ORCAI_FIRST)
#undef ORCAI_FIRST
  }
  fft_sync<BLOCK>();
  float2* src = first;
  float2* dst = second;
  for (int p = 1; p < plan.n_passes; ++p) {
    const int ss = plan.pad_s[p - 1], sg = plan.pad_g[p - 1];
    const int ds = plan.pad_s[p], dg = plan.pad_g[p], ns = plan.ns[p];
    const float2* twp = tw + plan.tw_off[p];
    switch (plan.radix[p]) {
#define ORCAI_PASS(R) pass<R>(src, ss, sg, dst, ds, dg, twp, N, ns, lane, width)
      ORCAI_RADIX_CASES(ORCAI_PASS)
#undef ORCAI_PASS
    }
    fft_sync<BLOCK>();
    float2* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// the two real frames as one windowed complex signal: z = w x_t + i w x_t+1
template <typename T>
struct PairLoad {
  const T* xa;
  const T* xb;
  const float* win;
  __device__ __forceinline__ float2 operator()(int n) const {
    const float w = win[n];
    return make_float2(w * sample_to_f32(xa[n]), w * sample_to_f32(xb[n]));
  }
};

// the chirp mode's input: z = (w a)[n] (x_t + i x_t+1)[n] for n < n_fft,
// zero past it
template <typename T>
struct ChirpLoad {
  const T* xa;
  const T* xb;
  const float2* wa;
  int n_fft;
  __device__ __forceinline__ float2 operator()(int n) const {
    if (n >= n_fft) return make_float2(0.0f, 0.0f);
    const float2 c = wa[n];
    const float u = sample_to_f32(xa[n]), v = sample_to_f32(xb[n]);
    return make_float2(c.x * u - c.y * v, c.x * v + c.y * u);
  }
};

// the chirp mode's product, conjugated: conj(Y[m] B[m]), Y the forward
// FFT in its buffer, B = FFT_M(b) / M
struct ProductLoad {
  const float2* y;
  int s, g;
  const float2* b;
  __device__ __forceinline__ float2 operator()(int m) const {
    const float2 v = y[padded(m, s, g)], w = b[m];
    return make_float2(v.x * w.x - v.y * w.y, -(v.x * w.y + v.y * w.x));
  }
};

// Z[k] of the FFT mode: the last pass's output
struct FftBin {
  const float2* z;
  int s, g;
  __device__ __forceinline__ float2 operator()(int k) const { return z[padded(k, s, g)]; }
};

// Z[k] of the chirp mode: a[k] conj(u[k]), u the second FFT's output
struct ChirpBin {
  const float2* u;
  int s, g;
  const float2* a;
  __device__ __forceinline__ float2 operator()(int k) const {
    const float2 v = u[padded(k, s, g)], c = a[k];
    return make_float2(c.x * v.x + c.y * v.y, c.y * v.x - c.x * v.y);
  }
};

// untangle the two real frames t and t + 1 from Z (N points) and write
// their magnitude rows
template <typename Bin>
__device__ __forceinline__ void untangle(const Bin& bin, int N, float* __restrict__ out,
                                         int t, int n_frames, int lane, int width) {
  const int n_bins = N / 2 + 1;
  float* row_a = out + static_cast<long long>(t) * n_bins;
  const bool has_b = t + 1 < n_frames;
  for (int k = lane; k < n_bins; k += width) {
    const float2 za_k = bin(k);
    const float2 zy = bin(k == 0 ? 0 : N - k);
    const float pr = za_k.x + zy.x, pi = za_k.y - zy.y;  // 2 X_t[k]
    const float qr = za_k.y + zy.y, qi = za_k.x - zy.x;  // 2 |X_t+1[k]| parts
    const float ma = 0.5f * sqrtf(pr * pr + pi * pi), mb = 0.5f * sqrtf(qr * qr + qi * qi);
    row_a[k] = ma;
    if (has_b) row_a[n_bins + k] = mb;
  }
}

// Transform frames t and t + 1, whose samples start at xa and xa + hop, and
// write their magnitude rows. za and zb are the owner's exchange buffers;
// chirp holds the chirp mode's tables (w a, a: n_fft each; B: M).
template <bool BLOCK, int ODD, typename T>
__device__ __forceinline__ void transform_pair(const T* xa, int hop, const float* win,
                                               const float2* tw, const float2* chirp,
                                               float2* za, float2* zb, const Plan& plan,
                                               float* __restrict__ out, int t, int n_frames,
                                               int lane, int width) {
  const T* xb = xa + hop;
  const int last = plan.n_passes - 1;  // its layout is read after the passes
  if (!BLOCK || plan.chirp_n == 0) {
    const float2* z = fft<BLOCK, ODD>(PairLoad<T>{xa, xb, win}, za, zb, tw, plan, lane, width);
    untangle(FftBin{z, plan.pad_s[last], plan.pad_g[last]}, plan.n, out, t, n_frames, lane,
             width);
  } else {
    const int n_fft = plan.chirp_n;
    float2* y =
        fft<BLOCK, ODD>(ChirpLoad<T>{xa, xb, chirp, n_fft}, za, zb, tw, plan, lane, width);
    const int s = plan.pad_s[last], g = plan.pad_g[last];
    float2* other = y == za ? zb : za;
    const float2* u = fft<BLOCK, ODD>(ProductLoad{y, s, g, chirp + 2 * n_fft}, other, y, tw,
                                      plan, lane, width);
    untangle(ChirpBin{u, s, g, chirp + n_fft}, n_fft, out, t, n_frames, lane, width);
  }
  fft_sync<BLOCK>();  // the buffers are free for the next pair
}

// The compiled layout's plans, ops/dft.py::fft_plan's radices of the sizes
// that a configuration of the repo runs on this route: the spectral wires
// (ops/spectral.py). Their exchange layouts are exchange_pads' (dft_pads.cuh),
// derived at compile time. tests/test_torch_dft_mixed.py holds the table to
// fft_plan.
struct Compiled {
  int n_passes;
  int radix[3];
};
constexpr Compiled COMPILED[] = {
    {3, {16, 8, 3}},  // 384 / 192, the sp-bfp5 and sp-bfp6 wires
    {3, {8, 4, 11}},  // 352 / 176, the sp11-bfp5 wire
};
constexpr int N_COMPILED = sizeof(COMPILED) / sizeof(COMPILED[0]);

// the build that runs plans of largest odd radix `odd` (ops/dft.py::_build_variant)
__host__ __device__ constexpr int build_of(int odd) {
  return odd <= 11 ? 11 : odd <= 13 ? 13 : odd <= 17 ? 17 : odd <= 23 ? 23 : 31;
}

// the product of the radices before pass p
__host__ __device__ constexpr int ns_of(const Compiled& c, int p) {
  int v = 1;
  for (int q = 0; q < p; ++q) v *= c.radix[q];
  return v;
}
__host__ __device__ constexpr int largest_of(const Compiled& c) {
  int v = 1;
  for (int p = 0; p < c.n_passes; ++p) v = c.radix[p] > v ? c.radix[p] : v;
  return v;
}
__host__ __device__ constexpr int odd_of(const Compiled& c) {  // the largest odd radix
  int v = 1;
  for (int p = 0; p < c.n_passes; ++p) v = c.radix[p] % 2 && c.radix[p] > v ? c.radix[p] : v;
  return v;
}

// what each plan's radices give at compile time: its exchange layouts, and
// the length of one exchange buffer, even so that each is 16-byte aligned
struct Derived {
  Pads pads;
  int zbuf;
};
struct DerivedTable {
  Derived d[N_COMPILED];
};
__host__ __device__ constexpr DerivedTable derive() {
  DerivedTable t{};
  for (int i = 0; i < N_COMPILED; ++i) {
    const Compiled& c = COMPILED[i];
    const int n = ns_of(c, c.n_passes);
    t.d[i].pads = exchange_pads(c.radix, c.n_passes);
    int top = 0;
    for (int p = 0; p < c.n_passes; ++p) {
      const int s = t.d[i].pads.s[p], g = t.d[i].pads.g[p];
      const int end = s ? (n - 1) + (((n - 1) >> s) << g) + 1 : n;
      top = end > top ? end : top;
    }
    t.d[i].zbuf = (top + 1) & ~1;
  }
  return t;
}
constexpr DerivedTable DERIVED = derive();

// blocks of MAX_WARPS warps an SM that __launch_bounds__ asks registers
// for: the warp layout two (128 registers a thread), the compiled layout
// three (80), which its passes of radix 16 at most take without a spill
constexpr int WARP_MIN_BLOCKS = 2;
constexpr int COMPILED_MIN_BLOCKS = 3;

// COMPILED[I]'s constants
template <int I>
struct Fixed {
  static constexpr Compiled C = COMPILED[I];
  static constexpr Derived D = DERIVED.d[I];
  static constexpr int P = C.n_passes;
  static constexpr int N = ns_of(C, P);
  static constexpr int ZBUF = D.zbuf;
  __host__ __device__ static constexpr int R(int p) { return C.radix[p]; }
  __host__ __device__ static constexpr int NS(int p) { return ns_of(C, p); }
  __host__ __device__ static constexpr int S(int p) { return D.pads.s[p]; }
  __host__ __device__ static constexpr int G(int p) { return D.pads.g[p]; }
  // pass p's roots in the pass-ordered table (ops/dft.py::pass_roots)
  __host__ __device__ static constexpr int TW(int p) {
    int off = 0;
    for (int q = 1; q < p; ++q) off += (C.radix[q] - 1) * ns_of(C, q);
    return off;
  }
  __host__ __device__ static constexpr int ROUNDS(int p) { return (N / C.radix[p] + 31) / 32; }
  static constexpr int MIN_BLOCKS = COMPILED_MIN_BLOCKS;
  // a lane's first-pass window values, in registers where they are few
  static constexpr int WIN_REGS =
      (N / C.radix[0] + 31) / 32 * C.radix[0] <= 16 ? (N / C.radix[0] + 31) / 32 * C.radix[0] : 0;
  static_assert(largest_of(C) <= 16, "COMPILED_MIN_BLOCKS' registers hold radix 16 at most");
};

template <int S, int G>
__device__ __forceinline__ int pad(int a) {
  if constexpr (S == 0) return a;
  else return a + ((a >> S) << G);
}

// samples as float32 before the scale of int16 (1/32768) and of mu-law
// (4/32768: the code's 14-bit magnitude m14 unshifted), which the window
// carries: w * (x / 32768) and (w / 32768) * x are the same float, every
// scaling exact. An integer below 2^22 becomes a float as the low bits of
// 1.5 * 2^23 less that constant (an add and a float subtract, both exact),
// not by the conversion unit's quarter-rate I2F.
__device__ __forceinline__ float int_to_f32(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}
__device__ __forceinline__ float sample_unscaled(float v) { return v; }
__device__ __forceinline__ float sample_unscaled(int16_t v) { return int_to_f32(v); }
// a mu-law code's +-m14 = +-(((2 mant + 33) << e) - 33): (2 mant + 33) 2^e
// is the float whose bits are 33.0f's plus the code's low 7 bits (e, mant)
// shifted to the top of the mantissa; less 33 with the code's sign on both,
// exact (+0 for both zero codes)
__device__ __forceinline__ float sample_unscaled(uint8_t c) {
  const unsigned sign = (c & 0x80u) << 24;
  const float a = __uint_as_float((0x42040000u + ((c & 0x7Fu) << 19)) | sign);
  return a - __uint_as_float(0x42040000u | sign);
}
template <typename T>
constexpr float SAMPLE_SCALE = std::is_same_v<T, float>     ? 1.0f
                               : std::is_same_v<T, int16_t> ? 1.0f / 32768.0f
                                                            : 4.0f / 32768.0f;

// an R-point DFT whose output r goes to put(r, re, im)
template <int R, typename Put>
__device__ __forceinline__ void butterfly(float (&re)[R], float (&im)[R], const Put& put) {
  if constexpr (EMITS<R>) {
    dft_emit(re, im, put);
  } else {
    dft(re, im);
#pragma unroll
    for (int r = 0; r < R; ++r) put(r, re[r], im[r]);
  }
}

// pass 0: butterfly j reads the windowed samples n = j + r N/R of the two
// frames and writes z'[j R + r]
template <int I>
using WinRegs = float[Fixed<I>::WIN_REGS ? Fixed<I>::WIN_REGS : 1];

template <int I, typename T>
__device__ __forceinline__ void compiled_first(const T* xa, int hop, const WinRegs<I>& wreg,
                                               const float* win, float2* dst, int lane) {
  using F = Fixed<I>;
  constexpr int R = F::R(0), NB = F::N / R, H = F::ROUNDS(0);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    if (NB % 32 == 0 || j < NB) {
      float re[R], im[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = j + r * NB;
        const float w = F::WIN_REGS ? wreg[h * R + r] : win[n];
        re[r] = w * sample_unscaled(xa[n]);
        im[r] = w * sample_unscaled(xa[hop + n]);
      }
      butterfly<R>(re, im, [&](int r, float x, float y) {
        dst[pad<F::S(0), F::G(0)>(j * R + r)] = make_float2(x, y);
      });
    }
  }
}

// The compiled passes, on the constants F of a plan compiled whole (Fixed,
// BlockFixed) and W threads that share its FFT (a warp, or a group of the
// block layout). Pass p > 0, round h: butterfly j = lane + W h reads
// z[j + r N/R] (pass p - 1's layout; false where the round has no
// butterfly j), ...
template <class F, int W, int p>
__device__ __forceinline__ bool round_load(const float2* __restrict__ src, int lane, int h,
                                           float (&re)[F::R(p)], float (&im)[F::R(p)]) {
  constexpr int R = F::R(p), NB = F::N / R;
  const int j = lane + W * h;
  if (NB % W != 0 && j >= NB) return false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = src[pad<F::S(p - 1), F::G(p - 1)>(j + r * NB)];
    re[r] = v.x;
    im[r] = v.y;
  }
  return true;
}

// ... multiplies by the roots at twp[(r - 1) Ns + j % Ns] and hands output
// r of its DFT, z'[(j / Ns) Ns R + j % Ns + r Ns], to put(r, index, x, y)
template <class F, int W, int p, typename Put>
__device__ __forceinline__ void round_sums(const float2* __restrict__ twp, int lane, int h,
                                           float (&re)[F::R(p)], float (&im)[F::R(p)],
                                           const Put& put) {
  constexpr int R = F::R(p), NS = F::NS(p);
  const int j = lane + W * h;
  const int jm = j % NS;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const float2 w = twp[(r - 1) * NS + jm];
    const float vr = re[r] * w.x - im[r] * w.y;
    const float vi = re[r] * w.y + im[r] * w.x;
    re[r] = vr;
    im[r] = vi;
  }
  const int base = j / NS * NS * R + jm;
  butterfly<R>(re, im, [&](int r, float x, float y) { put(r, base + r * NS, x, y); });
}

// pass p > 0, round h of the warp layout: its loads, then its sums written
// to the other buffer
template <int I, int p>
__device__ __forceinline__ void compiled_round(const float2* __restrict__ src,
                                               float2* __restrict__ dst,
                                               const float2* __restrict__ twp, int lane, int h) {
  using F = Fixed<I>;
  float re[F::R(p)], im[F::R(p)];
  if (!round_load<F, 32, p>(src, lane, h, re, im)) return;
  round_sums<F, 32, p>(twp, lane, h, re, im, [&](int, int e, float x, float y) {
    dst[pad<F::S(p), F::G(p)>(e)] = make_float2(x, y);
  });
}

// pass p > 0: its rounds unrolled, so that one round's loads overlap
// another's sums
template <int I, int p>
__device__ __forceinline__ void compiled_pass(const float2* __restrict__ src,
                                              float2* __restrict__ dst,
                                              const float2* __restrict__ tw, int lane) {
  using F = Fixed<I>;
  constexpr int H = F::ROUNDS(p), TW = F::TW(p);
#pragma unroll
  for (int h = 0; h < H; ++h) compiled_round<I, p>(src, dst, tw + TW, lane, h);
}

template <int I, int p>
__device__ __forceinline__ void compiled_passes(float2*& src, float2*& dst,
                                                const float2* tw, int lane) {
  if constexpr (p < Fixed<I>::P) {
    compiled_pass<I, p>(src, dst, tw, lane);
    __syncwarp();
    float2* tmp = src;
    src = dst;
    dst = tmp;
    compiled_passes<I, p + 1>(src, dst, tw, lane);
  }
}

// Frames t and t + 1 through COMPILED[I]'s passes, untangled, their rows
// written: the warp layout's transform_pair with every constant folded
template <int I, typename T>
__device__ __forceinline__ void compiled_pair(const T* xa, int hop, const WinRegs<I>& wreg,
                                              const float* win, const float2* tw, float2* za,
                                              float2* zb, float* __restrict__ out, int t,
                                              int n_frames, int lane) {
  using F = Fixed<I>;
  constexpr int N = F::N, NBINS = N / 2 + 1, SL = F::S(F::P - 1), GL = F::G(F::P - 1);
  compiled_first<I>(xa, hop, wreg, win, za, lane);
  __syncwarp();
  float2* src = za;
  float2* dst = zb;
  compiled_passes<I, 1>(src, dst, tw, lane);
  float* row_a = out + static_cast<long long>(t) * NBINS;
  const bool has_b = t + 1 < n_frames;
#pragma unroll
  for (int m = 0; m < (NBINS + 31) / 32; ++m) {
    const int k = lane + 32 * m;
    if (NBINS % 32 == 0 || k < NBINS) {
      const float2 za_k = src[pad<SL, GL>(k)];
      const float2 zy = src[pad<SL, GL>(k == 0 ? 0 : N - k)];
      const float pr = za_k.x + zy.x, pi = za_k.y - zy.y;  // 2 X_t[k]
      const float qr = za_k.y + zy.y, qi = za_k.x - zy.x;  // 2 |X_t+1[k]| parts
      const float ma = 0.5f * sqrtf(pr * pr + pi * pi), mb = 0.5f * sqrtf(qr * qr + qi * qi);
      row_a[k] = ma;
      if (has_b) row_a[NBINS + k] = mb;
    }
  }
  __syncwarp();  // the buffers are free for the next pair
}

// The block layout's plans compiled whole: the FFTs of a power of two above
// the warp layout's reach, n_fft 4096 and 8192 in the FFT mode and the
// chirp mode's M of 4096 (2038 and 46 other n_fft) and 8192 (16). Every
// radix, stride, root offset, exchange layout and round is a constant
// (BlockFixed). A group of `threads` threads owns a frame pair and one
// exchange buffer; its passes run in place (each thread's butterflies
// read, the group's barrier, then written) and its barriers are named
// barriers of its own (bar.sync 1 + group), so that `groups` groups share
// a block, and the roots (and the chirp mode's B and a) that the block
// holds once in shared memory, and one group's barrier waits while
// another's passes run. The samples are read where they lie, a butterfly's
// R loads of a frame in flight together; the FFT mode's first-pass window
// stays in registers with the samples' scale, the chirp mode's w a is read
// through L1.
struct BlockCompiled {
  int n_passes;
  int radix[4];
  int pad_s[4], pad_g[4];  // exchange_pads' layouts (tests/test_torch_dft_mixed.py)
  int chirp;               // 1: the chirp mode's plan of M, 0: the FFT mode's
  int threads;             // a group's
  int groups;              // groups a block: as many as its shared memory and registers hold
};
constexpr BlockCompiled BLOCK_COMPILED[] = {
    {3, {16, 16, 16}, {4, 0, 0}, {0, 0, 0}, 0, 256, 3},         // 4096
    {3, {16, 16, 16}, {4, 0, 0}, {0, 0, 0}, 1, 256, 3},         // M 4096 (2038)
    {4, {16, 8, 8, 8}, {4, 0, 0, 0}, {0, 0, 0, 0}, 0, 512, 1},  // 8192
    {4, {16, 8, 8, 8}, {4, 0, 0, 0}, {0, 0, 0, 0}, 1, 512, 1},  // M 8192 (4078)
};
constexpr int N_BLOCK_COMPILED = sizeof(BLOCK_COMPILED) / sizeof(BLOCK_COMPILED[0]);

// the product of a block plan's radices before pass p
__host__ __device__ constexpr int block_ns(const BlockCompiled& c, int p) {
  int v = 1;
  for (int q = 0; q < p; ++q) v *= c.radix[q];
  return v;
}
// pass p's roots in the pass-ordered table (ops/dft.py::pass_roots)
__host__ __device__ constexpr int block_tw(const BlockCompiled& c, int p) {
  int off = 0;
  for (int q = 1; q < p; ++q) off += (c.radix[q] - 1) * block_ns(c, q);
  return off;
}
// one exchange buffer's length, even so that each is 16-byte aligned
__host__ __device__ constexpr int block_zbuf(const BlockCompiled& c) {
  const int n = block_ns(c, c.n_passes);
  int top = n;
  for (int p = 0; p < c.n_passes; ++p) {
    const int s = c.pad_s[p], g = c.pad_g[p];
    const int end = s ? (n - 1) + (((n - 1) >> s) << g) + 1 : n;
    top = end > top ? end : top;
  }
  return (top + 1) & ~1;
}
// every pass's butterflies fill the group's threads evenly
__host__ __device__ constexpr bool block_even(const BlockCompiled& c) {
  bool ok = true;
  for (int p = 0; p < c.n_passes; ++p)
    ok = ok && (block_ns(c, c.n_passes) / c.radix[p]) % c.threads == 0;
  return ok;
}

// BLOCK_COMPILED[I]'s constants
template <int I>
struct BlockFixed {
  static constexpr BlockCompiled C = BLOCK_COMPILED[I];
  static constexpr bool CHIRP = C.chirp;
  static constexpr int P = C.n_passes, GT = C.threads, GROUPS = C.groups;
  static constexpr int N = block_ns(C, P), TW_LEN = block_tw(C, P), ZBUF = block_zbuf(C);
  __host__ __device__ static constexpr int R(int p) { return C.radix[p]; }
  __host__ __device__ static constexpr int NS(int p) { return block_ns(C, p); }
  __host__ __device__ static constexpr int S(int p) { return C.pad_s[p]; }
  __host__ __device__ static constexpr int G(int p) { return C.pad_g[p]; }
  __host__ __device__ static constexpr int TW(int p) { return block_tw(C, p); }
  // a thread's butterflies in pass p
  __host__ __device__ static constexpr int K(int p) { return N / C.radix[p] / GT; }
  static_assert(block_even(C), "every pass's butterflies fill the group's threads evenly");
  static_assert(C.radix[0] == 16, "the chirp mode's first pass leaves its inputs 8..15 zero");
  static_assert(N / 16 == GT, "a thread has one first-pass butterfly: its window in registers");
};

// the group's barrier: the block's where a block is one group
template <int GT, int GROUPS>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (GROUPS == 1) __syncthreads();
  else asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(GT) : "memory");
}

// a thread's butterflies of a pass in registers: [k][r]
template <int K, int R>
struct Values {
  float re[K][R], im[K][R];
};
template <int I, int p>
using PassValues = Values<BlockFixed<I>::K(p), BlockFixed<I>::R(p)>;

// The FFT mode's first pass, before the group's barrier: butterfly j =
// tid (a thread's one) reads the windowed samples n = j + r N/R of the two
// frames and takes its DFT; the window, in registers, carries the samples'
// scale
template <int I, typename T>
__device__ __forceinline__ void block_first(const T* __restrict__ xa, int hop, bool has_b,
                                            const float (&wreg)[16], int tid,
                                            Values<1, 16>& v) {
  constexpr int NB = BlockFixed<I>::N / 16;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = tid + r * NB;
    v.re[0][r] = wreg[r] * sample_unscaled(xa[n]);
    v.im[0][r] = has_b ? wreg[r] * sample_unscaled(xa[hop + n]) : 0.0f;
  }
  dft(v.re[0], v.im[0]);
}
// The chirp mode's first pass: z = (w a)[n] (x_t + i x_t+1)[n] for n <
// n_fft, zero past it (w a: the table's first n_fft values, read through
// L1). n_fft <= N/2, so every butterfly's inputs 8..15 are zero: neither
// read nor summed (dft16_half)
template <int I, typename T>
__device__ __forceinline__ void chirp_first(const T* __restrict__ xa, int hop, bool has_b,
                                            const float2* __restrict__ wa, int n_fft, int tid,
                                            Values<1, 16>& v) {
  constexpr int NB = BlockFixed<I>::N / 16;
  constexpr float scale = SAMPLE_SCALE<T>;  // exact: a power of two
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = tid + r * NB;
    float u = 0.0f, w = 0.0f;
    float2 c = make_float2(0.0f, 0.0f);
    if (n < n_fft) {
      c = wa[n];
      u = sample_unscaled(xa[n]) * scale;
      if (has_b) w = sample_unscaled(xa[hop + n]) * scale;
    }
    v.re[0][r] = c.x * u - c.y * w;
    v.im[0][r] = c.x * w + c.y * u;
  }
  dft16_half(v.re[0], v.im[0]);
}

// Write a thread's DFT outputs of pass p: butterfly j's output r to
// z'[(j / Ns) Ns R + j % Ns + r Ns] in pass p's layout; the first ROWS
// outputs of each (the chirp mode's last pass: those below N/2)
template <int I, int p, int ROWS = BlockFixed<I>::R(p)>
__device__ __forceinline__ void block_store(float2* z, int tid, const PassValues<I, p>& v) {
  using F = BlockFixed<I>;
  constexpr int R = F::R(p), NS = F::NS(p);
#pragma unroll
  for (int k = 0; k < F::K(p); ++k) {
    const int j = tid + F::GT * k, base = j / NS * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      z[pad<F::S(p), F::G(p)>(base + r * NS)] = make_float2(v.re[k][r], v.im[k][r]);
  }
}

// Pass p > 0 in place, on the warp layout's rounds (round_load,
// round_sums) widened to a group: a thread reads all its butterflies'
// inputs, the group's barrier, then their sums, kept in v
template <int I, int p>
__device__ __forceinline__ void block_pass(const float2* z, const float2* __restrict__ tw,
                                           int tid, int group, PassValues<I, p>& v) {
  using F = BlockFixed<I>;
#pragma unroll
  for (int k = 0; k < F::K(p); ++k) round_load<F, F::GT, p>(z, tid, k, v.re[k], v.im[k]);
  group_sync<F::GT, F::GROUPS>(group);
#pragma unroll
  for (int k = 0; k < F::K(p); ++k)
    round_sums<F, F::GT, p>(tw + F::TW(p), tid, k, v.re[k], v.im[k],
                            [&](int r, int, float x, float y) {
                              v.re[k][r] = x;
                              v.im[k][r] = y;
                            });
}

// Passes p to LAST - 1, each written and followed by the group's barrier
template <int I, int p, int LAST>
__device__ __forceinline__ void block_passes(float2* z, const float2* tw, int tid, int group) {
  if constexpr (p < LAST) {
    using F = BlockFixed<I>;
    PassValues<I, p> v;
    block_pass<I, p>(z, tw, tid, group, v);
    block_store<I, p>(z, tid, v);
    group_sync<F::GT, F::GROUPS>(group);
    block_passes<I, p + 1, LAST>(z, tw, tid, group);
  }
}

template <int I>
using LastValues = PassValues<I, BlockFixed<I>::P - 1>;

// The last pass's outputs z[j + r N/R] (Ns R = N) written in its layout:
// natural order, as the untangle reads it
template <int I>
__device__ __forceinline__ void store_last(float2* z, int tid, int group, const LastValues<I>& v) {
  using F = BlockFixed<I>;
  block_store<I, F::P - 1>(z, tid, v);
  group_sync<F::GT, F::GROUPS>(group);
}

// The chirp mode's second FFT from the first's last pass (y, in
// registers: Y[j + r N/R]): conj(Y B) into the first pass of a forward FFT
// (B = FFT_M(b) / M); where the first and the last radix agree the same
// thread holds those points, so the product never leaves its registers.
// Then the passes, the last writing only its outputs below N/2: u[k] for
// k < n_fft <= N/2, in natural order
template <int I>
__device__ __forceinline__ void second_fft(float2* z, const float2* __restrict__ tw,
                                           const float2* __restrict__ bq, int tid, int group,
                                           LastValues<I>& y) {
  using F = BlockFixed<I>;
  constexpr int L = F::P - 1, NB = F::N / 16;
  Values<1, 16> v;
  if constexpr (F::R(L) == 16) {
    v = y;
  } else {  // through the buffer: pass L's layout, read as the first pass reads
    store_last<I>(z, tid, group, y);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float2 x = z[pad<F::S(L), F::G(L)>(tid + r * NB)];
      v.re[0][r] = x.x;
      v.im[0][r] = x.y;
    }
    group_sync<F::GT, F::GROUPS>(group);
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float2 w = bq[tid + r * NB];
    const float vr = v.re[0][r], vi = v.im[0][r];
    v.re[0][r] = vr * w.x - vi * w.y;
    v.im[0][r] = -(vr * w.y + vi * w.x);
  }
  dft(v.re[0], v.im[0]);
  block_store<I, 0>(z, tid, v);
  group_sync<F::GT, F::GROUPS>(group);
  block_passes<I, 1, L>(z, tw, tid, group);
  LastValues<I> u;
  block_pass<I, L>(z, tw, tid, group, u);
  block_store<I, L, F::R(L) / 2>(z, tid, u);
  group_sync<F::GT, F::GROUPS>(group);
}

// BLOCK_COMPILED[I] on the block layout: each group of a block transforms
// the frame pairs blockIdx.x * GROUPS + group, + gridDim.x * GROUPS, ...
// in the chirp mode (an n_fft up to N / 2 on M = N) or the FFT mode (n_fft
// = N), as the plan's row says. Shared memory: the pass-ordered roots, in
// the chirp mode B and (lay.tables) a after them, then the groups'
// exchange buffers at lay.z_off.
template <typename T, int I>
__global__ void __launch_bounds__(BlockFixed<I>::GT * BlockFixed<I>::GROUPS, 1)
dft_block_kernel(const T* __restrict__ audio, const float* __restrict__ window,
                 const float2* __restrict__ roots, const float2* __restrict__ chirp,
                 float* __restrict__ out, int n_frames, int hop, int n_fft, const Layout lay) {
  using F = BlockFixed<I>;
  constexpr bool CHIRP = F::CHIRP;
  constexpr int N = F::N, GT = F::GT, GROUPS = F::GROUPS;
  constexpr int L = F::P - 1, SL = F::S(L) ? F::S(L) : NO_PAD;  // the untangle's layout
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* bq = tw + F::TW_LEN;
  float2* a_s = bq + N;
  const int group = threadIdx.x / GT, tid = threadIdx.x % GT;
  float2* z = reinterpret_cast<float2*>(smem + lay.z_off) + group * F::ZBUF;
  for (int i = threadIdx.x; i < F::TW_LEN; i += GT * GROUPS) tw[i] = roots[i];
  if constexpr (CHIRP) {
    for (int i = threadIdx.x; i < N; i += GT * GROUPS) bq[i] = chirp[2 * n_fft + i];
    if (lay.tables)
      for (int i = threadIdx.x; i < n_fft; i += GT * GROUPS) a_s[i] = chirp[n_fft + i];
  }
  const float2* at = !CHIRP ? nullptr : lay.tables ? a_s : chirp + n_fft;
  // the FFT mode's first-pass window values, with the samples' scale
  float wreg[16];
  if constexpr (!CHIRP) {
#pragma unroll
    for (int r = 0; r < 16; ++r) wreg[r] = window[tid + r * (N / 16)] * SAMPLE_SCALE<T>;
  }
  __syncthreads();  // the tables are in place

  const int n_pairs = (n_frames + 1) / 2;
  for (int pair = blockIdx.x * GROUPS + group; pair < n_pairs; pair += gridDim.x * GROUPS) {
    const int t = 2 * pair;
    const T* xa = audio + static_cast<long long>(t) * hop;
    const bool has_b = t + 1 < n_frames;
    Values<1, 16> v;
    if constexpr (CHIRP)
      chirp_first<I>(xa, hop, has_b, chirp, n_fft, tid, v);
    else
      block_first<I>(xa, hop, has_b, wreg, tid, v);
    group_sync<GT, GROUPS>(group);  // the previous pair's untangle is done with z
    block_store<I, 0>(z, tid, v);
    group_sync<GT, GROUPS>(group);
    block_passes<I, 1, L>(z, tw, tid, group);
    LastValues<I> y;
    block_pass<I, L>(z, tw, tid, group, y);
    if constexpr (CHIRP) {
      second_fft<I>(z, tw, bq, tid, group, y);
      untangle(ChirpBin{z, SL, F::G(L), at}, n_fft, out, t, n_frames, tid, GT);
    } else {
      store_last<I>(z, tid, group, y);
      untangle(FftBin{z, SL, F::G(L)}, N, out, t, n_frames, tid, GT);
    }
  }
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

// the compiled plan CI's constants, and the generic kernels' (CI < 0)
template <int CI, bool = (CI >= 0)>
struct Shape {
  static constexpr int MIN_BLOCKS = WARP_MIN_BLOCKS, WIN_REGS = 0, ZBUF = 0;
};
template <int CI>
struct Shape<CI, true> : Fixed<CI> {};

// BLOCK false: the warp layout, each warp transforms its own frame pairs of
// a group (two span buffers always), by the plan's passes or, CI >= 0, by
// those of COMPILED[CI] compiled in (the compiled layout); true: the block
// layout, the whole block transforms the group's pairs one after the other.
template <typename T, bool BLOCK, int ODD, int CI = -1>
__global__ void __launch_bounds__(BLOCK ? MAX_BLOCK_THREADS : MAX_WARPS * 32,
                                  BLOCK ? 1 : Shape<CI>::MIN_BLOCKS)
dft_mixed_kernel(const T* __restrict__ audio, long long n_samples,
                 const float* __restrict__ window, const float2* __restrict__ roots,
                 const float2* __restrict__ chirp, float* __restrict__ out, int n_frames,
                 int hop, int vec_ok, const Plan plan, const Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan sp;  // read with the pass index, so from shared memory
  const bool tables = !BLOCK || lay.tables;
  float2* tw_s = reinterpret_cast<float2*>(smem);
  float* win_s = reinterpret_cast<float*>(smem + lay.win_off);
  const float2* tw = tables ? tw_s : roots;
  const float* win = tables ? win_s : window;
  T* span = reinterpret_cast<T*>(smem + lay.span_off);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = BLOCK ? tid : (tid & 31);
  const int width = BLOCK ? n_threads : 32;
  const int unit = BLOCK ? 0 : (tid >> 5);  // this thread's owner of frame pairs
  const int zbuf = Shape<CI>::ZBUF ? Shape<CI>::ZBUF : plan.zbuf;
  float2* za = reinterpret_cast<float2*>(smem + lay.z_off) + 2 * unit * zbuf;
  float2* zb = za + zbuf;

  const int frames = lay.frames;
  const int n_groups = (n_frames + frames - 1) / frames;
  if (static_cast<int>(blockIdx.x) < n_groups)
    stage(audio, n_samples, span, lay.span_len,
          static_cast<long long>(blockIdx.x) * frames * hop, vec_ok, tid, n_threads);
  if (tid == 0) sp = plan;
  // the compiled layout's window carries the samples' scale (sample_unscaled)
  const float scale = CI >= 0 ? SAMPLE_SCALE<T> : 1.0f;
  if (tables) {
    for (int i = tid; i < plan.tw_len; i += n_threads) tw_s[i] = roots[i];
    if (plan.chirp_n == 0)
      for (int n = tid; n < plan.n; n += n_threads) win_s[n] = window[n] * scale;
  }
  constexpr int WIN_REGS = Shape<CI>::WIN_REGS;
  float wreg[WIN_REGS ? WIN_REGS : 1];
  if constexpr (WIN_REGS > 0) {
    constexpr int R0 = Fixed<CI>::R(0), NB0 = Fixed<CI>::N / R0;
#pragma unroll
    for (int i = 0; i < WIN_REGS; ++i) {
      const int j = lane + 32 * (i / R0);
      wreg[i] = j < NB0 ? window[j + i % R0 * NB0] * scale : 0.0f;
    }
  }

  int cur = 0;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int next = g + gridDim.x;
    if ((!BLOCK || lay.spans == 2) && next < n_groups) {
      stage(audio, n_samples, span + (cur ^ 1) * lay.span_stride, lay.span_len,
            static_cast<long long>(next) * frames * hop, vec_ok, tid, n_threads);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();  // group g's samples (and the tables) are in place
    for (int pair = unit; pair < frames / 2; pair += lay.units) {
      const int t = g * frames + 2 * pair;
      if (t >= n_frames) break;  // the same for every thread of the owner
      const T* xa = span + cur * lay.span_stride + 2 * pair * hop;
      if constexpr (CI >= 0)
        compiled_pair<CI>(xa, hop, wreg, win, tw, za, zb, out, t, n_frames, lane);
      else
        transform_pair<BLOCK, ODD>(xa, hop, win, tw, chirp, za, zb, sp, out, t, n_frames, lane,
                                   width);
    }
    __syncthreads();  // every owner is done with this span buffer
    if (!BLOCK || lay.spans == 2)
      cur ^= 1;
    else if (next < n_groups)
      stage(audio, n_samples, span, lay.span_len, static_cast<long long>(next) * frames * hop,
            vec_ok, tid, n_threads);
  }
}

// [P, R_1..R_P, s_1..s_P, g_1..g_P] -> Plan of an FFT of the radices'
// product: n_fft itself, or in the chirp mode an M from 2 n_fft - 1 to
// MAX_N. Nonzero when it is not such a plan.
int make_plan(const int* packed, int n_fft, bool chirp, Plan* plan) {
  const int P = packed[0];
  if (P < 1 || P > MAX_PASSES) return 1;
  long long prod = 1;
  for (int p = 0; p < P; ++p) {
    const int R = packed[1 + p];
    if (R != 2 && R != 3 && R != 4 && R != 5 && R != 7 && R != 8 && R != 11 && R != 13 &&
        R != 16 && R != 17 && R != 19 && R != 23 && R != 29 && R != 31)
      return 1;
    prod *= R;
    if (prod > MAX_N) return 1;
  }
  if (chirp ? prod < 2LL * n_fft - 1 : prod != n_fft) return 1;
  const int n = static_cast<int>(prod);
  plan->n = n;
  plan->chirp_n = chirp ? n_fft : 0;
  plan->n_passes = P;
  int ns = 1, tw = 0, zbuf = 0;
  for (int p = 0; p < P; ++p) {
    const int R = packed[1 + p], s = packed[1 + P + p], g = packed[1 + 2 * P + p];
    if (s < 0 || s > 16 || g < 0 || (s > 0 && g > s - 2) || (s == 0 && g != 0)) return 1;
    plan->radix[p] = R;
    plan->ns[p] = ns;
    plan->tw_off[p] = tw;
    if (p > 0) tw += (R - 1) * ns;
    ns *= R;
    plan->pad_s[p] = s ? s : NO_PAD;
    plan->pad_g[p] = g;
    const int top = (n - 1) + (((n - 1) >> plan->pad_s[p]) << g) + 1;
    zbuf = top > zbuf ? top : zbuf;
  }
  plan->tw_len = tw;
  plan->zbuf = (zbuf + 1) & ~1;  // even: every buffer 16-byte aligned
  return 0;
}

int round16(int bytes) { return (bytes + 15) & ~15; }

constexpr int INFO = 9;  // the values orcai_dft_mixed_layout reports

// Fill in the offsets and size of `lay` (block, threads, units, frames,
// spans and tables set) for this plan, hop, sample size and exchange
// buffer length.
void size_layout(const Plan& plan, int hop, int elem, int zbuf, Layout* lay) {
  const int frame_len = plan.chirp_n ? plan.chirp_n : plan.n;  // samples a frame
  const int win_bytes = plan.chirp_n ? 0 : 4 * plan.n;
  lay->span_len = (lay->frames - 1) * hop + frame_len;
  lay->span_stride = round16(lay->span_len * elem) / elem;
  lay->win_off = lay->tables ? plan.tw_len * 8 : 0;
  lay->z_off = lay->tables ? round16(lay->win_off + win_bytes) : 0;
  lay->span_off = lay->z_off + lay->units * 2 * zbuf * 8;
  lay->bytes = lay->span_off + lay->spans * lay->span_stride * elem;
}

// The block's shape for this plan, hop and sample size; compiled: the index
// of the plan in COMPILED, or -1. The warp layout (the compiled layout
// where the plan is compiled): of 8, 4, 2 or 1 warps and 1, 2 or 4 frame
// pairs a warp per group, the one that keeps the most warps resident on an
// SM (at most 8 x WARP_MIN_BLOCKS, 16, or in the compiled layout 8 x
// COMPILED_MIN_BLOCKS, 24: the blocks __launch_bounds__ gives registers
// for), then the most frames a group;
// taken when that is at least MIN_RESIDENT_WARPS. Else, and
// always in the chirp mode, the block layout: a block of up to 512 threads,
// as many as the passes' fewest butterflies (plan.n over its largest
// radix) fill, with 1, 2 or 4 frame pairs a group; the most warps resident,
// then two span buffers, then the tables in shared memory, then the most
// frames.
int choose_layout(const Plan& plan, int hop, int elem, int compiled, Layout* best) {
  int device = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  const int reserved = 1024 + static_cast<int>(sizeof(Plan));  // per block
  const int limit = optin - static_cast<int>(sizeof(Plan));
  int best_key = -1;
  if (plan.chirp_n == 0) {
    const int zbuf = compiled < 0 ? plan.zbuf : DERIVED.d[compiled].zbuf;
    const int max_warps = MAX_WARPS * (compiled < 0 ? WARP_MIN_BLOCKS : COMPILED_MIN_BLOCKS);
    for (int warps = MAX_WARPS; warps >= 1; warps /= 2) {
      for (int per_warp = 1; per_warp <= 4; per_warp *= 2) {
        Layout lay;
        lay.block = 0;
        lay.compiled = compiled;
        lay.threads = 32 * warps;
        lay.units = warps;
        lay.frames = 2 * warps * per_warp;
        lay.spans = 2;
        lay.tables = 1;
        size_layout(plan, hop, elem, zbuf, &lay);
        if (lay.bytes > limit) continue;
        int blocks = per_sm / (lay.bytes + reserved);
        if (blocks > max_warps / warps) blocks = max_warps / warps;
        const int key = blocks * warps * 64 + (lay.frames > 32 ? 0 : lay.frames);
        if (blocks * warps >= MIN_RESIDENT_WARPS && key > best_key) {
          best_key = key;
          *best = lay;
        }
      }
    }
    if (best_key >= 0) return 0;
  }
  int largest = 1;
  for (int p = 0; p < plan.n_passes; ++p)
    largest = plan.radix[p] > largest ? plan.radix[p] : largest;
  int threads = (plan.n / largest + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > MAX_BLOCK_THREADS ? MAX_BLOCK_THREADS : threads;
  for (int frames = 2; frames <= 8; frames *= 2) {
    for (int spans = 1; spans <= 2; ++spans) {
      for (int tables = 0; tables <= 1; ++tables) {
        Layout lay;
        lay.block = 1;
        lay.compiled = -1;
        lay.threads = threads;
        lay.units = 1;
        lay.frames = frames;
        lay.spans = spans;
        lay.tables = tables;
        size_layout(plan, hop, elem, plan.zbuf, &lay);
        if (lay.bytes > limit) continue;
        int blocks = per_sm / (lay.bytes + reserved);
        const int by_regs = 65536 / (threads * 128), by_threads = 2048 / threads;
        blocks = blocks < by_regs ? blocks : by_regs;
        blocks = blocks < by_threads ? blocks : by_threads;
        const int key = blocks * threads / 32 * 10000 + spans * 1000 + tables * 100 + frames;
        if (blocks > 0 && key > best_key) {
          best_key = key;
          *best = lay;
        }
      }
    }
  }
  return best_key < 0;
}

// The kernel's dynamic shared memory set to the layout's, then how many
// of its blocks an SM holds
template <typename Kernel>
int resident_blocks(Kernel kernel, const Layout& lay, int* per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, lay.threads, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *per_sm < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

// [layout (0 warp, 1 block, 2 compiled), threads, blocks an SM, frames a
// group, dynamic shared memory, registers a thread, local memory a thread,
// frame pairs in flight on an SM, 1 where the plan is compiled whole]
template <typename Kernel>
int describe(Kernel kernel, const Layout& lay, int* info) {
  int per_sm = 0;
  if (const int err = resident_blocks(kernel, lay, &per_sm)) return err;
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, kernel); err != cudaSuccess)
    return static_cast<int>(err);
  const int kind = lay.block ? 1 : lay.compiled >= 0 ? 2 : 0;
  const int values[INFO] = {kind, lay.threads, per_sm, lay.frames, lay.bytes, attr.numRegs,
                            static_cast<int>(attr.localSizeBytes), per_sm * lay.units,
                            lay.compiled >= 0};
  for (int i = 0; i < INFO; ++i) info[i] = values[i];
  return 0;
}

template <typename T, bool BLOCK, int ODD, int CI = -1>
int run(const void* audio, const float* window, const float* roots, const float* chirp,
        const Plan& plan, const Layout& lay, float* out, int n_frames, int hop,
        cudaStream_t s, int* info) {
  const auto kernel = dft_mixed_kernel<T, BLOCK, ODD, CI>;
  if (info) return describe(kernel, lay, info);
  int per_sm = 0;
  if (const int err = resident_blocks(kernel, lay, &per_sm)) return err;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int per = 16 / static_cast<int>(sizeof(T));
  const int vec_ok = reinterpret_cast<uintptr_t>(audio) % 16 == 0 && hop % per == 0;
  const int frame_len = plan.chirp_n ? plan.chirp_n : plan.n;
  const long long n_samples = static_cast<long long>(n_frames - 1) * hop + frame_len;
  const int n_groups = (n_frames + lay.frames - 1) / lay.frames;
  const int grid = n_groups < per_sm * n_sm ? n_groups : per_sm * n_sm;
  kernel<<<grid, lay.threads, lay.bytes, s>>>(
      static_cast<const T*>(audio), n_samples, window,
      reinterpret_cast<const float2*>(roots), reinterpret_cast<const float2*>(chirp), out,
      n_frames, hop, vec_ok, plan, lay);
  return static_cast<int>(cudaGetLastError());
}

// The index in COMPILED of the FFT-mode plan this build compiled in, or -1
int compiled_index(const Plan& plan) {
  if (plan.chirp_n) return -1;
  for (int i = 0; i < N_COMPILED; ++i) {
    const Compiled& c = COMPILED[i];
    bool same = build_of(odd_of(c)) == ORCAI_ODD && c.n_passes == plan.n_passes;
    for (int p = 0; same && p < c.n_passes; ++p) same = c.radix[p] == plan.radix[p];
    if (same) return i;
  }
  return -1;
}

// the compiled layout's kernel of COMPILED[lay.compiled]: one for each plan
// of this build
template <typename T, int I = 0>
int run_compiled(const void* audio, const float* window, const float* roots, const Plan& plan,
                 const Layout& lay, float* out, int n_frames, int hop, cudaStream_t s,
                 int* info) {
  if constexpr (I == N_COMPILED) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if constexpr (build_of(odd_of(COMPILED[I])) == ORCAI_ODD) {
      if (lay.compiled == I)
        return run<T, false, ORCAI_ODD, I>(audio, window, roots, nullptr, plan, lay, out,
                                           n_frames, hop, s, info);
    }
    return run_compiled<T, I + 1>(audio, window, roots, plan, lay, out, n_frames, hop, s, info);
  }
}

// The index in BLOCK_COMPILED of this plan in its mode, in the build that
// compiles it (that of no odd radix), or -1
int block_compiled_index(const Plan& plan) {
  if (build_of(1) != ORCAI_ODD) return -1;
  for (int i = 0; i < N_BLOCK_COMPILED; ++i) {
    const BlockCompiled& c = BLOCK_COMPILED[i];
    bool same = c.n_passes == plan.n_passes && c.chirp == (plan.chirp_n != 0);
    for (int p = 0; same && p < c.n_passes; ++p) same = c.radix[p] == plan.radix[p];
    if (same) return i;
  }
  return -1;
}

template <typename T, int I>
int run_block(const void* audio, const float* window, const float* roots, const float* chirp,
              const Plan& plan, const Layout& lay, float* out, int n_frames, int hop,
              cudaStream_t s, int* info) {
  const auto kernel = dft_block_kernel<T, I>;
  if (info) return describe(kernel, lay, info);
  int per_sm = 0;
  if (const int err = resident_blocks(kernel, lay, &per_sm)) return err;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int blocks = ((n_frames + 1) / 2 + lay.units - 1) / lay.units;
  const int grid = blocks < per_sm * n_sm ? blocks : per_sm * n_sm;
  kernel<<<grid, lay.threads, lay.bytes, s>>>(
      static_cast<const T*>(audio), window, reinterpret_cast<const float2*>(roots),
      reinterpret_cast<const float2*>(chirp), out, n_frames, hop,
      plan.chirp_n ? plan.chirp_n : plan.n, lay);
  return static_cast<int>(cudaGetLastError());
}

// BLOCK_COMPILED[bc]'s kernel: its layout (the roots, in the chirp mode B
// and, where the block's shared memory holds it, a, then a buffer a group)
template <typename T, int I = 0>
int run_block_compiled(const void* audio, const float* window, const float* roots,
                       const float* chirp, const Plan& plan, int bc, float* out, int n_frames,
                       int hop, cudaStream_t s, int* info) {
  if constexpr (I == N_BLOCK_COMPILED || build_of(1) != ORCAI_ODD) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (bc != I)
      return run_block_compiled<T, I + 1>(audio, window, roots, chirp, plan, bc, out, n_frames,
                                          hop, s, info);
    using F = BlockFixed<I>;
    int device = 0, limit = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    Layout lay{};
    lay.block = 1;
    lay.compiled = I;
    lay.threads = F::GT * F::GROUPS;
    lay.units = F::GROUPS;
    lay.frames = 2;
    const int tables = F::TW_LEN * 8 + (plan.chirp_n ? F::N * 8 : 0);
    const int a_bytes = plan.chirp_n * 8, buffers = F::GROUPS * F::ZBUF * 8;
    lay.tables = a_bytes > 0 && round16(tables + a_bytes) + buffers <= limit;
    lay.z_off = round16(tables + (lay.tables ? a_bytes : 0));
    lay.bytes = lay.z_off + buffers;
    if (lay.bytes > limit) return static_cast<int>(cudaErrorInvalidConfiguration);
    return run_block<T, I>(audio, window, roots, chirp, plan, lay, out, n_frames, hop, s, info);
  }
}

template <typename T>
int launch(const void* audio, const float* window, const float* roots, const float* chirp,
           const Plan& plan, float* out, int n_frames, int hop, cudaStream_t s, int* info) {
  int odd = 1;  // the largest odd radix the plan needs: within this build's
  for (int p = 0; p < plan.n_passes; ++p)
    if (plan.radix[p] % 2 && plan.radix[p] > odd) odd = plan.radix[p];
  if (odd > ORCAI_ODD) return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (choose_layout(plan, hop, static_cast<int>(sizeof(T)), compiled_index(plan), &lay))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (lay.block && block_compiled_index(plan) >= 0)
    return run_block_compiled<T>(audio, window, roots, chirp, plan, block_compiled_index(plan),
                                 out, n_frames, hop, s, info);
  if (lay.block)  // no radix-11 block kernel: its plans run the radix-13 one
    return run<T, true, (ORCAI_ODD < 13 ? 13 : ORCAI_ODD)>(audio, window, roots, chirp, plan, lay,
                                                         out, n_frames, hop, s, info);
  if (lay.compiled >= 0)
    return run_compiled<T>(audio, window, roots, plan, lay, out, n_frames, hop, s, info);
  return run<T, false, ORCAI_ODD>(audio, window, roots, chirp, plan, lay, out, n_frames, hop, s,
                                  info);
}

using Sample = std::conditional_t<ORCAI_DTYPE == 0, float,
                                  std::conditional_t<ORCAI_DTYPE == 1, int16_t, uint8_t>>;

int checked_plan(int dtype, const float* window, const float* chirp, const int* plan, int n_fft,
                 int hop, int n_frames, Plan* p) {
  const int max_n = chirp ? CHIRP_MAX_N : MAX_N;
  if (n_fft < 2 || n_fft > max_n || hop < 1 || hop > n_fft || n_fft % hop != 0 ||
      n_frames < 1 || plan == nullptr || (chirp == nullptr && window == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (make_plan(plan, n_fft, chirp != nullptr, p)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != ORCAI_DTYPE) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
}  // namespace

// audio: (n_frames - 1) * hop + n_fft samples of float32 (dtype 0), int16
// (dtype 1) or uint8 mu-law codes (dtype 2); plan: host int32 [P, R_1..R_P,
// s_1..s_P, g_1..g_P] (ops/dft.py::pack_plan); roots: the plan's roots of
// unity in pass order, (tw_len, 2) float32 (ops/dft.py::pass_roots); out:
// (n_frames, n_fft/2 + 1) float32; hop divides n_fft. With chirp null (the
// FFT mode) the radices multiply to n_fft, from 2 to 8192, and window is
// the (n_fft,) float32 window. Otherwise (the chirp mode, n_fft from 2 to
// 4096) they multiply to an M >= 2 n_fft - 1, chirp is ops/dft.py::
// chirp_tables' (2 n_fft + M, 2) float32 and window is not read. The
// plan's largest odd radix may not pass this build's ORCAI_ODD, and dtype
// must be its ORCAI_DTYPE. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int orcai_dft_mixed(const void* audio, int dtype, const float* window,
                               const float* roots, const float* chirp, const int* plan,
                               float* out, int n_frames, int n_fft, int hop, void* stream) {
  Plan p;
  if (const int err = checked_plan(dtype, window, chirp, plan, n_fft, hop, n_frames, &p))
    return err;
  return launch<Sample>(audio, window, roots, chirp, p, out, n_frames, hop,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// What orcai_dft_mixed would launch for these arguments (chirp nonzero: the
// chirp mode) on the current device, into info[9]: the layout (0 warp, 1
// block, 2 compiled), threads a block, blocks resident on an SM, frames a
// group, dynamic shared memory a block, registers and local memory a
// thread, frame pairs in flight on an SM, and 1 where the plan runs a
// kernel compiled whole. Launches nothing.
extern "C" int orcai_dft_mixed_layout(int dtype, const int* plan, int n_fft, int hop, int chirp,
                                      int* info) {
  static const float dummy = 0.0f;
  Plan p;
  if (const int err = checked_plan(dtype, &dummy, chirp ? &dummy : nullptr, plan, n_fft, hop, 1,
                                   &p))
    return err;
  return launch<Sample>(nullptr, nullptr, nullptr, nullptr, p, nullptr, 1, hop, nullptr, info);
}
