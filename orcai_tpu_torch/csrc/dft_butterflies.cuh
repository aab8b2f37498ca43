// The butterflies and sample decoders that csrc/dft_mixed.cu and
// csrc/dft_cluster.cu and csrc/dft_staged.cu share (csrc/dft_point.cu takes
// the decoders alone): float32, int16 and uint8 mu-law samples as
// float32, and R-point DFTs in registers for R = 2, 3, 4, 5, 7, 8, 11, 13,
// 16, 17, 19, 23, 29 and 31, outputs in natural order. The odd radices' cos and
// sin and radix 16's twiddles are float64 values rounded once to float32
// (ops/dft.py::_odd_roots, _C16, _S16). Included in an anonymous
// namespace of each kernel's source, which includes <utility> first.
//
// Both kernels replace the TPU kernel orcai_tpu/ops/pallas_dft.py::
// dft_magnitude, whose bound on this card is bytes (each sample read once,
// each magnitude written once). A direct odd radix costs about R - 1 real
// multiply-adds a complex value where a power of two costs a few, but it
// is one pass through shared memory, which is what holds these FFTs:
// radix 19 puts 1216 = 8 * 8 * 19 on three passes, where the chirp mode
// ran two FFTs of 2431 points, and radix 23 puts 1472 = 8 * 8 * 23 on
// three, as 29 and 31 put 1856 = 8 * 8 * 29 and 1984 = 8 * 8 * 31. A
// butterfly keeps its R values in registers; the kernels are built per
// largest odd radix, so a plan without a 17, 19, 23, 29 or 31 does not pay
// their registers. Radices 29 and 31 hand each output pair on as soon as it
// is summed (dft_emit), so that a thread never holds all R outputs beside
// the sums they are made of, within the kernels' 128 registers.

#pragma once

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

// cos and sin of 2 pi m / R for m = 1 .. (R - 1) / 2, float64 values rounded
// once to float32 (ops/dft.py::_odd_roots), keyed R * 16 + m: m < 16 holds up
// to radix 31 (m = 15) with no slot to spare; radix 37 needs a wider key
constexpr int ROOT_KEY_SLOTS = 16;
constexpr int LARGEST_ODD_RADIX = 31;
static_assert((LARGEST_ODD_RADIX - 1) / 2 < ROOT_KEY_SLOTS, "R * 16 + m must be unique");
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
    case 13 * 16 + 1: return 0.885456026f;
    case 13 * 16 + 2: return 0.568064749f;
    case 13 * 16 + 3: return 0.120536678f;
    case 13 * 16 + 4: return -0.354604900f;
    case 13 * 16 + 5: return -0.748510778f;
    case 13 * 16 + 6: return -0.970941842f;
    case 17 * 16 + 1: return 0.932472229f;
    case 17 * 16 + 2: return 0.739008904f;
    case 17 * 16 + 3: return 0.445738345f;
    case 17 * 16 + 4: return 0.0922683626f;
    case 17 * 16 + 5: return -0.273662984f;
    case 17 * 16 + 6: return -0.602634609f;
    case 17 * 16 + 7: return -0.850217164f;
    case 17 * 16 + 8: return -0.982973099f;
    case 19 * 16 + 1: return 0.945817232f;
    case 19 * 16 + 2: return 0.789140522f;
    case 19 * 16 + 3: return 0.546948135f;
    case 19 * 16 + 4: return 0.245485485f;
    case 19 * 16 + 5: return -0.0825793445f;
    case 19 * 16 + 6: return -0.401695430f;
    case 19 * 16 + 7: return -0.677281559f;
    case 19 * 16 + 8: return -0.879473746f;
    case 19 * 16 + 9: return -0.986361325f;
    case 23 * 16 + 1: return 0.962917268f;
    case 23 * 16 + 2: return 0.854419410f;
    case 23 * 16 + 3: return 0.682553172f;
    case 23 * 16 + 4: return 0.460065037f;
    case 23 * 16 + 5: return 0.203456014f;
    case 23 * 16 + 6: return -0.0682424158f;
    case 23 * 16 + 7: return -0.334879607f;
    case 23 * 16 + 8: return -0.576680303f;
    case 23 * 16 + 9: return -0.775711298f;
    case 23 * 16 + 10: return -0.917211294f;
    case 23 * 16 + 11: return -0.990685940f;
    case 29 * 16 + 1: return 0.976620555f;
    case 29 * 16 + 2: return 0.907575428f;
    case 29 * 16 + 3: return 0.796093047f;
    case 29 * 16 + 4: return 0.647386312f;
    case 29 * 16 + 5: return 0.468408436f;
    case 29 * 16 + 6: return 0.267528325f;
    case 29 * 16 + 7: return 0.05413891f;
    case 29 * 16 + 8: return -0.161781996f;
    case 29 * 16 + 9: return -0.370138168f;
    case 29 * 16 + 10: return -0.561187088f;
    case 29 * 16 + 11: return -0.725995481f;
    case 29 * 16 + 12: return -0.856857181f;
    case 29 * 16 + 13: return -0.947653174f;
    case 29 * 16 + 14: return -0.994137943f;
    case 31 * 16 + 1: return 0.979529917f;
    case 31 * 16 + 2: return 0.918957829f;
    case 31 * 16 + 3: return 0.820763469f;
    case 31 * 16 + 4: return 0.68896693f;
    case 31 * 16 + 5: return 0.528963983f;
    case 31 * 16 + 6: return 0.347305238f;
    case 31 * 16 + 7: return 0.151427776f;
    case 31 * 16 + 8: return -0.0506491698f;
    case 31 * 16 + 9: return -0.250652522f;
    case 31 * 16 + 10: return -0.440394163f;
    case 31 * 16 + 11: return -0.612105966f;
    case 31 * 16 + 12: return -0.758758128f;
    case 31 * 16 + 13: return -0.874346614f;
    case 31 * 16 + 14: return -0.954139233f;
    case 31 * 16 + 15: return -0.994869351f;
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
    case 13 * 16 + 1: return 0.464723170f;
    case 13 * 16 + 2: return 0.822983861f;
    case 13 * 16 + 3: return 0.992708862f;
    case 13 * 16 + 4: return 0.935016215f;
    case 13 * 16 + 5: return 0.663122654f;
    case 13 * 16 + 6: return 0.239315659f;
    case 17 * 16 + 1: return 0.361241668f;
    case 17 * 16 + 2: return 0.673695624f;
    case 17 * 16 + 3: return 0.895163298f;
    case 17 * 16 + 4: return 0.995734155f;
    case 17 * 16 + 5: return 0.961825669f;
    case 17 * 16 + 6: return 0.798017204f;
    case 17 * 16 + 7: return 0.526432157f;
    case 17 * 16 + 8: return 0.183749512f;
    case 19 * 16 + 1: return 0.324699461f;
    case 19 * 16 + 2: return 0.614212692f;
    case 19 * 16 + 3: return 0.837166488f;
    case 19 * 16 + 4: return 0.969400287f;
    case 19 * 16 + 5: return 0.996584475f;
    case 19 * 16 + 6: return 0.915773332f;
    case 19 * 16 + 7: return 0.735723913f;
    case 19 * 16 + 8: return 0.475947380f;
    case 19 * 16 + 9: return 0.164594591f;
    case 23 * 16 + 1: return 0.269796759f;
    case 23 * 16 + 2: return 0.519583941f;
    case 23 * 16 + 3: return 0.730835974f;
    case 23 * 16 + 4: return 0.887885213f;
    case 23 * 16 + 5: return 0.979084074f;
    case 23 * 16 + 6: return 0.997668743f;
    case 23 * 16 + 7: return 0.942260921f;
    case 23 * 16 + 8: return 0.816969872f;
    case 23 * 16 + 9: return 0.631087959f;
    case 23 * 16 + 10: return 0.398401082f;
    case 23 * 16 + 11: return 0.136166647f;
    case 29 * 16 + 1: return 0.21497044f;
    case 29 * 16 + 2: return 0.419889092f;
    case 29 * 16 + 3: return 0.605174243f;
    case 29 * 16 + 4: return 0.76216203f;
    case 29 * 16 + 5: return 0.88351202f;
    case 29 * 16 + 6: return 0.963549972f;
    case 29 * 16 + 7: return 0.998533428f;
    case 29 * 16 + 8: return 0.986826539f;
    case 29 * 16 + 9: return 0.928976715f;
    case 29 * 16 + 10: return 0.827688992f;
    case 29 * 16 + 11: return 0.687699437f;
    case 29 * 16 + 12: return 0.515553832f;
    case 29 * 16 + 13: return 0.319301516f;
    case 29 * 16 + 14: return 0.108119018f;
    case 31 * 16 + 1: return 0.20129852f;
    case 31 * 16 + 2: return 0.394355863f;
    case 31 * 16 + 3: return 0.571268201f;
    case 31 * 16 + 4: return 0.724792778f;
    case 31 * 16 + 5: return 0.848644257f;
    case 31 * 16 + 6: return 0.937752128f;
    case 31 * 16 + 7: return 0.988468349f;
    case 31 * 16 + 8: return 0.998716533f;
    case 31 * 16 + 9: return 0.968077123f;
    case 31 * 16 + 10: return 0.897804558f;
    case 31 * 16 + 11: return 0.790775716f;
    case 31 * 16 + 12: return 0.651372492f;
    case 31 * 16 + 13: return 0.485301971f;
    case 31 * 16 + 14: return 0.299363136f;
    case 31 * 16 + 15: return 0.10116832f;
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

// odd R from 29 up: dft<R>'s sums in the same order, each output handed to
// emit(r, re, im) as soon as it is summed (dft<31> would hold 62 outputs
// beside its 60 sums). The passes store each output where dft<R>'s would go.
// The sums over n and k are unrolled by templates, not by #pragma unroll:
// at R = 31 (15 x 15 terms) nvcc left the loops rolled, the root lookups
// switches at run time and the sums in local memory (1984 = 8 * 8 * 31 read
// 3.8 ms where 1856 = 8 * 8 * 29 read 0.35, PERF.md).
template <int R, int M>
__device__ __forceinline__ float odd_cos() {
  return M <= (R - 1) / 2 ? root_cos(R, M) : root_cos(R, R - M);
}
template <int R, int M>
__device__ __forceinline__ float odd_sin() {
  return M <= (R - 1) / 2 ? root_sin(R, M) : -root_sin(R, R - M);
}

// X[K] and X[R - K] from the symmetric sums, n = 1 .. H in order
template <int R, int K, typename Emit, int... I>
__device__ __forceinline__ void odd_pair(const float* sr, const float* si, const float* dr,
                                         const float* di, float x0r, float x0i, const Emit& emit,
                                         std::integer_sequence<int, I...>) {
  float ar = x0r, ai = x0i, br = 0.0f, bi = 0.0f;
  ((ar += odd_cos<R, (I + 1) * K % R>() * sr[I], ai += odd_cos<R, (I + 1) * K % R>() * si[I],
    br += odd_sin<R, (I + 1) * K % R>() * dr[I], bi += odd_sin<R, (I + 1) * K % R>() * di[I]),
   ...);
  emit(K, ar + bi, ai - br);
  emit(R - K, ar - bi, ai + br);
}

template <int R, typename Emit, int... K>
__device__ __forceinline__ void odd_pairs(const float* sr, const float* si, const float* dr,
                                          const float* di, float x0r, float x0i,
                                          const Emit& emit, std::integer_sequence<int, K...>) {
  (odd_pair<R, K + 1>(sr, si, dr, di, x0r, x0i, emit,
                      std::make_integer_sequence<int, (R - 1) / 2>()),
   ...);
}

template <int R, typename Emit>
__device__ __forceinline__ void dft_emit(const float (&re)[R], const float (&im)[R],
                                         const Emit& emit) {
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
  emit(0, o0r, o0i);
  odd_pairs<R>(sr, si, dr, di, x0r, x0i, emit, std::make_integer_sequence<int, H>());
}

// The radices whose passes go through dft_emit
template <int R>
constexpr bool EMITS = R >= 29;
