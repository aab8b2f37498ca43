// Batched FFTs in shared memory, the loads that feed them and the untangle's
// bin writer, shared by csrc/dft_cluster.cu and csrc/dft_staged.cu: both run
// the four-step split of a frame pair's FFT, N = N1 * N2, as batches of
// N1-point and N2-point FFTs with one Stockham pass per radix of
// ops/dft.py::fft_plan (dft_butterflies.cuh's butterflies). A batch lies
// element-major, element e of FFT b at e * stride + b with an odd stride, so
// a warp's butterflies read and write consecutive words and strided
// accesses fall on distinct banks; the roots are the same across the batch
// (broadcasts), in pass order (ops/dft.py::pass_roots). Included in an
// anonymous namespace after dft_butterflies.cuh, with ORCAI_RADIX_CASES
// defined: the radices the including build's kernels take.

#pragma once

#include "dft_side.cuh"

__device__ __forceinline__ float2 cmul(float2 v, float2 w) {
  return make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
}

// The four-step twiddle W_N^m for m < N from its two tables of float64
// roots (ops/dft.py::twiddle_tables, in shared memory): hi[m >> s] * lo[m &
// (2^s - 1)] in float64 with no fused multiply-add, as ops/dft.py::
// product_twiddles computes it, rounded once
__device__ __forceinline__ float2 twiddle(const double2* lo, const double2* hi, int s, int m) {
  const double2 a = hi[m >> s], b = lo[m & ((1 << s) - 1)];
  const double re = __dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y));
  const double im = __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x));
  return make_float2(__double2float_rn(re), __double2float_rn(im));
}

// The product of a value and its twiddle, v w, with each fused multiply-add
// spelled out: re = fma(v.x, w.x, -(v.y w.y)), im = fma(v.x, w.y, v.y w.x),
// as nvcc fused it when the kernels read their twiddles from a table in
// device memory, so that the outputs keep those bits and no contraction the
// compiler chooses from the code around it moves one
__device__ __forceinline__ float2 twiddled(float2 v, float2 w) {
  return make_float2(__fmaf_rn(v.x, w.x, -__fmul_rn(v.y, w.y)),
                     __fmaf_rn(v.x, w.y, __fmul_rn(v.y, w.x)));
}

// A thread's walk over the items f = tid, tid + nthreads, ... of an
// outer x inner grid as (o, i) = (f / inner, f % inner), stepped without a
// division in the loop.
struct Walk {
  int o, i, d_o, d_i, inner;
  __device__ __forceinline__ Walk(int tid, int nthreads, int inner_)
      : o(tid / inner_), i(tid % inner_), d_o(nthreads / inner_), d_i(nthreads % inner_),
        inner(inner_) {}
  // returns true when the inner index wrapped, so o took one more step
  __device__ __forceinline__ bool step() {
    i += d_i;
    o += d_o;
    if (i < inner) return false;
    i -= inner;
    ++o;
    return true;
  }
};

// The first pass of `batch` FFTs of n points (Ns = 1, no roots): butterfly
// j of FFT b reads elements j + r*n/R through load(e, b) and writes element
// j*R + r at (j*R + r) * stride + b.
template <int R, typename Load>
__device__ __forceinline__ void first_pass(const Load& load, float2* dst, int stride, int batch,
                                           int n, int tid, int nthreads) {
  const int nb = n / R;
  for (Walk w(tid, nthreads, batch); w.o < nb; w.step()) {
    const int j = w.o, b = w.i;
    float re[R], im[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = load(j + r * nb, b);
      re[r] = v.x;
      im[r] = v.y;
    }
    if constexpr (EMITS<R>) {
      dft_emit(re, im, [&](int r, float x, float y) {
        dst[(j * R + r) * stride + b] = make_float2(x, y);
      });
    } else {
      dft(re, im);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[(j * R + r) * stride + b] = make_float2(re[r], im[r]);
    }
  }
}

// a later pass: butterfly j reads elements j + r*n/R, multiplies by the
// roots at tw[(r - 1)*Ns + j % Ns] and writes element (j / Ns)*Ns*R + j % Ns
// + r*Ns, every FFT of the batch alike
template <int R>
__device__ __forceinline__ void pass(const float2* src, float2* dst, int stride, int batch,
                                     const float2* tw, int n, int ns, int tid, int nthreads) {
  const int nb = n / R;
  Walk w(tid, nthreads, batch);
  int q = w.o / ns, jm = w.o % ns;  // j / Ns and j % Ns, stepped with j
  const int dq = w.d_o / ns, djm = w.d_o % ns;
  while (w.o < nb) {
    const int j = w.o, b = w.i;
    float re[R], im[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = src[(j + r * nb) * stride + b];
      re[r] = v.x;
      im[r] = v.y;
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 t = tw[(r - 1) * ns + jm];
      const float vr = re[r] * t.x - im[r] * t.y;
      const float vi = re[r] * t.y + im[r] * t.x;
      re[r] = vr;
      im[r] = vi;
    }
    const int base = q * ns * R + jm;
    if constexpr (EMITS<R>) {
      dft_emit(re, im, [&](int r, float x, float y) {
        dst[(base + r * ns) * stride + b] = make_float2(x, y);
      });
    } else {
      dft(re, im);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[(base + r * ns) * stride + b] = make_float2(re[r], im[r]);
    }
    jm += djm + w.step();
    q += dq;
    if (jm >= ns) {
      jm -= ns;
      ++q;
    }
  }
}

// `batch` FFTs of side.n points, element e of FFT b at e * stride + b. The
// first pass reads through `load` and writes `first`; the later passes
// alternate between the two buffers. Returns the buffer that holds the
// result, in natural order.
template <typename Load>
__device__ __forceinline__ float2* batched_fft(const Load& load, float2* first, float2* second,
                                               const float2* tw, const Side& side, int stride,
                                               int batch, int tid, int nthreads) {
  switch (side.radix[0]) {
#define ORCAI_FIRST(R) first_pass<R>(load, first, stride, batch, side.n, tid, nthreads)
    ORCAI_RADIX_CASES(ORCAI_FIRST)
#undef ORCAI_FIRST
  }
  __syncthreads();
  float2* src = first;
  float2* dst = second;
  for (int p = 1; p < side.n_passes; ++p) {
    const float2* twp = tw + side.tw_off + side.pass_off[p];
    const int ns = side.ns[p];
    switch (side.radix[p]) {
#define ORCAI_PASS(R) pass<R>(src, dst, stride, batch, twp, side.n, ns, tid, nthreads)
      ORCAI_RADIX_CASES(ORCAI_PASS)
#undef ORCAI_PASS
    }
    __syncthreads();
    float2* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// element n1 of column c0 + b: sample n = n2 * n1 + c0 + b of the two
// frames as one windowed complex signal, z = w x_t + i w x_t+1 (a phantom
// second frame of an odd count is zeros)
template <typename T>
struct PairColumns {
  const T* xa;
  const T* xb;
  bool has_b;
  const float* win;
  int n2, c0;
  __device__ __forceinline__ float2 operator()(int e, int b) const {
    const int n = e * n2 + c0 + b;
    const float w = win[n];
    return make_float2(w * sample_to_f32(xa[n]), has_b ? w * sample_to_f32(xb[n]) : 0.0f);
  }
};

// the chirp mode's input: z = (w a)[n] (x_t + i x_t+1)[n] for n < n_fft,
// zero up to M
template <typename T>
struct ChirpColumns {
  const T* xa;
  const T* xb;
  bool has_b;
  const float2* wa;
  int n_fft, n2, c0;
  __device__ __forceinline__ float2 operator()(int e, int b) const {
    const int n = e * n2 + c0 + b;
    if (n >= n_fft) return make_float2(0.0f, 0.0f);
    const float2 c = wa[n];
    const float u = sample_to_f32(xa[n]), v = has_b ? sample_to_f32(xb[n]) : 0.0f;
    return make_float2(c.x * u - c.y * v, c.x * v + c.y * u);
  }
};

// a batch already in shared memory in the layout of `stride`
struct Local {
  const float2* z;
  int stride;
  __device__ __forceinline__ float2 operator()(int e, int b) const { return z[e * stride + b]; }
};

// the chirp mode's product, conjugated: conj(Y[m] B[m]) for m = k1 + n1 k2,
// Y the first FFT's output (local row b of row k1 = rows_k1[b], element
// k2), B = FFT_M(b) / M
struct Product {
  const float2* y;
  int stride;
  const float2* bq;
  const unsigned short* rows_k1;
  int n1;
  __device__ __forceinline__ float2 operator()(int e, int b) const {
    const float2 v = y[e * stride + b], w = bq[rows_k1[b] + n1 * e];
    return make_float2(v.x * w.x - v.y * w.y, -(v.x * w.y + v.y * w.x));
  }
};

// the magnitude rows of frames t and t + 1 at bin k from Z[k] and the mirror
// Z[(N-k) % N]
__device__ __forceinline__ void write_bin(float* row_a, int n_bins, bool has_b, int k,
                                          float2 za, float2 zy) {
  const float pr = za.x + zy.x, pi = za.y - zy.y;  // 2 X_t[k]
  const float qr = za.y + zy.y, qi = za.x - zy.x;  // 2 |X_t+1[k]| parts
  row_a[k] = 0.5f * sqrtf(pr * pr + pi * pi);
  if (has_b) row_a[n_bins + k] = 0.5f * sqrtf(qr * qr + qi * qi);
}

