/* Polyphase 3/4 rational resampler, int16 PCM in/out.
 *
 * The "spectral wire" (ops/spectral.py) resamples native-rate audio by 3/4
 * on the host before the bfp wire encode so 25% fewer bytes cross the
 * host->device link; the device frontend then runs at (3/4)*nfft and
 * (3/4)*hop, which lands on the identical spectrogram bin/time grid
 * (PERFORMANCE.md "Lower-bitrate wire candidates"). This kernel is the one
 * new host loop on that critical path: a 1-core host must resample near
 * GB/s rates or the byte saving is eaten by encode time (the same race
 * the bfp encoder in wirecodec.c won).
 *
 * Math (mirrors ops/spectral.py exactly, all integer):
 *   upsample by 3, FIR low-pass h (int16 Q15, odd length, group delay
 *   c = (n_taps-1)/2 divisible by 3 so the output has zero net delay),
 *   downsample by 4. With p = m mod 3, m = 3q + p and the phase-reversed
 *   taps hr_p[j] = h[3*(kp-1-j) + p]:
 *     y[3q+p] = round_q15( sum_j hr_p[j] * x[4q + off_p + j] ),
 *     off_p = p + c/3 - kp + 1
 *   with x zero outside [0, n_in) and round_q15(a) = (a + 16384) >> 15
 *   clamped to int16. The tap walk is CONTIGUOUS in x (the stride-4 is
 *   across outputs, not taps), so each output is a short int16 dot
 *   product. The Python tap designer bounds the per-phase L1 norm so the
 *   int32 accumulator cannot overflow even on adversarial input.
 *
 * Fast path (AVX-512BW / AVX2): vpmaddwd with the 4-tap pattern
 * [h_t h_t+1 h_t+2 h_t+3] repeated across the vector multiplies one
 * unaligned 32-int16 (resp. 16) load into partial sums for 8 (resp. 4)
 * consecutive same-phase outputs at once; int32 addition is associative
 * and commutative mod 2^32, so the lane-pair accumulation is bit-exact
 * with the ascending-tap scalar/numpy order. Builds without those ISAs
 * take the portable path (deinterleaved substreams so plain C
 * auto-vectorizes); both paths produce identical integers.
 *
 * Returns 0 on success, -1 on invalid geometry, -2 on allocation failure.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define RS_PAD 512 /* bounds taps-per-phase (and portable-path padding) */

/* bounds-checked scalar dot for outputs whose window leaves [0, n_in) */
static int16_t rs_dot_edge(const int16_t *x, int64_t n_in,
                           const int32_t *hr, int64_t kp, int64_t base)
{
    int32_t acc = 0;
    for (int64_t j = 0; j < kp; j++) {
        const int64_t i = base + j;
        if (i >= 0 && i < n_in)
            acc += hr[j] * (int32_t)x[i];
    }
    int32_t v = (acc + 16384) >> 15;
    v = v > 32767 ? 32767 : v;
    v = v < -32768 ? -32768 : v;
    return (int16_t)v;
}

#if defined(__AVX512BW__) || defined(__AVX2__)
#include <immintrin.h>

/* interior outputs [q0, q1) of one phase; every x read is in bounds */
static void rs_phase_simd(const int16_t *x, int16_t *yp, int64_t q0,
                          int64_t q1, const int16_t *hr, int64_t kpad)
{
    int64_t q = q0;
#if defined(__AVX512BW__)
    for (; q + 8 <= q1; q += 8) {
        const int16_t *bp = x + 4 * q;
        __m512i acc = _mm512_setzero_si512();
        for (int64_t t = 0; t < kpad; t += 4) {
            int64_t hbits;
            memcpy(&hbits, hr + t, 8);
            const __m512i hv = _mm512_set1_epi64(hbits);
            const __m512i xv =
                _mm512_loadu_si512((const void *)(bp + t));
            acc = _mm512_add_epi32(acc, _mm512_madd_epi16(xv, hv));
        }
        /* per qword: low dword += high dword, keep the low dwords */
        const __m512i sum =
            _mm512_add_epi32(acc, _mm512_srli_epi64(acc, 32));
        __m256i v8 = _mm512_cvtepi64_epi32(sum);
        v8 = _mm256_srai_epi32(
            _mm256_add_epi32(v8, _mm256_set1_epi32(16384)), 15);
        const __m128i p16 = _mm_packs_epi32(
            _mm256_castsi256_si128(v8), _mm256_extracti128_si256(v8, 1));
        int16_t tmp[8];
        _mm_storeu_si128((__m128i *)tmp, p16);
        int16_t *o = yp + 3 * q;
        o[0] = tmp[0];
        o[3] = tmp[1];
        o[6] = tmp[2];
        o[9] = tmp[3];
        o[12] = tmp[4];
        o[15] = tmp[5];
        o[18] = tmp[6];
        o[21] = tmp[7];
    }
#else /* __AVX2__ */
    const __m256i idx = _mm256_setr_epi32(0, 2, 4, 6, 0, 0, 0, 0);
    for (; q + 4 <= q1; q += 4) {
        const int16_t *bp = x + 4 * q;
        __m256i acc = _mm256_setzero_si256();
        for (int64_t t = 0; t < kpad; t += 4) {
            long long hbits;
            memcpy(&hbits, hr + t, 8);
            const __m256i hv = _mm256_set1_epi64x(hbits);
            const __m256i xv =
                _mm256_loadu_si256((const __m256i *)(bp + t));
            acc = _mm256_add_epi32(acc, _mm256_madd_epi16(xv, hv));
        }
        const __m256i sum =
            _mm256_add_epi32(acc, _mm256_srli_epi64(acc, 32));
        /* low dwords of the 4 qwords -> lanes 0..3 */
        __m128i v4 = _mm256_castsi256_si128(
            _mm256_permutevar8x32_epi32(sum, idx));
        v4 = _mm_srai_epi32(_mm_add_epi32(v4, _mm_set1_epi32(16384)), 15);
        const __m128i p16 = _mm_packs_epi32(v4, v4);
        int16_t tmp[8];
        _mm_storeu_si128((__m128i *)tmp, p16);
        int16_t *o = yp + 3 * q;
        o[0] = tmp[0];
        o[3] = tmp[1];
        o[6] = tmp[2];
        o[9] = tmp[3];
    }
#endif
    /* leftover interior outputs: scalar over the same reversed taps */
    for (; q < q1; q++) {
        const int16_t *bp = x + 4 * q;
        int32_t acc = 0;
        for (int64_t j = 0; j < kpad; j++)
            acc += (int32_t)hr[j] * (int32_t)bp[j];
        int32_t v = (acc + 16384) >> 15;
        v = v > 32767 ? 32767 : v;
        v = v < -32768 ? -32768 : v;
        yp[3 * q] = (int16_t)v;
    }
}

static int64_t rs_run(const int16_t *x, int64_t n_in, const int16_t *taps,
                      int64_t n_taps, int16_t *y, int64_t n_out)
{
    const int64_t c3 = ((n_taps - 1) / 2) / 3;
    int32_t hr32[RS_PAD];
    int16_t hr16[RS_PAD + 8];

    for (int p = 0; p < 3; p++) {
        const int64_t kp = (n_taps - 1 - p) / 3 + 1;
        const int64_t nq = (n_out - p + 2) / 3;
        if (nq <= 0)
            continue;
        const int64_t kpad = (kp + 3) & ~(int64_t)3;
        memset(hr16, 0, sizeof(int16_t) * (size_t)(kpad + 8));
        for (int64_t j = 0; j < kp; j++) {
            hr16[j] = taps[3 * (kp - 1 - j) + p];
            hr32[j] = hr16[j];
        }
        const int64_t off = p + c3 - kp + 1;
        /* interior: window start 4q+off >= 0 and the widest vector load
         * (kpad - 4 + 31 int16 past the window base) stays below n_in */
        int64_t q_lo = off >= 0 ? 0 : (-off + 3) / 4;
        int64_t q_hi = (n_in - off - kpad - 28) / 4 + 1; /* exclusive */
        if (q_lo > nq)
            q_lo = nq;
        if (q_hi > nq)
            q_hi = nq;
        if (q_hi < q_lo)
            q_hi = q_lo;
        for (int64_t q = 0; q < q_lo; q++)
            y[3 * q + p] = rs_dot_edge(x, n_in, hr32, kp, 4 * q + off);
        rs_phase_simd(x + off, y + p, q_lo, q_hi, hr16, kpad);
        for (int64_t q = q_hi; q < nq; q++)
            y[3 * q + p] = rs_dot_edge(x, n_in, hr32, kp, 4 * q + off);
    }
    return 0;
}

#else /* portable: deinterleaved substreams, plain auto-vectorizable C */

static int64_t rs_run(const int16_t *x, int64_t n_in, const int16_t *taps,
                      int64_t n_taps, int16_t *y, int64_t n_out)
{
    const int64_t c3 = ((n_taps - 1) / 2) / 3;
    int64_t npad = n_in + 2 * RS_PAD;
    npad += (4 - (npad & 3)) & 3;
    const int64_t nsub = npad / 4;
    int16_t *xz = (int16_t *)calloc((size_t)npad, sizeof(int16_t));
    int16_t *sub = (int16_t *)malloc((size_t)npad * sizeof(int16_t));
    if (!xz || !sub) {
        free(xz);
        free(sub);
        return -2;
    }
    memcpy(xz + RS_PAD, x, (size_t)n_in * sizeof(int16_t));
    for (int64_t k = 0; k < nsub; k++) {
        sub[0 * nsub + k] = xz[4 * k + 0];
        sub[1 * nsub + k] = xz[4 * k + 1];
        sub[2 * nsub + k] = xz[4 * k + 2];
        sub[3 * nsub + k] = xz[4 * k + 3];
    }

    enum { B = 2048 };
    int32_t acc[B];
    int32_t hr[RS_PAD];
    const int16_t *sp[RS_PAD];

    for (int p = 0; p < 3; p++) {
        const int64_t kp = (n_taps - 1 - p) / 3 + 1;
        const int64_t nq = (n_out - p + 2) / 3;
        if (nq <= 0)
            continue;
        if (4 * (nq - 1) + p + c3 + RS_PAD >= npad) {
            free(xz);
            free(sub);
            return -1;
        }
        for (int64_t j = 0; j < kp; j++) {
            hr[j] = taps[3 * (kp - 1 - j) + p];
            /* xz index at q=0 for tap j (>= 0 by the RS_PAD bound) */
            const int64_t a = p + c3 - kp + 1 + j + RS_PAD;
            sp[j] = sub + (a & 3) * nsub + (a >> 2);
        }
        for (int64_t q0 = 0; q0 < nq; q0 += B) {
            const int bn = (int)((nq - q0) < B ? (nq - q0) : B);
            memset(acc, 0, (size_t)bn * sizeof(int32_t));
            for (int64_t j = 0; j < kp; j++) {
                const int32_t h = hr[j];
                const int16_t *s = sp[j] + q0;
                for (int b = 0; b < bn; b++)
                    acc[b] += h * (int32_t)s[b];
            }
            for (int b = 0; b < bn; b++) {
                int32_t v = (acc[b] + 16384) >> 15;
                v = v > 32767 ? 32767 : v;
                v = v < -32768 ? -32768 : v;
                y[3 * (q0 + b) + p] = (int16_t)v;
            }
        }
    }
    free(xz);
    free(sub);
    return 0;
}
#endif

/* Generic rational L/M polyphase (the sp11 wire's 11/16; any gcd(L,M)=1
 * ratio the Python designer emits). Unlike the tuned 3/4 kernel above,
 * each output's tap window is walked CONTIGUOUSLY in the padded input
 * (output phase p uses prototype taps (p*M) mod L :: L against the window
 * starting at M*q + (p*M)/L — the standard rational-polyphase identity,
 * which the specialized kernel's p/p split is the L=3, M=4 instance of),
 * so the inner loop is a plain int16 dot product that auto-vectorizes
 * under -O3 -march=native. Bit-exact with ops/spectral.py's
 * _resample_poly_numpy: same padding, same tap order per product, and
 * int32 wrap-around addition is order-independent (the designer bounds
 * each phase's L1 norm so the accumulator never exceeds int32 anyway). */
static int64_t rs_poly_run(const int16_t *x, int64_t n_in,
                           const int16_t *taps, int64_t n_taps,
                           int64_t L, int64_t M, int16_t *y, int64_t n_out)
{
    const int64_t cl = ((n_taps - 1) / 2) / L;
    /* +32 zeros past the nominal right pad: the SIMD dot reads hr and x
     * in whole vectors, up to 31 int16 past the last real tap — the taps
     * there are zero, so the products contribute nothing */
    const int64_t npad = n_in + 2 * RS_PAD + 32;
    const int64_t hstride = RS_PAD + 32;
    int16_t *xz = (int16_t *)calloc((size_t)npad, sizeof(int16_t));
    int16_t *hr = (int16_t *)calloc((size_t)(L * hstride), sizeof(int16_t));
    if (!xz || !hr) {
        free(xz);
        free(hr);
        return -2;
    }
    memcpy(xz + RS_PAD, x, (size_t)n_in * sizeof(int16_t));

    /* per-phase reversed taps + geometry, precomputed once */
    int64_t kpads[64], nqs[64], offs[64];
    int64_t nq_max = 0;
    for (int64_t p = 0; p < L; p++) {
        const int64_t tap_off = (p * M) % L;
        const int64_t x_base = (p * M) / L;
        const int64_t kp = (n_taps - 1 - tap_off) / L + 1;
        const int64_t nq = (n_out - p + L - 1) / L;
        nqs[p] = nq;
        if (nq <= 0)
            continue;
        if (M * (nq - 1) + x_base + cl + RS_PAD >= n_in + 2 * RS_PAD) {
            free(xz);
            free(hr);
            return -1;
        }
        kpads[p] = (kp + 31) & ~(int64_t)31;
        offs[p] = x_base + cl - kp + 1 + RS_PAD;
        int16_t *hp = hr + p * hstride;
        for (int64_t j = 0; j < kp; j++)
            hp[j] = taps[L * (kp - 1 - j) + tap_off];
        if (nq > nq_max)
            nq_max = nq;
    }

    /* Output-blocked over q so all L phases walk the SAME cache-resident
     * input slab: a phase-major sweep would stream the whole padded input
     * from DRAM L times (measured: that memory wall capped the kernel at
     * ~280 MB/s for L=11 regardless of the SIMD inside). QB * M int16 of
     * input per block ~= 256 KB, comfortably L2-resident. */
    enum { QB = 8192 };
    for (int64_t q0 = 0; q0 < nq_max; q0 += QB) {
        for (int64_t p = 0; p < L; p++) {
            const int64_t q1 = nqs[p] < q0 + QB ? nqs[p] : q0 + QB;
            if (q0 >= q1)
                continue;
            const int64_t kpad = kpads[p];
            const int64_t off = offs[p];
            const int16_t *hp = hr + p * hstride;
            /* pmaddwd dots, 4 outputs in flight so the accumulator chains
             * overlap. Pair products can't saturate (|tap| <= ~0.69 *
             * 32768 by the designer's gain, so |pair sum| < 2^31), int32
             * lane totals are bounded by the designer's per-phase L1
             * check, and int32 wrap-around addition is order-independent,
             * so every path below returns the same integer as the scalar
             * ascending-tap loop. */
            int64_t q = q0;
#if defined(__AVX512BW__)
            for (; q + 4 <= q1; q += 4) {
                const int16_t *s = xz + M * q + off;
                __m512i a0 = _mm512_setzero_si512(), a1 = a0, a2 = a0,
                        a3 = a0;
                for (int64_t j = 0; j < kpad; j += 32) {
                    const __m512i hv =
                        _mm512_loadu_si512((const void *)(hp + j));
                    a0 = _mm512_add_epi32(a0, _mm512_madd_epi16(hv,
                        _mm512_loadu_si512((const void *)(s + j))));
                    a1 = _mm512_add_epi32(a1, _mm512_madd_epi16(hv,
                        _mm512_loadu_si512((const void *)(s + M + j))));
                    a2 = _mm512_add_epi32(a2, _mm512_madd_epi16(hv,
                        _mm512_loadu_si512((const void *)(s + 2 * M + j))));
                    a3 = _mm512_add_epi32(a3, _mm512_madd_epi16(hv,
                        _mm512_loadu_si512((const void *)(s + 3 * M + j))));
                }
                const int32_t accs[4] = {
                    _mm512_reduce_add_epi32(a0),
                    _mm512_reduce_add_epi32(a1),
                    _mm512_reduce_add_epi32(a2),
                    _mm512_reduce_add_epi32(a3),
                };
                for (int b = 0; b < 4; b++) {
                    int32_t v = (accs[b] + 16384) >> 15;
                    v = v > 32767 ? 32767 : v;
                    v = v < -32768 ? -32768 : v;
                    y[L * (q + b) + p] = (int16_t)v;
                }
            }
#elif defined(__AVX2__)
            for (; q + 4 <= q1; q += 4) {
                const int16_t *s = xz + M * q + off;
                __m256i a0 = _mm256_setzero_si256(), a1 = a0, a2 = a0,
                        a3 = a0;
                for (int64_t j = 0; j < kpad; j += 16) {
                    const __m256i hv =
                        _mm256_loadu_si256((const __m256i *)(hp + j));
                    a0 = _mm256_add_epi32(a0, _mm256_madd_epi16(hv,
                        _mm256_loadu_si256((const __m256i *)(s + j))));
                    a1 = _mm256_add_epi32(a1, _mm256_madd_epi16(hv,
                        _mm256_loadu_si256((const __m256i *)(s + M + j))));
                    a2 = _mm256_add_epi32(a2, _mm256_madd_epi16(hv,
                        _mm256_loadu_si256((const __m256i *)(s + 2 * M + j))));
                    a3 = _mm256_add_epi32(a3, _mm256_madd_epi16(hv,
                        _mm256_loadu_si256((const __m256i *)(s + 3 * M + j))));
                }
                const __m256i accv[4] = {a0, a1, a2, a3};
                for (int b = 0; b < 4; b++) {
                    __m128i v128 = _mm_add_epi32(
                        _mm256_castsi256_si128(accv[b]),
                        _mm256_extracti128_si256(accv[b], 1));
                    v128 = _mm_add_epi32(v128,
                                         _mm_shuffle_epi32(v128, 0x4e));
                    v128 = _mm_add_epi32(v128,
                                         _mm_shuffle_epi32(v128, 0xb1));
                    int32_t v = (_mm_cvtsi128_si32(v128) + 16384) >> 15;
                    v = v > 32767 ? 32767 : v;
                    v = v < -32768 ? -32768 : v;
                    y[L * (q + b) + p] = (int16_t)v;
                }
            }
#endif
            for (; q < q1; q++) {
                const int16_t *s = xz + M * q + off;
                int32_t acc = 0;
                for (int64_t j = 0; j < kpad; j++)
                    acc += (int32_t)hp[j] * (int32_t)s[j];
                int32_t v = (acc + 16384) >> 15;
                v = v > 32767 ? 32767 : v;
                v = v < -32768 ? -32768 : v;
                y[L * q + p] = (int16_t)v;
            }
        }
    }
    free(xz);
    free(hr);
    return 0;
}

#ifdef __cplusplus
extern "C" {
#endif

int64_t orcai_resample_poly(const int16_t *x, int64_t n_in,
                            const int16_t *taps, int64_t n_taps,
                            int64_t L, int64_t M,
                            int16_t *y, int64_t n_out)
{
    if (n_in < 0 || n_out < 0 || n_taps < 1 || (n_taps & 1) == 0)
        return -1;
    /* L bounds the per-phase stack arrays in rs_poly_run (kpads/nqs/offs
     * are 64 entries); any useful grid-preserving ratio is far below it */
    if (L < 1 || L > 64 || M <= L)
        return -1;
    const int64_t c = (n_taps - 1) / 2;
    if (c % L)
        return -1;
    if ((n_taps + L - 1) / L + 8 > RS_PAD || c / L + 8 > RS_PAD)
        return -1;
    if (n_out > L * n_in / M + L)
        return -1;
    if (n_out == 0)
        return 0;
    return rs_poly_run(x, n_in, taps, n_taps, L, M, y, n_out);
}

int64_t orcai_resample34(const int16_t *x, int64_t n_in,
                         const int16_t *taps, int64_t n_taps,
                         int16_t *y, int64_t n_out)
{
    if (n_in < 0 || n_out < 0 || n_taps < 1 || (n_taps & 1) == 0)
        return -1;
    const int64_t c = (n_taps - 1) / 2;
    if (c % 3)
        return -1;
    if ((n_taps + 2) / 3 + 8 > RS_PAD || c / 3 + 8 > RS_PAD)
        return -1;
    if (n_out > 3 * n_in / 4 + 3)
        return -1;
    if (n_out == 0)
        return 0;
    return rs_run(x, n_in, taps, n_taps, y, n_out);
}

#ifdef __cplusplus
}
#endif
