/* f32 -> u8/u16 linear quantizers for the evaluation upload
 * (orcai_tpu_torch/train/evaluate.py::quantize_eval_upload).
 *
 * `test` with ORCAI_TPU_EVAL_UPLOAD=u8 or u16 stages the [0, 1]
 * min-max-normalized test spectrograms as integer codes, a 4x or 2x
 * smaller host->device copy. The numpy chain (multiply, rint, clip,
 * astype) makes four passes over a slab; this is one. Semantics are
 * exactly numpy's: the float32 product, round-half-to-even (nearbyintf
 * under the default rounding mode, which is np.rint), clip to [0, scale].
 * The tests hold the two bit-equal.
 *
 * A copy of orcai_tpu/native/quant.c.
 */

#include <math.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

void orcai_quant_u8(const float *x, int64_t n, uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = nearbyintf(x[i] * 255.0f);
    v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    out[i] = (uint8_t)v;
  }
}

void orcai_quant_u16(const float *x, int64_t n, uint16_t *out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = nearbyintf(x[i] * 65535.0f);
    v = v < 0.0f ? 0.0f : (v > 65535.0f ? 65535.0f : v);
    out[i] = (uint16_t)v;
  }
}

#ifdef __cplusplus
}
#endif
