/* Host wire-codec encoders (see orcai_tpu_torch/ops/wire_codec.py).
 *
 * The mu-law LUT walk and the block-floating-point encode, a copy of the
 * reference package's C encoders. The bfp encode sits on the predict path
 * of a coded wire, and its numpy form runs at tens of MB/s on one core;
 * this loop runs at hundreds. Built at first use by orcai_tpu_torch.native
 * with the host C compiler; the numpy implementations stay as the
 * semantics and the fallback, and the tests hold the two bit-equal.
 */

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* int16 PCM -> 8-bit mu-law codes via the caller-provided 65536-entry LUT
 * (the LUT is built in Python as the nearest-reconstruction inverse of the
 * decode table; sharing it keeps the two paths identical by construction). */
void orcai_mulaw_encode(const int16_t *x, int64_t n, const uint8_t *lut,
                        uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) out[i] = lut[(uint16_t)x[i]];
}

/* Block-floating-point encode: n_blocks blocks of 128 int16 samples ->
 * bit-packed two's-complement mantissas + one shift byte per block.
 * Bit-exact with wire_codec.bfp_encode: per block the shift is the smallest
 * s with (max |x| >> s) < 2^(mant_bits-1); mantissas are round-half-up
 * ((x + (1<<s)/2) >> s, arithmetic shift = floor) then clipped.
 * packed must hold n_blocks * (mant_bits==6 ? 96 : 80) bytes. */
void orcai_bfp_encode(const int16_t *x, int64_t n_blocks, int32_t mant_bits,
                      uint8_t *packed, uint8_t *shifts) {
  const int32_t half = 1 << (mant_bits - 1);
  const int32_t mask = (1 << mant_bits) - 1;
  const int block_bytes = (mant_bits == 6) ? 96 : 80;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const int16_t *xb = x + blk * 128;
    int32_t peak = 0;
    for (int i = 0; i < 128; ++i) {
      int32_t a = xb[i];
      a = a < 0 ? -a : a;
      peak = a > peak ? a : peak;
    }
    int32_t s = 0;
    while ((peak >> s) >= half) ++s;
    shifts[blk] = (uint8_t)s;
    const int32_t rnd = (1 << s) >> 1;
    int32_t q[128];
    for (int i = 0; i < 128; ++i) {
      int32_t v = ((int32_t)xb[i] + rnd) >> s; /* arithmetic shift: floor */
      v = v < -half ? -half : v;
      v = v > half - 1 ? half - 1 : v;
      q[i] = v & mask;
    }
    uint8_t *ob = packed + blk * block_bytes;
    if (mant_bits == 6) {
      /* 4 codes -> 3 bytes, little-endian bit order (wire_codec._pack_np) */
      for (int gi = 0; gi < 32; ++gi) {
        const int32_t *c = q + gi * 4;
        uint8_t *o = ob + gi * 3;
        o[0] = (uint8_t)(c[0] | (c[1] << 6));
        o[1] = (uint8_t)((c[1] >> 2) | (c[2] << 4));
        o[2] = (uint8_t)((c[2] >> 4) | (c[3] << 2));
      }
    } else {
      /* 8 codes -> 5 bytes */
      for (int gi = 0; gi < 16; ++gi) {
        const int32_t *c = q + gi * 8;
        uint8_t *o = ob + gi * 5;
        o[0] = (uint8_t)(c[0] | (c[1] << 5));
        o[1] = (uint8_t)((c[1] >> 3) | (c[2] << 2) | (c[3] << 7));
        o[2] = (uint8_t)((c[3] >> 1) | (c[4] << 4));
        o[3] = (uint8_t)((c[4] >> 4) | (c[5] << 1) | (c[6] << 6));
        o[4] = (uint8_t)((c[6] >> 2) | (c[7] << 3));
      }
    }
  }
}

#ifdef __cplusplus
}
#endif
