/* LZ4 block decoder (no frame) for the blosc1 reader (io/blosc.py).
 * A copy of orcai_tpu/native/lz4dec.c. zarr-python v2 wrote blosc-lz4 by
 * default, and the pure-Python decoder runs at a few MB/s; this is the
 * standard sequence loop at memcpy speed. The Python implementation stays
 * the semantics reference and fallback.
 */

#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Returns bytes written to dst, or -1 on any malformed input. Bounds are
 * checked before every read/write, so corrupt frames fail cleanly instead
 * of overrunning (the Python caller raises on -1). */
int64_t orcai_lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t dst_cap) {
  int64_t s = 0, d = 0;
  while (s < n) {
    const uint32_t token = src[s++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (s >= n) return -1;
        b = src[s++];
        lit += b;
      } while (b == 255);
    }
    if (lit) {
      if (s + lit > n || d + lit > dst_cap) return -1;
      memcpy(dst + d, src + s, (size_t)lit);
      s += lit;
      d += lit;
    }
    if (s >= n) break; /* last sequence: literals only */
    if (s + 2 > n) return -1;
    const int64_t off = (int64_t)src[s] | ((int64_t)src[s + 1] << 8);
    s += 2;
    if (off == 0 || off > d) return -1;
    int64_t ml = token & 15;
    if (ml == 15) {
      uint8_t b;
      do {
        if (s >= n) return -1;
        b = src[s++];
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (d + ml > dst_cap) return -1;
    if (off >= ml) {
      memcpy(dst + d, dst + d - off, (size_t)ml); /* non-overlapping */
      d += ml;
    } else {
      for (int64_t i = 0; i < ml; ++i) { /* overlapping: repeat window */
        dst[d] = dst[d - off];
        ++d;
      }
    }
  }
  return d;
}

#ifdef __cplusplus
}
#endif
