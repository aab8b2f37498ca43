/* LZ4 block encoder (no frame) for the blosc1 writer (io/blosc.py).
 * A copy of orcai_tpu/native/lz4enc.c. gzip at level 5 runs at 10-20 MB/s
 * on one host core, so writing the float32 spectrogram stores of
 * `create-spectrograms` through it takes seconds per recording; this is
 * the standard greedy hash-table LZ4 compressor (with LZ4-style
 * acceleration skipping on incompressible input) at a few hundred MB/s.
 * blosc-lz4 is also what zarr-python v2 wrote by default.
 *
 * Contract: any spec-conformant LZ4 block is acceptable. This encoder and
 * the Python fallback in io/blosc.py are round-trip-equal, not byte-equal;
 * both decoders invert both encoders. The output is byte-equal to the JAX
 * package's C encoder, which is the same source.
 */

#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

#define MAX_HASH_LOG 16
#define SKIP_TRIGGER 6 /* like reference LZ4: accelerate on no-match runs */

static inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint32_t hash4(uint32_t v, int shift) {
  return (v * 2654435761u) >> shift;
}

/* Returns bytes written to dst, or -1 when dst_cap is too small (caller
 * sizes dst at n + n/255 + 16, so -1 only means a mis-sized buffer). */
int64_t orcai_lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t dst_cap) {
  /* Scale the table to the input: blosc splits 128 KB blocks into
   * typesize 32 KB sub-streams, and a fixed 64K-entry int64 table costs
   * 512 KB of zeroing per call — 16x the payload in pure init overhead.
   * int32 entries (inputs here are << 2 GB) + a log sized so the table
   * never exceeds the input keep init amortized; positions are stored
   * +1 so memset(0) means "empty". */
  if (n > 0x7ffffff0) return -1; /* int32 position table; chunks are small */
  int hash_log = MAX_HASH_LOG;
  while (hash_log > 8 && ((int64_t)1 << hash_log) > n) --hash_log;
  const int shift = 32 - hash_log;
  int32_t table[1 << MAX_HASH_LOG];
  memset(table, 0, sizeof(int32_t) << hash_log);

  int64_t d = 0, anchor = 0, i = 0;
  const int64_t limit = n - 12;      /* matches may not start here or later */
  const int64_t match_limit = n - 5; /* matches must end 5 bytes before end */
  uint32_t search_count = 1 << SKIP_TRIGGER;

  while (i < limit) {
    const uint32_t key = read32(src + i);
    const uint32_t h = hash4(key, shift);
    const int64_t j = (int64_t)table[h] - 1; /* 0 = empty slot */
    table[h] = (int32_t)(i + 1);
    if (j >= 0 && i - j <= 65535 && read32(src + j) == key) {
      /* extend the match */
      int64_t mlen = 4;
      const int64_t max_len = match_limit - i;
      while (mlen < max_len && src[j + mlen] == src[i + mlen]) ++mlen;

      /* emit literals [anchor, i) + match */
      const int64_t lit = i - anchor;
      const int64_t ml = mlen - 4;
      /* worst-case bytes for this sequence */
      if (d + 1 + lit / 255 + 1 + lit + 2 + ml / 255 + 1 > dst_cap) return -1;
      const int64_t token_pos = d++;
      uint8_t token = (uint8_t)((lit < 15 ? lit : 15) << 4);
      if (lit >= 15) {
        int64_t rem = lit - 15;
        while (rem >= 255) {
          dst[d++] = 255;
          rem -= 255;
        }
        dst[d++] = (uint8_t)rem;
      }
      memcpy(dst + d, src + anchor, (size_t)lit);
      d += lit;
      const int64_t off = i - j;
      dst[d++] = (uint8_t)(off & 0xFF);
      dst[d++] = (uint8_t)(off >> 8);
      if (ml < 15) {
        token |= (uint8_t)ml;
      } else {
        token |= 15;
        int64_t rem = ml - 15;
        while (rem >= 255) {
          dst[d++] = 255;
          rem -= 255;
        }
        dst[d++] = (uint8_t)rem;
      }
      dst[token_pos] = token;

      i += mlen;
      anchor = i;
      search_count = 1 << SKIP_TRIGGER;
    } else {
      /* accelerate through incompressible regions: every SKIP_TRIGGER
       * misses the step grows by one, exactly bounding worst-case work */
      i += (int64_t)(search_count++ >> SKIP_TRIGGER);
    }
  }

  /* trailing literals [anchor, n) */
  const int64_t lit = n - anchor;
  if (d + 1 + lit / 255 + 1 + lit > dst_cap) return -1;
  uint8_t token = (uint8_t)((lit < 15 ? lit : 15) << 4);
  dst[d++] = token;
  if (lit >= 15) {
    int64_t rem = lit - 15;
    while (rem >= 255) {
      dst[d++] = 255;
      rem -= 255;
    }
    dst[d++] = (uint8_t)rem;
  }
  memcpy(dst + d, src + anchor, (size_t)lit);
  d += lit;
  return d;
}

#ifdef __cplusplus
}
#endif
