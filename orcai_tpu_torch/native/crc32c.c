/* CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) for the TFRecord
 * framing of tf.data snapshots (orcai_tpu_torch/io/tfrecord.py).
 *
 * Every record of a snapshot shard carries the masked CRC-32C of its length
 * field and of its data; the reader checks both, so each byte converted is
 * hashed once. Slicing-by-8 over eight 256-entry tables, built on the first
 * call. The tests hold it against a bytewise table version in Python.
 */

#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

static uint32_t table[8][256];
static int table_ready = 0;

static void build_table(void) {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
  table_ready = 1;
}

/* crc32c of n bytes continuing from `crc` (0 for a fresh sum). The tables
 * are written once before any read; a second thread that races the first
 * call writes the same values. */
uint32_t orcai_crc32c(const uint8_t *p, int64_t n, uint32_t crc) {
  if (!table_ready) build_table();
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^ table[5][(lo >> 16) & 0xFF] ^
          table[4][lo >> 24] ^ table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
          table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ table[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

#ifdef __cplusplus
}
#endif
