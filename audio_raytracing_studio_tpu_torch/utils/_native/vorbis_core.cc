// Native hot loops for the Ogg/Vorbis codec (utils/vorbisenc.py /
// vorbisio.py).
//
// The port's copy of the JAX package's file, built at first use by
// utils/kernels.build_host and bound by utils/_native_vorbis.py.

#include <cstdint>

extern "C" {

// LSB-first bit packer: item i contributes the low nbits[i] bits of
// values[i], in order.  `out` must be zeroed and sized (sum(nbits)+7)/8.
// Returns the total number of bits written.
int64_t vorbis_pack_lsb(const int32_t* values, const uint8_t* nbits,
                        int64_t n, uint8_t* out) {
  uint64_t acc = 0;
  int navail = 0;
  int64_t bytepos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int nb = nbits[i];
    if (nb == 0) continue;
    acc |= ((uint64_t)(uint32_t)values[i] & ((nb >= 32) ? 0xFFFFFFFFu
                                                        : ((1u << nb) - 1u)))
           << navail;
    navail += nb;
    while (navail >= 8) {
      out[bytepos++] = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      navail -= 8;
    }
  }
  if (navail > 0) out[bytepos++] = (uint8_t)(acc & 0xFF);
  return bytepos * 8 - ((8 - navail) & 7);
}

// Decode `count` VQ entries through a stream-order fast table (packed as
// (entry << 6) | codelen, -1 = miss) and write each entry's `dims`
// reconstruction floats consecutively into `out`.  LSB-first reads from
// `data` starting at absolute bit `bitpos`.  Returns the new bit position,
// or -1 on a fast-table miss / packet exhaustion (caller falls back to the
// Python path from the original position; `out` is scratch).
int64_t vorbis_vq_run(const uint8_t* data, int64_t nbytes, int64_t bitpos,
                      const int64_t* fast, int32_t fast_bits,
                      const float* vectors, int32_t dims, int64_t count,
                      float* out) {
  const int64_t nbits_total = nbytes * 8;
  uint64_t acc = 0;
  int navail = 0;
  int64_t bytepos = bitpos >> 3;
  const int drop = (int)(bitpos & 7);
  if (bytepos < nbytes) {
    acc = (uint64_t)(data[bytepos++] >> drop);
    navail = 8 - drop;
  }
  const uint64_t mask = (1u << fast_bits) - 1u;
  for (int64_t i = 0; i < count; ++i) {
    while (navail < fast_bits && bytepos < nbytes)
      acc |= (uint64_t)data[bytepos++] << navail, navail += 8;
    const int64_t hit = fast[acc & mask];
    if (hit < 0) return -1;  // slow-path code (or not enough bits to tell)
    const int len = (int)(hit & 63);
    if (len > navail) return -1;  // packet exhausted mid-codeword
    acc >>= len;
    navail -= len;
    const float* v = vectors + (hit >> 6) * dims;
    for (int32_t d = 0; d < dims; ++d) *out++ = v[d];
  }
  return bytepos * 8 - navail;
}

// Ogg page CRC: poly 0x04C11DB7, init 0, no reflection, no final xor.
uint32_t vorbis_ogg_crc(const uint8_t* data, int64_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i << 24;
      for (int j = 0; j < 8; ++j)
        r = (r & 0x80000000u) ? (r << 1) ^ 0x04C11DB7u : (r << 1);
      table[i] = r;
    }
    init = true;
  }
  uint32_t crc = 0;
  for (int64_t i = 0; i < n; ++i)
    crc = (crc << 8) ^ table[((crc >> 24) ^ data[i]) & 0xFF];
  return crc;
}

}  // extern "C"
