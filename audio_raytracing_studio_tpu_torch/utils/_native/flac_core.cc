// Native hot loops for the FLAC codec (utils/flacio.py).
//
// Operates on the codec's unpacked bit arrays (one uint8 per bit, MSB-first
// order, matching numpy.unpackbits) so the Python bit readers/writers stay
// the single source of framing truth and these kernels stay trivial.
//
// The port's copy of the JAX package's file, built at first use by
// utils/kernels.build_host and bound by utils/_native_flac.py.

#include <cstdint>

extern "C" {

// Decode n rice(k) residuals starting at bit `pos`; writes signed values to
// `out` and returns the new bit position, or -1 on truncation.
int64_t flac_rice_decode(const uint8_t* bits, int64_t nbits, int64_t pos,
                         int32_t k, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q = 0;
    while (pos < nbits && bits[pos] == 0) {
      ++pos;
      ++q;
    }
    if (pos >= nbits) return -1;
    ++pos;  // consume the unary terminator
    uint64_t low = 0;
    if (k) {
      if (pos + k > nbits) return -1;
      for (int32_t b = 0; b < k; ++b) low = (low << 1) | bits[pos + b];
      pos += k;
    }
    uint64_t u = (q << k) | low;
    out[i] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag → signed
  }
  return pos;
}

// Encode n zigzagged (non-negative) values as rice(k) into a zeroed bit
// array sized sum(u>>k) + n*(1+k); returns bits written.
int64_t flac_rice_encode(const uint64_t* u, int64_t n, int32_t k,
                         uint8_t* bits) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    pos += (int64_t)(u[i] >> k);  // unary zeros (array is pre-zeroed)
    bits[pos++] = 1;
    for (int32_t b = k - 1; b >= 0; --b) bits[pos++] = (u[i] >> b) & 1;
  }
  return pos;
}

// In-place LPC reconstruction: signal[0..order) holds the warmup, the rest
// holds residuals on entry and decoded samples on exit.  coeffs are
// oldest-first.  Integer-exact per the FLAC spec (sum >> shift).
void flac_lpc_reconstruct(int64_t* signal, int64_t blocksize,
                          const int64_t* coeffs, int32_t order,
                          int32_t shift) {
  for (int64_t i = order; i < blocksize; ++i) {
    int64_t acc = 0;
    const int64_t* s = signal + i - order;
    for (int32_t j = 0; j < order; ++j) acc += coeffs[j] * s[j];
    signal[i] += acc >> shift;
  }
}

// CRC-8 (poly 0x07) and CRC-16 (poly 0x8005), MSB-first, init 0 — the FLAC
// frame-header and frame checksums.
uint32_t flac_crc8(const uint8_t* data, int64_t n) {
  uint8_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= data[i];
    for (int b = 0; b < 8; ++b) crc = (crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1;
  }
  return crc;
}

uint32_t flac_crc16(const uint8_t* data, int64_t n) {
  uint16_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)data[i] << 8;
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1;
  }
  return crc;
}

}  // extern "C"
