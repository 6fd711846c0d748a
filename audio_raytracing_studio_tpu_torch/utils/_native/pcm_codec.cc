// Native PCM16 codec — the host-side hot path of audio I/O (the port's copy
// of the JAX package's utils/_native/pcm_codec.cc, built at first use by
// utils/kernels.build_host).
//
// The reference delegates sample conversion to libsndfile (C) via the
// soundfile package (its raytracer_studio.py:1013, :1084).  This is the
// equivalent native component: float32 <-> int16 conversion
// with libsndfile semantics (scale by 32768, round half to even via lrintf
// under the default FP rounding mode, saturate), auto-vectorized and
// callable from Python through ctypes with zero-copy NumPy buffers.

#include <cmath>
#include <cstdint>

extern "C" {

void encode_pcm16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i] * 32768.0f;
    long r = lrintf(v);
    if (r > 32767) r = 32767;
    if (r < -32768) r = -32768;
    out[i] = static_cast<int16_t>(r);
  }
}

void decode_pcm16(const int16_t* in, float* out, int64_t n) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<float>(in[i]) * kScale;
  }
}

}  // extern "C"
