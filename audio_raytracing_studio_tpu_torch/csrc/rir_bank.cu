// Fused RIR bank for NVIDIA Hopper (sm_90a): final early/late IRs in two
// launches, with the normalization epilogue inside the kernels.
//
// Replaces the two Pallas TPU kernels of
// audio_raytracing_studio_tpu/ops/ir_synth_pallas.py and the jnp epilogue
// that follows the first:
//   hash draws      `_rir_block_kernel` (:121, called by `_hash_bank` at
//                   :503) and `_finalize_bank` (:269) — the main path;
//   injected draws  `_rir_bank_kernel` (:318, called by `_injected_bank` at
//                   :553) — the oracle-parity path.
// Reference semantics: raytracer_studio.py:238-308.  The wrappers and the
// plain PyTorch versions (`_rir_block_plain`, `_rir_bank_plain`) live in
// ops/ir_synth_cuda.py.
//
// What bank entry b gets:
//   early — ≤80 taps (delay d_k, amplitude `early_tap_amps`) summed in tap
//           order at their samples, times 0.9 / max|early|;
//   late  — noise at tail index t = pos − split_point, smoothed by the
//           w-tap 'same' moving average, times initial_amp·exp(t·log_decay)
//           and the variance restore std(noise) / std(smoothed), then times
//           0.7 / max|late|; zero outside [0, late_length).  With injected
//           draws an entry whose smoothed noise has std ≤ 1e-6 keeps the raw
//           noise and no variance restore (`synthesize`'s fallback).
// The noise is a counter hash of (seed, t) or a row in memory; one templated
// body serves both sources.
//
// Bound: bytes.  A call writes early and late once, 8·B·L bytes, and the
// injected source reads its noise once, 4·B·late_length bytes: at the bench
// shape (B=48, L=72,000, late_length 68,160) 27.65 MB and 40.74 MB, i.e.
// 8.25 µs and 12.16 µs at 3.35 TB/s.  The function's arithmetic (one
// lowbias32 per late sample for the hash source, ~16 float operations and
// one exp per sample) is an order of magnitude below that.  The kernels
// take longer than the bytes: each pass is bound by the latency of its
// blocks' instruction streams (16 samples per thread, each with the plain
// version's exact arithmetic — w ordered adds, an IEEE division, an
// accurate expf, no FMA contraction — and the noise rebuilt in both
// passes), not by memory (PERF.md section 6).
//
// Design: two launches on one stream, grid (n_tiles, B), tiles of 4096.
//   stats pass  each block stages its tile's noise plus a w − 1 halo in
//               shared memory (the hash source hashes each index once),
//               sums the w taps of each sample from there and writes 8
//               per-tile partials and no sample: noise sum and centered M2,
//               smoothed sum and centered M2 (from the tap sums, divided by
//               w once per tile), max|early|, max|late| before scaling (its
//               envelope from __expf: it only sets a peak scale), the valid
//               count, and max|raw-noise tail| (injected source; 0 for the
//               hash).
//   write pass  warp 0 of each block Chan-combines its entry's partials in
//               a fixed order, so every block of the entry derives the same
//               scales (variance restore, 0.9 / 0.7 peaks, the raw-noise
//               decision); meanwhile the block stages its noise again (from
//               L2 for the injected source) and then writes each final
//               sample once — 16-byte stores for whole aligned quads of the
//               flat (B, L) output, scalar stores for the ragged ends.
// The sums and maxima of a tile are one stacked two-stage reduction, the
// centered M2s a second.  No atomics and no tensor cores: taps with equal
// delays add up in tap order and the w smoothing taps in the order of
// `_moving_average_same`, so with -fmad=false the final samples agree with
// the plain version up to the round-off of the per-entry scales.  The
// common width w = 10 (every 16 kHz and 48 kHz geometry) has kernels with
// the width fixed at compile time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;                      // samples per tile (TILE)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuadsPerThread = kTile / 4 / kThreads;  // stats pass: 4 quads
constexpr int kMaxReflections = 80;              // config.REF_COUNT_CLIP[1]
constexpr int kStats = 8;
constexpr int kMaxWidth = 10;                    // config.NOISE_SMOOTH_CLIP[1]
constexpr int kWindow = 16;                      // floats a quad reads (≥ 3 + kMaxWidth)
constexpr int kStage = kTile + kWindow + 4;      // staged noise: tile, halo, alignment
constexpr int kTapThread = 32;                   // write pass: warps 1.. draw the taps

constexpr uint32_t kPhi = 0x9E3779B9u;           // ops/rng.py
constexpr uint32_t kDelayStream = 0xA511E9B3u;
constexpr uint32_t kStrengthStream = 0x63D83595u;
constexpr uint32_t kNoiseStream = 0xC2B2AE35u;

static_assert(kTile % (4 * kThreads) == 0, "a tile splits into whole quads per thread");
static_assert(3 + kMaxWidth <= kWindow && kWindow % 4 == 0, "a quad's taps fit its window");
static_assert(kTapThread + kMaxReflections <= kThreads, "one thread per early tap");

struct BankShape {
  int length;
  int split_point;
  int actual_max_early_delay;
  int reflection_count;
  int late_length;
  int smooth_width;
  int early_active;
  int unit_scales;  // checks only: write the unscaled samples
  float strength_lo;
  float strength_span;
  float delay_decay_exp;
};

// Where the randomness comes from: seeds (hash source) or explicit draws.
struct Draws {
  const int32_t* seeds;      // (B,)
  const int32_t* delays;     // (B, 80)
  const float* strengths;    // (B, 80)
  const float* noise;        // (B, noise_stride)
  int noise_stride;
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t mix, uint32_t index) {
  return lowbias32(mix + index * kPhi);
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits, float lo, float span) {
  const float one_to_two = __uint_as_float((bits >> 9) | 0x3F800000u);
  return lo + (one_to_two - 1.0f) * span;
}

// early_tap_amps (ops/ir_synth.py), same operation order.
__device__ __forceinline__ float early_tap_amp(int delay, float strength,
                                               float one_minus_absorption, float directionality,
                                               const BankShape& s) {
  const float falloff =
      1.0f - powf(static_cast<float>(delay) / static_cast<float>(s.actual_max_early_delay),
                  s.delay_decay_exp);
  return strength * one_minus_absorption * fminf(fmaxf(directionality, 0.1f), 1.0f) * falloff;
}

// One entry's randomness: the counter streams of its seed, or its rows of
// the injected draws.
template <bool kInjected>
struct Entry {
  uint32_t seed = 0;
  uint32_t noise_mix = 0;
  const int32_t* delays = nullptr;
  const float* strengths = nullptr;
  const float* noise = nullptr;

  __device__ Entry(const Draws& d, int b) {
    if constexpr (kInjected) {
      delays = d.delays + b * kMaxReflections;
      strengths = d.strengths + b * kMaxReflections;
      noise = d.noise + static_cast<size_t>(b) * d.noise_stride;
    } else {
      seed = static_cast<uint32_t>(d.seeds[b]);
      noise_mix = lowbias32(seed ^ kNoiseStream);
    }
  }

  // Uniform [-1, 1) noise at tail index t ∈ [0, late_length).
  __device__ __forceinline__ float noise_at(int t) const {
    if constexpr (kInjected) {
      return noise[t];
    } else {
      return uniform_from_bits(counter_bits(noise_mix, static_cast<uint32_t>(t)), -1.0f, 2.0f);
    }
  }

  __device__ void tap(int k, const BankShape& s, int* delay, float* strength) const {
    if constexpr (kInjected) {
      *delay = delays[k];
      *strength = strengths[k];
    } else {
      const int hi = max(2, s.actual_max_early_delay);
      const uint32_t modulus = static_cast<uint32_t>(max(1, hi - 1));
      *delay = 1 + static_cast<int>(counter_bits(lowbias32(seed ^ kDelayStream), k) % modulus);
      *strength = uniform_from_bits(counter_bits(lowbias32(seed ^ kStrengthStream), k),
                                    s.strength_lo, s.strength_span);
    }
  }
};

// What a tile covers; every field is block-uniform.
struct TileGeom {
  int base;      // first sample
  int t0;        // tail index of `base`
  int width;     // smoothing taps (1 when the smoothing is off)
  int lead;      // 'same' offset: tap k of sample t reads noise[t + k − lead]
  bool smooth;
  bool has_late;
  bool has_taps;
};

// kW ≠ 0: the launcher saw smoothing active at width kW.
template <int kW>
__device__ TileGeom tile_geom(int tile, const BankShape& s) {
  TileGeom g;
  g.base = tile * kTile;
  g.t0 = g.base - s.split_point;
  g.smooth = kW ? true : s.smooth_width > 1 && s.late_length >= s.smooth_width;
  g.width = kW ? kW : (g.smooth ? s.smooth_width : 1);
  g.lead = kW ? kW / 2 : (g.smooth ? s.smooth_width / 2 : 0);
  g.has_late = s.late_length > 0;
  g.has_taps = s.early_active && g.base < s.split_point;
  return g;
}

// Thread first + k (k < 80) draws tap k: its delay (−1 when masked) and
// amplitude (ref :258-268).
template <bool kInjected>
__device__ void draw_taps(const Entry<kInjected>& e, const float* sc, const BankShape& s,
                          int first, int* tap_delay, float* tap_amp) {
  const int k = static_cast<int>(threadIdx.x) - first;
  if (k < 0 || k >= kMaxReflections) return;
  int delay;
  float strength;
  e.tap(k, s, &delay, &strength);
  const float amp = early_tap_amp(delay, strength, sc[0], sc[1], s);
  const bool valid = k < min(kMaxReflections, s.reflection_count) && delay > 0 &&
                     delay < s.split_point;
  tap_delay[k] = valid ? delay : -1;
  tap_amp[k] = valid ? amp : 0.0f;
}

// Tap k's early sample, if k is the first tap at its delay and the delay lies
// in [base, base + kTile): the amplitudes of every tap there, in tap order.
// Otherwise *pos = −1.
__device__ float tap_sample(int k, int r_count, const int* tap_delay, const float* tap_amp,
                            int base, int* pos) {
  *pos = -1;
  const int d = tap_delay[k];
  if (d < base || d >= base + kTile) return 0.0f;  // masked taps (−1) included
  float v = 0.0f;
  for (int j = 0; j < r_count; ++j) {
    if (tap_delay[j] == d) {
      if (j < k) return 0.0f;  // an earlier tap owns this sample
      v += tap_amp[j];
    }
  }
  *pos = d;
  return v;
}

// buf[i] = noise at tail index first + i for i < need; 0 outside
// [0, late_length) (the 'same' smoothing's zero padding) and from need on.
template <bool kInjected>
__device__ void stage_noise(float* buf, const Entry<kInjected>& e, int first, int need,
                            int late_length) {
  for (int i = threadIdx.x; i < kStage; i += kThreads) {
    const int t = first + i;
    buf[i] = (i < need && t >= 0 && t < late_length) ? e.noise_at(t) : 0.0f;
  }
}

// Noise and smoothed noise of the 4 samples whose first taps are buf[at],
// buf[at + 1], ... (at % 4 == 0): 4 vector reads of shared memory, then the
// w taps of each sample summed in order k = 0..w−1; with kDivide the sums
// are divided by w (the smoothed noise), else they stay sums.  kW ≠ 0 fixes
// the width at compile time (no predicates); kW = 0 takes it at run time.
template <int kW, bool kDivide = true>
__device__ __forceinline__ void quad_at(const float* buf, int at, int width_rt, int lead_rt,
                                        float nz[4], float sm[4]) {
  const int width = kW ? kW : width_rt;
  const int lead = kW ? kW / 2 : lead_rt;
  float win[kWindow];
#pragma unroll
  for (int v = 0; v < kWindow / 4; ++v) {
    const float4 f = reinterpret_cast<const float4*>(buf + at)[v];
    win[4 * v + 0] = f.x;
    win[4 * v + 1] = f.y;
    win[4 * v + 2] = f.z;
    win[4 * v + 3] = f.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = 0.0f;
    float raw = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) {
      if (k < width) acc += win[i + k];
      if (k == lead) raw = win[i + k];
    }
    nz[i] = raw;
    sm[i] = width > 1 ? (kDivide ? acc / static_cast<float>(width) : acc) : raw;
  }
}

// The same for one sample whose first tap is buf[at] (the ragged ends).
template <int kW>
__device__ __forceinline__ void sample_at(const float* buf, int at, int width_rt, int lead_rt,
                                          float* nz, float* sm) {
  const int width = kW ? kW : width_rt;
  const int lead = kW ? kW / 2 : lead_rt;
  float acc = 0.0f;
  for (int k = 0; k < width; ++k) acc += buf[at + k];
  *nz = buf[at + lead];
  *sm = width > 1 ? acc / static_cast<float>(width) : *nz;
}

// Valid tail samples of a tile: [base, base + kTile) ∩ [split, length).
__device__ __forceinline__ int valid_count(const TileGeom& g, const BankShape& s) {
  if (!g.has_late) return 0;
  const int lo = max(g.base, s.split_point);
  const int hi = min(g.base + kTile, s.split_point + s.late_length);
  return max(0, hi - lo);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// Stats pass: per-tile partials, no samples.
// ---------------------------------------------------------------------------
// Both passes: ≤ 64 registers, so 4 blocks of 256 threads fit an SM.
template <bool kInjected, int kW>
__global__ void __launch_bounds__(kThreads, 4)
bank_stats_kernel(Draws draws, const float* __restrict__ scal, float* __restrict__ stats,
                  BankShape s) {
  __shared__ __align__(16) float buf[kStage];
  __shared__ int tap_delay[kMaxReflections];
  __shared__ float tap_amp[kMaxReflections];
  __shared__ float partial[kWarps][5];
  __shared__ float partial_m2[kWarps][2];

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Entry<kInjected> e(draws, b);
  const float* sc = scal + b * 4;
  const TileGeom g = tile_geom<kW>(tile, s);

  if (g.has_taps) draw_taps(e, sc, s, 0, tap_delay, tap_amp);
  if (g.has_late) stage_noise(buf, e, g.t0 - g.lead, kTile + g.width - 1, s.late_length);
  __syncthreads();

  float max_e = 0.0f;
  if (g.has_taps && tid < kMaxReflections) {
    int pos;
    max_e = fabsf(tap_sample(tid, min(kMaxReflections, s.reflection_count), tap_delay,
                             tap_amp, g.base, &pos));
  }

  // late: noise and w-tap sums of 16 samples per thread, kept for M2.  The
  // smoothed noise is sum / w: its partials are the sums' divided by w (and
  // w² for M2) once per tile, not a division per sample.  The maxima take
  // the envelope from __expf (a few ulps): they only set the peak scales.
  float nz[kQuadsPerThread][4];
  float sm[kQuadsPerThread][4];
  float sum_n = 0.0f, sum_s = 0.0f, max_t = 0.0f, max_r = 0.0f;
  const float log_decay = sc[2];
  const float amp = sc[3];
#pragma unroll
  for (int j = 0; j < kQuadsPerThread; ++j) {
    const int l0 = 4 * (j * kThreads + tid);
    float qn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float qs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g.has_late) quad_at<kW, false>(buf, l0, g.width, g.lead, qn, qs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = g.t0 + l0 + i;
      const bool valid = g.has_late && t >= 0 && t < s.late_length;
      const float env = valid ? __expf(static_cast<float>(t) * log_decay) : 0.0f;
      nz[j][i] = qn[i];  // staged as 0 outside the tail
      sm[j][i] = valid ? qs[i] : 0.0f;
      sum_n += qn[i];
      sum_s += sm[j][i];
      max_t = fmaxf(max_t, fabsf(valid ? qs[i] * amp * env : 0.0f));
      if constexpr (kInjected) max_r = fmaxf(max_r, fabsf(valid ? qn[i] * amp * env : 0.0f));
    }
  }

  // sums and maxima, stacked: warp shuffles, then every thread combines the
  // warps' partials in warp order
  sum_n = warp_sum(sum_n);
  sum_s = warp_sum(sum_s);
  max_e = warp_max(max_e);
  max_t = warp_max(max_t);
  max_r = warp_max(max_r);
  if (lane == 0) {
    partial[warp][0] = sum_n;
    partial[warp][1] = sum_s;
    partial[warp][2] = max_e;
    partial[warp][3] = max_t;
    partial[warp][4] = max_r;
  }
  __syncthreads();
  float tot_n = 0.0f, tot_s = 0.0f;
  max_e = max_t = max_r = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    tot_n += partial[w][0];
    tot_s += partial[w][1];
    max_e = fmaxf(max_e, partial[w][2]);
    max_t = fmaxf(max_t, partial[w][3]);
    max_r = fmaxf(max_r, partial[w][4]);
  }
  const float n_b = static_cast<float>(valid_count(g, s));
  const float mean_n = tot_n / fmaxf(n_b, 1.0f);
  const float mean_s = tot_s / fmaxf(n_b, 1.0f);

  // centered M2 from the registers: no sumsq/n − mean² cancellation
  float m2_n = 0.0f, m2_s = 0.0f;
#pragma unroll
  for (int j = 0; j < kQuadsPerThread; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = g.t0 + 4 * (j * kThreads + tid) + i;
      if (g.has_late && t >= 0 && t < s.late_length) {
        const float dn = nz[j][i] - mean_n;
        const float ds = sm[j][i] - mean_s;
        m2_n += dn * dn;
        m2_s += ds * ds;
      }
    }
  }
  m2_n = warp_sum(m2_n);
  m2_s = warp_sum(m2_s);
  if (lane == 0) {
    partial_m2[warp][0] = m2_n;
    partial_m2[warp][1] = m2_s;
  }
  __syncthreads();
  if (tid == 0) {
    m2_n = m2_s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m2_n += partial_m2[w][0];
      m2_s += partial_m2[w][1];
    }
    const float w = static_cast<float>(g.width);
    float4* out = reinterpret_cast<float4*>(
        stats + (static_cast<size_t>(b) * gridDim.x + tile) * kStats);
    out[0] = make_float4(tot_n, m2_n, tot_s / w, m2_s / (w * w));
    out[1] = make_float4(max_e, max_t / w, n_b, max_r);
  }
}

// ---------------------------------------------------------------------------
// Write pass: the entry's scales from its partials, then the final samples.
// ---------------------------------------------------------------------------

// Run by one whole warp: every lane reads the rows i ≡ lane (mod 32) in
// index order and the butterfly sums give every lane the same totals, so
// every block of the entry computes the same scales.  Mirrors
// `_entry_scales` (ops/ir_synth_cuda.py).
template <bool kInjected>
__device__ void entry_scales(const float* __restrict__ rows, int n_tiles, const BankShape& s,
                             float* early_scale, float* late_scale, int* raw) {
  const int lane = threadIdx.x & 31;
  float sum_n = 0.0f, m2_n = 0.0f, sum_s = 0.0f, m2_s = 0.0f;
  float max_e = 0.0f, max_t = 0.0f, max_r = 0.0f;
  for (int i = lane; i < n_tiles; i += 32) {
    const float4 a = reinterpret_cast<const float4*>(rows + i * kStats)[0];
    const float4 c = reinterpret_cast<const float4*>(rows + i * kStats)[1];
    sum_n += a.x;
    m2_n += a.y;
    sum_s += a.z;
    m2_s += a.w;
    max_e = fmaxf(max_e, c.x);
    max_t = fmaxf(max_t, c.y);
    max_r = fmaxf(max_r, c.w);
  }
  sum_n = warp_sum(sum_n);
  m2_n = warp_sum(m2_n);
  sum_s = warp_sum(sum_s);
  m2_s = warp_sum(m2_s);
  max_e = warp_max(max_e);
  max_t = warp_max(max_t);
  max_r = warp_max(max_r);

  float c = 1.0f;
  bool raw_noise = false;
  if (s.late_length > 0 && s.smooth_width > 1 && s.late_length >= s.smooth_width) {
    // Chan: var = (Σ M2_b + Σ n_b·(mean_b − mean)²) / n, as `_tail_stds`
    const float n = static_cast<float>(s.late_length);
    const float mean_n = sum_n / n;
    const float mean_s = sum_s / n;
    float between_n = 0.0f, between_s = 0.0f;
    for (int i = lane; i < n_tiles; i += 32) {
      const float4 a = reinterpret_cast<const float4*>(rows + i * kStats)[0];
      const float n_b = rows[i * kStats + 6];
      const float dn = a.x / fmaxf(n_b, 1.0f) - mean_n;
      const float ds = a.z / fmaxf(n_b, 1.0f) - mean_s;
      between_n += n_b * (dn * dn);
      between_s += n_b * (ds * ds);
    }
    between_n = warp_sum(between_n);
    between_s = warp_sum(between_s);
    const float std_n = sqrtf(fmaxf((m2_n + between_n) / n, 0.0f));
    const float std_s = sqrtf(fmaxf((m2_s + between_s) / n, 0.0f));
    const bool restore = std_s > 1e-6f;
    c = restore ? std_n / std_s : 1.0f;
    if (kInjected && !restore) {  // degenerate smoothing: the raw noise stands
      raw_noise = true;
      max_t = max_r;
    }
  }
  const float late_peak = max_t * c;
  float ls = c * (late_peak > 1e-6f ? 0.7f / late_peak : 1.0f);   // config.LATE_NORM_PEAK
  float es = max_e > 1e-6f ? 0.9f / max_e : 1.0f;                  // config.EARLY_NORM_PEAK
  if (s.unit_scales) es = ls = 1.0f;
  if (lane == 0) {
    *early_scale = es;
    *late_scale = ls;
    *raw = raw_noise ? 1 : 0;
  }
}

template <bool kInjected, int kW>
__global__ void __launch_bounds__(kThreads, 4)
bank_write_kernel(Draws draws, const float* __restrict__ scal, const float* __restrict__ stats,
                  float* __restrict__ early, float* __restrict__ late,
                  int32_t* __restrict__ raw_flags, BankShape s) {
  __shared__ __align__(16) float buf[kStage];
  __shared__ int tap_delay[kMaxReflections];
  __shared__ float tap_amp[kMaxReflections];
  __shared__ float scale_e, scale_l;
  __shared__ int raw_entry;

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const Entry<kInjected> e(draws, b);
  const float* sc = scal + b * 4;
  const TileGeom g = tile_geom<kW>(tile, s);

  // The tile's samples inside the IR, split on the flat (B, L) output into a
  // scalar head up to the first 16-byte boundary, whole quads, a scalar tail.
  const size_t row_base = static_cast<size_t>(b) * s.length + g.base;
  const int len = min(kTile, s.length - g.base);
  const int head = min(len, static_cast<int>((4u - (row_base & 3u)) & 3u));
  const int quads = (len - head) / 4;
  const int tail = len - head - 4 * quads;
  const int pad = (4 - head) & 3;  // sample l's first tap is buf[l + pad]: quads read aligned

  if (tid < 32) {
    entry_scales<kInjected>(stats + static_cast<size_t>(b) * gridDim.x * kStats, gridDim.x, s,
                            &scale_e, &scale_l, &raw_entry);
  }
  if (g.has_taps) draw_taps(e, sc, s, kTapThread, tap_delay, tap_amp);
  if (g.has_late) {
    stage_noise(buf, e, g.t0 - g.lead - pad, kTile + pad + g.width - 1, s.late_length);
  }
  __syncthreads();
  const float early_scale = scale_e;
  const float late_scale = scale_l;
  const bool raw = raw_entry != 0;
  if (raw_flags != nullptr && tile == 0 && tid == 0) raw_flags[b] = raw_entry;

  const float log_decay = sc[2];
  const float amp = sc[3];
  float* early_out = early + row_base;
  float* late_out = late + row_base;

  for (int q = tid; q < quads; q += kThreads) {
    const int l0 = head + 4 * q;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g.has_late) {
      float qn[4], qs[4];
      quad_at<kW>(buf, l0 + pad, g.width, g.lead, qn, qs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = g.t0 + l0 + i;
        if (t >= 0 && t < s.late_length) {
          const float env = expf(static_cast<float>(t) * log_decay);
          v[i] = (raw ? qn[i] : qs[i]) * amp * env * late_scale;
        }
      }
    }
    reinterpret_cast<float4*>(late_out + l0)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(early_out + l0)[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // the ragged ends: ≤ 3 samples before the first quad, ≤ 3 after the last
  if (tid < head + tail) {
    const int l = tid < head ? tid : head + 4 * quads + (tid - head);
    float v = 0.0f;
    const int t = g.t0 + l;
    if (g.has_late && t >= 0 && t < s.late_length) {
      float nz, sm;
      sample_at<kW>(buf, l + pad, g.width, g.lead, &nz, &sm);
      const float env = expf(static_cast<float>(t) * log_decay);
      v = (raw ? nz : sm) * amp * env * late_scale;
    }
    late_out[l] = v;
    early_out[l] = 0.0f;
  }

  if (g.has_taps) {
    __syncthreads();  // the zeros above land before the taps overwrite them
    const int k = tid - kTapThread;
    if (k >= 0 && k < kMaxReflections) {
      int pos;
      const float val = tap_sample(k, min(kMaxReflections, s.reflection_count), tap_delay,
                                   tap_amp, g.base, &pos);
      if (pos >= 0) early[static_cast<size_t>(b) * s.length + pos] = val * early_scale;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool kInjected, int kW>
int launch_passes(const Draws& draws, const void* scal, void* early, void* late, void* stats,
                  void* raw_flags, int batch, const BankShape& s, void* stream) {
  const dim3 grid((s.length + kTile - 1) / kTile, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bank_stats_kernel<kInjected, kW><<<grid, kThreads, 0, st>>>(
      draws, static_cast<const float*>(scal), static_cast<float*>(stats), s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bank_write_kernel<kInjected, kW><<<grid, kThreads, 0, st>>>(
      draws, static_cast<const float*>(scal), static_cast<const float*>(stats),
      static_cast<float*>(early), static_cast<float*>(late),
      static_cast<int32_t*>(raw_flags), s);
  return static_cast<int>(cudaGetLastError());
}

// The widest smoothing (every 16 kHz and 48 kHz geometry has w = 10) gets
// kernels with the width fixed at compile time; other widths the general ones.
template <bool kInjected>
int launch_bank(const Draws& draws, const void* scal, void* early, void* late, void* stats,
                void* raw_flags, int batch, const BankShape& s, void* stream) {
  if (batch <= 0 || batch > 65535 || s.length <= 0 || s.smooth_width > kMaxWidth ||
      !aligned16(early) || !aligned16(late) || !aligned16(stats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s.smooth_width == kMaxWidth && s.late_length >= kMaxWidth) {
    return launch_passes<kInjected, kMaxWidth>(draws, scal, early, late, stats, raw_flags,
                                               batch, s, stream);
  }
  return launch_passes<kInjected, 0>(draws, scal, early, late, stats, raw_flags, batch, s,
                                     stream);
}

BankShape make_shape(int length, int split_point, int actual_max_early_delay,
                     int reflection_count, int late_length, int smooth_width, int early_active,
                     int unit_scales, float strength_lo, float strength_span,
                     float delay_decay_exp) {
  BankShape s;
  s.length = length;
  s.split_point = split_point;
  s.actual_max_early_delay = actual_max_early_delay;
  s.reflection_count = reflection_count;
  s.late_length = late_length;
  s.smooth_width = smooth_width;
  s.early_active = early_active;
  s.unit_scales = unit_scales;
  s.strength_lo = strength_lo;
  s.strength_span = strength_span;
  s.delay_decay_exp = delay_decay_exp;
  return s;
}

}  // namespace

// Hash-draws bank on `stream`: both passes, no host sync.  Pointers: seeds
// (B,) int32, scal (B, 4) float32, early/late (B, length) float32, stats
// (B, n_tiles, 8) float32 scratch — contiguous on the current device,
// 16-byte aligned, allocated by the caller.  Returns 0 or the CUDA error of
// the first launch that failed.
extern "C" int rir_bank_launch(const void* seeds, const void* scal, void* early, void* late,
                               void* stats, int batch, int tile, int length, int split_point,
                               int actual_max_early_delay, int reflection_count,
                               int late_length, int smooth_width, int early_active,
                               int unit_scales, float strength_lo, float strength_span,
                               float delay_decay_exp, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  Draws draws = {static_cast<const int32_t*>(seeds), nullptr, nullptr, nullptr, 0};
  const BankShape s = make_shape(length, split_point, actual_max_early_delay, reflection_count,
                                 late_length, smooth_width, early_active, unit_scales,
                                 strength_lo, strength_span, delay_decay_exp);
  return launch_bank<false>(draws, scal, early, late, stats, nullptr, batch, s, stream);
}

// Injected-draws bank on `stream`: both passes, no host sync.  Pointers:
// delays (B, 80) int32, strengths (B, 80) float32, noise (B, noise_stride)
// float32 with noise_stride ≥ max(1, late_length), scal (B, 4) float32,
// early/late (B, length) float32, stats (B, n_tiles, 8) float32 scratch,
// raw_flags (B,) int32 (1 = the entry kept its raw noise) — contiguous on the
// current device, 16-byte aligned where written by vectors, allocated by the
// caller.  Returns 0 or the CUDA error of the first launch that failed.
extern "C" int rir_bank_injected_launch(const void* delays, const void* strengths,
                                        const void* noise, int noise_stride, const void* scal,
                                        void* early, void* late, void* stats, void* raw_flags,
                                        int batch, int tile, int length, int split_point,
                                        int actual_max_early_delay, int reflection_count,
                                        int late_length, int smooth_width, int early_active,
                                        int unit_scales, float delay_decay_exp, void* stream) {
  if (tile != kTile || noise_stride < max(1, late_length)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws draws = {nullptr, static_cast<const int32_t*>(delays),
                 static_cast<const float*>(strengths), static_cast<const float*>(noise),
                 noise_stride};
  const BankShape s = make_shape(length, split_point, actual_max_early_delay, reflection_count,
                                 late_length, smooth_width, early_active, unit_scales, 0.0f,
                                 0.0f, delay_decay_exp);
  return launch_bank<true>(draws, scal, early, late, stats, raw_flags, batch, s, stream);
}
