// Fused RIR bank for NVIDIA Hopper (sm_90a) — raw early/late IRs + per-tile stats.
//
// Replaces the Pallas TPU kernel `_rir_block_kernel` of
// audio_raytracing_studio_tpu/ops/ir_synth_pallas.py (reached through
// `fused_rir_bank` → `_hash_bank`).  Reference semantics:
// raytracer_studio.py:238-308.  The wrapper and the plain PyTorch version
// (`_rir_block_plain`) live in ops/ir_synth_cuda.py; both feed the same
// epilogue (`_finalize_bank`, plain torch, as in the JAX package).
//
// What it computes, per (bank entry b, tile of kTile samples):
//   early  — ≤80 early taps drawn from the DELAY/STRENGTH counter streams,
//            amplitude law `early_tap_amps`, placed at sample d_k;
//   late   — counter-hash uniform noise at t = pos − split_point, smoothed
//            by the w-tap 'same' moving average, times
//            initial_amp·exp(t·log_decay), zero outside [0, late_length);
//   stats  — 8 floats: noise sum, noise centered M2, smoothed sum, smoothed
//            centered M2, max|early|, max|tail|, valid count, 0.
// Outputs are written in flat sample order straight into (B, length).
//
// Bound: integer ALU.  Every late sample hashes once per smoothing tap
// (w ≤ 10 lowbias32 evaluations, ~12 integer ops each) and writes 8 bytes
// (one float to early, one to late); nothing is read from device memory
// but the (B, 4) scalar table and the seeds.  At the bench shape
// (B=48, length=72,000) that is ~35 M hashes and 28 MB written.
//
// Design:
//   - grid (n_tiles, B), kThreads threads, kPerThread samples per thread
//     held in registers; neighbouring threads write neighbouring samples.
//   - the smoothing re-hashes the shifted counter indices (counter-based
//     draws are order-free), so no tile reads a neighbour's noise: no halo,
//     no cross-block state, any tile size gives the same samples.
//   - early taps: only tiles with base < split_point build them.  Threads
//     0..79 draw one tap each into shared memory; each sample then sums its
//     matching taps in tap order — no atomics and no tensor cores, so
//     duplicate delays add up deterministically.
//   - stats: one block reduction gives the sums and count, hence the means;
//     the centered M2 is then a second pass over the registers (free — the
//     data never left them), which avoids the sumsq/n − mean² cancellation.
//     Tiles combine by Chan's formula in `_finalize_bank`.
//   - the launcher returns cudaGetLastError() so a refused launch surfaces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;                     // samples per tile (must match TILE)
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;    // 16 samples per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxReflections = 80;             // config.REF_COUNT_CLIP[1]
constexpr int kStats = 8;

constexpr uint32_t kPhi = 0x9E3779B9u;          // ops/rng.py
constexpr uint32_t kDelayStream = 0xA511E9B3u;
constexpr uint32_t kStrengthStream = 0x63D83595u;
constexpr uint32_t kNoiseStream = 0xC2B2AE35u;

static_assert(kTile % kThreads == 0, "tile must split evenly over threads");
static_assert(kPerThread <= 32, "valid mask is one 32-bit word");
static_assert(kThreads >= kMaxReflections, "one thread per early tap");

struct BankShape {
  int length;
  int split_point;
  int actual_max_early_delay;
  int reflection_count;
  int late_length;
  int smooth_width;
  int early_active;
  float strength_lo;
  float strength_span;
  float delay_decay_exp;
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

// Uniform [-1, 1) noise at tail index idx; 0 outside [0, late_length) —
// the zero padding of the reference's 'same' smoothing at both tail edges.
__device__ __forceinline__ float noise_at(uint32_t mix, int idx, int late_length) {
  if (idx < 0 || idx >= late_length) return 0.0f;
  return uniform_from_bits(counter_bits(mix, static_cast<uint32_t>(idx)), -1.0f, 2.0f);
}

// Sum (take_max=false) or max (take_max=true, of non-negative values) over
// the block; every thread gets the result.  0 is the identity of both.
__device__ float block_reduce(float v, bool take_max) {
  __shared__ float scratch[kWarps];
  __shared__ float result;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? scratch[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, v, off);
      v = take_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) result = v;
  }
  __syncthreads();
  const float r = result;
  __syncthreads();  // scratch and result are free for the next call
  return r;
}

__global__ void __launch_bounds__(kThreads)
rir_bank_kernel(const int32_t* __restrict__ seeds, const float* __restrict__ scal,
                float* __restrict__ early, float* __restrict__ late,
                float* __restrict__ stats, BankShape s) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  const float one_minus_absorption = scal[b * 4 + 0];
  const float directionality = scal[b * 4 + 1];
  const float log_decay = scal[b * 4 + 2];
  const float initial_amp = scal[b * 4 + 3];
  const int base = tile * kTile;
  float* early_row = early + static_cast<size_t>(b) * s.length;
  float* late_row = late + static_cast<size_t>(b) * s.length;

  // --- early taps (ref :258-268): only tiles overlapping [1, split) ---
  __shared__ int tap_delay[kMaxReflections];
  __shared__ float tap_amp[kMaxReflections];
  const bool has_taps = s.early_active && base < s.split_point;  // block-uniform
  const int r_count = min(kMaxReflections, s.reflection_count);
  if (has_taps) {
    if (tid < kMaxReflections) {
      const int hi = max(2, s.actual_max_early_delay);
      const uint32_t modulus = static_cast<uint32_t>(max(1, hi - 1));
      const uint32_t d_mix = lowbias32(seed ^ kDelayStream);
      const uint32_t s_mix = lowbias32(seed ^ kStrengthStream);
      const int delay = 1 + static_cast<int>(counter_bits(d_mix, tid) % modulus);
      const float strength =
          uniform_from_bits(counter_bits(s_mix, tid), s.strength_lo, s.strength_span);
      // early_tap_amps (ops/ir_synth.py), same operation order
      const float falloff =
          1.0f - powf(static_cast<float>(delay) / static_cast<float>(s.actual_max_early_delay),
                      s.delay_decay_exp);
      const float amp = strength * one_minus_absorption *
                        fminf(fmaxf(directionality, 0.1f), 1.0f) * falloff;
      const bool valid = tid < r_count && delay > 0 && delay < s.split_point;
      tap_delay[tid] = valid ? delay : -1;  // -1 matches no sample
      tap_amp[tid] = valid ? amp : 0.0f;
    }
    __syncthreads();
  }

  // --- late tail (ref :270-296) ---
  const uint32_t noise_mix = lowbias32(seed ^ kNoiseStream);
  const bool has_late = s.late_length > 0;
  const int w = s.smooth_width;
  const bool smooth = w > 1 && s.late_length >= w;
  const int lead = w / 2;

  float noise_v[kPerThread];
  float smooth_v[kPerThread];
  uint32_t valid_mask = 0;
  float sum_n = 0.0f, sum_s = 0.0f, count = 0.0f, max_e = 0.0f, max_t = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int pos = base + j * kThreads + tid;
    float e = 0.0f;
    if (has_taps) {
      for (int k = 0; k < r_count; ++k) {
        if (tap_delay[k] == pos) e += tap_amp[k];
      }
    }
    float nz = 0.0f, sm = 0.0f, tail = 0.0f;
    bool valid = false;
    if (has_late) {
      const int t = pos - s.split_point;  // tail index = noise counter
      valid = t >= 0 && t < s.late_length;
      nz = noise_at(noise_mix, t, s.late_length);
      if (smooth) {
        // np.convolve 'same': tap k reads noise[t + k − lead], re-hashed
        float acc = 0.0f;
        for (int k = 0; k < w; ++k) {
          acc += (k == lead) ? nz : noise_at(noise_mix, t + k - lead, s.late_length);
        }
        sm = acc / static_cast<float>(w);
      } else {
        sm = nz;
      }
      const float envelope = expf(static_cast<float>(max(t, 0)) * log_decay);
      tail = valid ? sm * initial_amp * envelope : 0.0f;
    }
    if (pos < s.length) {
      early_row[pos] = e;
      late_row[pos] = tail;
    }
    noise_v[j] = nz;  // already 0 outside the tail
    smooth_v[j] = valid ? sm : 0.0f;
    valid_mask |= (valid ? 1u : 0u) << j;
    sum_n += nz;
    sum_s += smooth_v[j];
    count += valid ? 1.0f : 0.0f;
    max_e = fmaxf(max_e, fabsf(e));
    max_t = fmaxf(max_t, fabsf(tail));
  }

  // --- per-tile stats: sums → means → centered M2 from the registers ---
  const float n_b = block_reduce(count, false);
  const float tot_n = block_reduce(sum_n, false);
  const float tot_s = block_reduce(sum_s, false);
  const float denom = fmaxf(n_b, 1.0f);
  const float mean_n = tot_n / denom;
  const float mean_s = tot_s / denom;
  float m2_n = 0.0f, m2_s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (valid_mask & (1u << j)) {
      const float dn = noise_v[j] - mean_n;
      const float ds = smooth_v[j] - mean_s;
      m2_n += dn * dn;
      m2_s += ds * ds;
    }
  }
  m2_n = block_reduce(m2_n, false);
  m2_s = block_reduce(m2_s, false);
  max_e = block_reduce(max_e, true);
  max_t = block_reduce(max_t, true);
  if (tid == 0) {
    float* out = stats + (static_cast<size_t>(b) * gridDim.x + tile) * kStats;
    out[0] = tot_n;
    out[1] = m2_n;  // centered M2 (noise)
    out[2] = tot_s;
    out[3] = m2_s;  // centered M2 (smoothed)
    out[4] = max_e;
    out[5] = max_t;
    out[6] = n_b;
    out[7] = 0.0f;
  }
}

}  // namespace

// Launch the bank on `stream`.  Pointers: seeds (B,) int32, scal (B, 4)
// float32, early/late (B, length) float32, stats (B, n_tiles, 8) float32 —
// all contiguous on the current device; the caller allocates them.
// Returns 0 or the CUDA error of the launch.
extern "C" int rir_bank_launch(const void* seeds, const void* scal, void* early,
                               void* late, void* stats, int batch, int tile,
                               int length, int split_point,
                               int actual_max_early_delay, int reflection_count,
                               int late_length, int smooth_width, int early_active,
                               float strength_lo, float strength_span,
                               float delay_decay_exp, void* stream) {
  if (tile != kTile || batch <= 0 || batch > 65535 || length <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BankShape s;
  s.length = length;
  s.split_point = split_point;
  s.actual_max_early_delay = actual_max_early_delay;
  s.reflection_count = reflection_count;
  s.late_length = late_length;
  s.smooth_width = smooth_width;
  s.early_active = early_active;
  s.strength_lo = strength_lo;
  s.strength_span = strength_span;
  s.delay_decay_exp = delay_decay_exp;
  const dim3 grid((length + kTile - 1) / kTile, batch);
  rir_bank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), static_cast<const float*>(scal),
      static_cast<float*>(early), static_cast<float*>(late),
      static_cast<float*>(stats), s);
  return static_cast<int>(cudaGetLastError());
}
