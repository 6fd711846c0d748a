// Back half of the render graph for NVIDIA Hopper (sm_90a): the dry/wet mix,
// the three conditional peak normalizations, the 3D pan and the layout map
// in a few streaming passes, with no intermediate in device memory.
//
// Replaces no TPU kernel: the JAX package runs this stage as jnp under XLA's
// fusion (audio_raytracing_studio_tpu/models/pipeline.py `_mix_eq_spatial`,
// ops/spatial.py `apply_pan` / `map_layout`, ops/filters.py
// `conditional_peak_normalize`).  In eager PyTorch the same stage is some 40
// elementwise and reduction kernels, each a full pass over a (B, C, n)
// float32 tensor (six panned channels written and read back, an `abs`
// temporary per normalization, a padded copy of the dry signal).  The plain
// PyTorch version (`back_half_plain`) and the wrapper live in
// ops/back_half_cuda.py.
//
// Reference semantics (raytracer_studio.py:338-571), per clip b and sample t:
//   mixed = (dry_factor·(1 − dry_wet))·dry + dry_wet·wet, dry zero past n_in
//   [the shelf EQ, outside this file, may replace `mixed`]
//   norm(x) = max|x| < 1e-9 ? 0 : x · (max|x| > 1 ? 1/max|x| : 1), over the
//             clip's channels and samples, applied to mixed, to the six
//             panned channels and to the mapped output in turn
//   six[c] = mixed_L·M[b,0,c] + mixed_R·M[b,1,c]          (`pan_matrix`)
//   Stereo: L = (FL + C·0.707) + RL·0.5, R = (FR + C·0.707) + RR·0.5
//   5.1:    the six channels
//   7.1 / 5.1.2: the six, then RL and RR delayed by d samples (zero before
//           d), times the side gain / the clip's height gain.
// Every multiply and add is rounded on its own, in the plain version's
// order (`__fmul_rn` / `__fadd_rn`, and -fmad=false besides); 1/max is an
// IEEE division, as `reciprocal` is.  A maximum is exact in any order, so
// each clip's three scales equal the plain version's and the output is
// bit-equal to it, NaN and ±inf included (a NaN's bit pattern wins an
// unsigned maximum, as `amax` propagates NaN; NaN > 1 is false, so a NaN
// clip passes unscaled).
//
// Bound: bytes.  The stage must read dry and wet once and write the layout
// once: at the main path's shape (B = 48, n = 2,951,999, Stereo) 2.24 GB
// in and 1.13 GB out, 1.0 ms at 3.35 TB/s; per sample it does under 60
// float operations, far below the card's float32 rate.  A normalization
// needs the whole clip's maximum before any sample of the next stage, so a
// pass that writes the output can start only once three maxima are known.
//
// Design: passes over a grid of (tiles of kSpan samples, clips), each
// recomputing the chain from the inputs in registers:
//   pass A  the mix; max|mixed|, and the maxima of the pan and of the map
//           taken as if the earlier normalizations were identities (x·1 is
//           x bit for bit, NaN payloads aside, which no maximum tells apart);
//   pass B  for the clips whose first normalization is not the identity:
//           through it, the pan's maximum and the map's as if the second
//           were the identity; the other clips' blocks exit at once;
//   pass C  for the clips whose second normalization is not the identity:
//           the map's maximum through both;
//   pass D  every clip through all three; the one write of the stage.
// So a batch whose clips scale only at the end (the common case) reads its
// inputs twice.  The maxima are unsigned atomicMax on the bit patterns of
// |x| into a (B, 6) scratch the launcher zeroes: per clip A's three, B's
// two, C's one.  With the shelf EQ on, the mix alone runs first and writes
// `mixed` (the EQ needs it in memory); passes A-D then read the EQ's output
// with the mix left out.  Loads are scalar and coalesced: rows are of odd
// length and may be strided views, so 16-byte vectors would need a peel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // samples a thread holds per step
constexpr int kStep = kThreads * kItems;        // samples a block holds per step
constexpr int kSpan = 2 * kStep;                // samples per block
constexpr int kWarps = kThreads / 32;
constexpr int kCoefs = 16;                      // ops/back_half_cuda.N_COEFS
constexpr int kSlots = 6;                       // ops/back_half_cuda.N_SLOTS

// Layout codes, as ops/back_half_cuda.LAYOUT_CODES: 7.1 and 5.1.2 share the
// delayed-rear-pair body and differ in the delay and the gain.
constexpr int kStereo = 0;
constexpr int kSurround = 1;
constexpr int kDelayed = 2;

struct Args {
  const float* dry;   // (B, 2, n_dry) rows at dry_sb / dry_sc; unused without the mix
  const float* src;   // (B, 2, n): the wet signal, or the mixed input without the mix
  const float* coef;  // (B, kCoefs): dry coefficient, dry_wet, pan rows L and R, two map gains
  float* out;         // (B, channels, n), contiguous
  uint32_t* stats;    // (B, kSlots): |x| maxima as bit patterns
  int64_t dry_sb, dry_sc, n_dry;
  int64_t src_sb, src_sc;
  int64_t n;
  int64_t delay;
};

struct Coefs {
  float dry, wet, left[6], right[6], gain_a, gain_b;
};

struct Norm {
  bool zero;
  float scale;
};

__device__ __forceinline__ Coefs load_coefs(const float* coef, int b) {
  const float* c = coef + static_cast<int64_t>(b) * kCoefs;
  Coefs k;
  k.dry = __ldg(c + 0);
  k.wet = __ldg(c + 1);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    k.left[i] = __ldg(c + 2 + i);
    k.right[i] = __ldg(c + 8 + i);
  }
  k.gain_a = __ldg(c + 14);
  k.gain_b = __ldg(c + 15);
  return k;
}

// `conditional_peak_normalize` from the clip's maximum (its bit pattern).
__device__ __forceinline__ Norm norm_of(uint32_t bits) {
  const float m = __uint_as_float(bits);
  Norm s;
  s.zero = m < 1e-9f;
  s.scale = m > 1.0f ? __fdiv_rn(1.0f, m) : 1.0f;
  return s;
}

__device__ __forceinline__ bool identity(const Norm& s) { return !s.zero && s.scale == 1.0f; }

__device__ __forceinline__ float apply(const Norm& s, float x) {
  return s.zero ? 0.0f : __fmul_rn(x, s.scale);
}

__device__ __forceinline__ uint32_t abs_bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }

__device__ __forceinline__ float mix(float coef_dry, float d, float coef_wet, float w) {
  return __fadd_rn(__fmul_rn(coef_dry, d), __fmul_rn(coef_wet, w));
}

// The (L, R) pair the chain starts from at sample t (0 <= t < n).
template <bool kMix>
__device__ __forceinline__ float2 pair_at(const Args& a, const Coefs& k, int b, int64_t t) {
  const float* s = a.src + b * a.src_sb + t;
  const float wl = __ldg(s);
  const float wr = __ldg(s + a.src_sc);
  if (!kMix) return make_float2(wl, wr);
  float dl = 0.0f, dr = 0.0f;
  if (t < a.n_dry) {
    const float* d = a.dry + b * a.dry_sb + t;
    dl = __ldg(d);
    dr = __ldg(d + a.dry_sc);
  }
  return make_float2(mix(k.dry, dl, k.wet, wl), mix(k.dry, dr, k.wet, wr));
}

__device__ __forceinline__ float pan(float l, float r, float cl, float cr) {
  return __fadd_rn(__fmul_rn(l, cl), __fmul_rn(r, cr));
}

// Maxima of the block into the clip's slots (one atomic per slot).
template <int kCount>
__device__ __forceinline__ void block_max(uint32_t (&v)[3], uint32_t* slots) {
  __shared__ uint32_t part[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kCount; ++i) {
    const uint32_t w = __reduce_max_sync(0xffffffffu, v[i]);
    if (lane == 0) part[warp][i] = w;
  }
  __syncthreads();
  if (threadIdx.x < kCount) {
    uint32_t m = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = max(m, part[w][threadIdx.x]);
    atomicMax(slots + threadIdx.x, m);
  }
}

// kPass 0..3 = passes A..D: the normalizations before kPass are applied
// with their real scales; A-C record the maxima of stages kPass+1..3, D
// writes the output.
template <int kLayout, bool kMix, int kPass>
__global__ void __launch_bounds__(kThreads) back_half_kernel(Args a) {
  const int b = blockIdx.y;
  const uint32_t* st = a.stats + static_cast<int64_t>(b) * kSlots;
  Norm n1 = {false, 1.0f}, n2 = n1, n3 = n1;
  bool id1 = true, id2 = true;
  if (kPass >= 1) {
    n1 = norm_of(st[0]);
    id1 = identity(n1);
    if (kPass == 1 && id1) return;
  }
  if (kPass >= 2) {
    n2 = norm_of(id1 ? st[1] : st[3]);
    id2 = identity(n2);
    if (kPass == 2 && id2) return;
  }
  if (kPass == 3) n3 = norm_of(id2 ? (id1 ? st[2] : st[4]) : st[5]);

  constexpr int kOut = kLayout == kStereo ? 2 : (kLayout == kSurround ? 6 : 8);
  const Coefs k = load_coefs(a.coef, b);
  uint32_t acc[3] = {0u, 0u, 0u};  // stage 1, 2, 3 maxima
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int64_t stop = start + kSpan < a.n ? start + kSpan : a.n;

  for (int64_t base = start; base < stop; base += kStep) {
    float2 x[kItems];
    float2 xd[kItems];  // the pair d samples back (delayed layouts)
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t t = base + threadIdx.x + i * kThreads;
      x[i] = t < stop ? pair_at<kMix>(a, k, b, t) : make_float2(0.0f, 0.0f);
      if constexpr (kLayout == kDelayed) {
        xd[i] = (t < stop && t >= a.delay) ? pair_at<kMix>(a, k, b, t - a.delay)
                                           : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t t = base + threadIdx.x + i * kThreads;
      if (t >= stop) continue;
      float l = x[i].x, r = x[i].y;
      if (kPass >= 1) {
        l = apply(n1, l);
        r = apply(n1, r);
      }
      if (kPass == 0) acc[0] = max(acc[0], max(abs_bits(l), abs_bits(r)));
      float six[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        six[c] = pan(l, r, k.left[c], k.right[c]);
        if (kPass >= 2) six[c] = apply(n2, six[c]);
        if (kPass <= 1) acc[1] = max(acc[1], abs_bits(six[c]));
      }
      float o[kOut];
      if constexpr (kLayout == kStereo) {
        o[0] = __fadd_rn(__fadd_rn(six[0], __fmul_rn(six[2], k.gain_a)),
                         __fmul_rn(six[4], k.gain_b));
        o[1] = __fadd_rn(__fadd_rn(six[1], __fmul_rn(six[2], k.gain_a)),
                         __fmul_rn(six[5], k.gain_b));
      } else {
#pragma unroll
        for (int c = 0; c < 6; ++c) o[c] = six[c];
      }
      if constexpr (kLayout == kDelayed) {
        float rl = 0.0f, rr = 0.0f;  // the delay's zeros come after the second normalization
        if (t >= a.delay) {
          float dl = xd[i].x, dr = xd[i].y;
          if (kPass >= 1) {
            dl = apply(n1, dl);
            dr = apply(n1, dr);
          }
          rl = pan(dl, dr, k.left[4], k.right[4]);
          rr = pan(dl, dr, k.left[5], k.right[5]);
          if (kPass >= 2) {
            rl = apply(n2, rl);
            rr = apply(n2, rr);
          }
        }
        o[6] = __fmul_rn(rl, k.gain_a);
        o[7] = __fmul_rn(rr, k.gain_a);
      }
      if (kPass <= 2) {
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[2] = max(acc[2], abs_bits(o[c]));
      } else {
        float* dst = a.out + static_cast<int64_t>(b) * kOut * a.n + t;
#pragma unroll
        for (int c = 0; c < kOut; ++c) dst[c * a.n] = apply(n3, o[c]);
      }
    }
  }

  if constexpr (kPass == 0) {
    block_max<3>(acc, a.stats + static_cast<int64_t>(b) * kSlots);
  } else if constexpr (kPass == 1) {
    uint32_t v[3] = {acc[1], acc[2], 0u};
    block_max<2>(v, a.stats + static_cast<int64_t>(b) * kSlots + 3);
  } else if constexpr (kPass == 2) {
    uint32_t v[3] = {acc[2], 0u, 0u};
    block_max<1>(v, a.stats + static_cast<int64_t>(b) * kSlots + 5);
  }
}

// The mix alone, for the EQ: out (B, 2, n) contiguous.
__global__ void __launch_bounds__(kThreads) mix_kernel(Args a) {
  const int b = blockIdx.y;
  const Coefs k = load_coefs(a.coef, b);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int64_t stop = start + kSpan < a.n ? start + kSpan : a.n;
  float* dst = a.out + static_cast<int64_t>(b) * 2 * a.n;
  for (int64_t base = start; base < stop; base += kStep) {
    float2 x[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t t = base + threadIdx.x + i * kThreads;
      x[i] = t < stop ? pair_at<true>(a, k, b, t) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t t = base + threadIdx.x + i * kThreads;
      if (t < stop) {
        dst[t] = x[i].x;
        dst[a.n + t] = x[i].y;
      }
    }
  }
}

template <int kLayout, bool kMix>
int launch_passes(const Args& a, int batch, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((a.n + kSpan - 1) / kSpan), batch);
  cudaError_t err = cudaMemsetAsync(a.stats, 0, sizeof(uint32_t) * kSlots * batch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  back_half_kernel<kLayout, kMix, 0><<<grid, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  back_half_kernel<kLayout, kMix, 1><<<grid, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  back_half_kernel<kLayout, kMix, 2><<<grid, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  back_half_kernel<kLayout, kMix, 3><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMix>
int launch_layout(const Args& a, int batch, int layout, cudaStream_t st) {
  switch (layout) {
    case kStereo: return launch_passes<kStereo, kMix>(a, batch, st);
    case kSurround: return launch_passes<kSurround, kMix>(a, batch, st);
    case kDelayed: return launch_passes<kDelayed, kMix>(a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_shape(int batch, long long n) {
  return batch > 0 && batch <= 65535 && n > 0 && (n + kSpan - 1) / kSpan <= 0x7fffffffLL;
}

}  // namespace

// The whole back half on `stream`: the stats memset and passes A-D, no host
// sync.  dry (B, 2, n_dry) float32 with row strides dry_sb / dry_sc (unused
// when mix is 0), src (B, 2, n) float32 with strides src_sb / src_sc — the
// wet signal when mix is 1, the mixed (EQ'd) input when 0 — unit stride
// along the samples; coef (B, 16) float32 contiguous; out (B, channels, n)
// float32 contiguous, channels 2 / 6 / 8 for layout 0 / 1 / 2; stats (B, 6)
// uint32 scratch.  All on the current device, allocated by the caller.
// Returns 0 or the CUDA error of the first call that failed.
extern "C" int back_half_launch(const void* dry, long long dry_sb, long long dry_sc,
                                long long n_dry, const void* src, long long src_sb,
                                long long src_sc, const void* coef, void* out, void* stats,
                                int batch, long long n, int layout, long long delay, int mix,
                                void* stream) {
  if (!valid_shape(batch, n) || src == nullptr || coef == nullptr || out == nullptr ||
      stats == nullptr || delay < 0 || (mix && (dry == nullptr || n_dry < 0 || n_dry > n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.dry = static_cast<const float*>(dry);
  a.src = static_cast<const float*>(src);
  a.coef = static_cast<const float*>(coef);
  a.out = static_cast<float*>(out);
  a.stats = static_cast<uint32_t*>(stats);
  a.dry_sb = dry_sb;
  a.dry_sc = dry_sc;
  a.n_dry = n_dry;
  a.src_sb = src_sb;
  a.src_sc = src_sc;
  a.n = n;
  a.delay = delay;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mix ? launch_layout<true>(a, batch, layout, st)
             : launch_layout<false>(a, batch, layout, st);
}

// The mix alone on `stream` (the EQ's input): out (B, 2, n) float32
// contiguous; dry, src and coef as for back_half_launch with mix 1.
// Returns 0 or the launch's CUDA error.
extern "C" int back_half_mix_launch(const void* dry, long long dry_sb, long long dry_sc,
                                    long long n_dry, const void* src, long long src_sb,
                                    long long src_sc, const void* coef, void* out, int batch,
                                    long long n, void* stream) {
  if (!valid_shape(batch, n) || dry == nullptr || src == nullptr || coef == nullptr ||
      out == nullptr || n_dry < 0 || n_dry > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.dry = static_cast<const float*>(dry);
  a.src = static_cast<const float*>(src);
  a.coef = static_cast<const float*>(coef);
  a.out = static_cast<float*>(out);
  a.dry_sb = dry_sb;
  a.dry_sc = dry_sc;
  a.n_dry = n_dry;
  a.src_sb = src_sb;
  a.src_sc = src_sc;
  a.n = n;
  const dim3 grid(static_cast<unsigned>((n + kSpan - 1) / kSpan), batch);
  mix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
