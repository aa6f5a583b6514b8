// Pattern Lab's voice bank on Hopper (sm_90a): one launch a bucket, a
// few passes more where a lowpass is too long for an FIR.
//
// Replaces no TPU kernel: the JAX package renders a bucket as a vmapped
// `fm_note` / `psg_note` that XLA fuses (audio_suite_tpu/ops/synth.py).
// Run eagerly in PyTorch the same note costs one kernel an op, ~460 of
// them an FM bucket, each reading and writing a whole [count, L] f32
// array.  This kernel computes a bucket's notes as the eager path does
// (audio_suite_torch/ops/synth.py:fm_note / psg_note, called from
// models/patternlab.py:_fm_bank / _psg_bank) and their tail clamp
// (_render_dispatch), and writes each note's masked contribution once:
//
//   out[r, i] = note_r[i]  if i < min(n_r, n_total - start_r),  else 0
//
// the windows that ops/overlap_add.py then adds into the render.
//
// Bit-exact.  Every f32 op is the eager op with its one rounding, in the
// eager order: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc
// never contracts into an FMA; rintf for torch.round; integer bit ops
// for round_sig12 and the exponent scale; the fade's cosine through cosf,
// the function torch's CUDA cos calls for f32.  The one-pole lowpasses
// are the eager truncated FIRs, y = w0*x, then y = y + w_k*x[i-k] in k
// order, zero-padded on the left.  A last-ulp difference before the
// 14-bit DAC quantizer would flip a whole step, so the kernel is held
// bit-equal to the eager bank (tests/test_torch_voice_bank.py).
//
// Bound on this card: the f32 pipe.  An FM note-sample takes ~150-280
// unfused f32 multiplies and adds (four sines, the precise vibrato sine
// and exp2 with their 12-bit splits, the quantizer, two ~12-tap FIRs;
// chip_smoke.py:bank_ops counts them) and writes 4 bytes; at 33.5 T such
// ops a second against 3.35 TB/s that is compute.  The rows of the packs
// are read once a block.  At the benchmark's 20 s render (11 buckets,
// 7.7 M live note-samples) a render's bank takes 0.285-0.289 ms warm,
// 16% of its 0.046 ms bound; at 120 s (45.8 M) 1.12-1.13 ms, 24% of
// 0.272 ms; the eager bank it replaces took 53-70 and 134-174 ms of card
// time (H100 80GB HBM3 at 700 W, chip_smoke.py --bank, two calls).
// ptxas: 32 registers (40 with the vibrato, 48 the PSG's), no spills.
//
// Design.  A block takes one note and a tile of kTile consecutive
// samples; blocks of a tile at or past the note's clamp only write
// zeros.  Every stage is pointwise but three: op 4's one-sample feedback
// delay and the two cascaded FIRs (K1 and K2 taps).  So the block
// computes, into shared memory, the pre-filter signal of its tile and of
// a causal halo of (K1 - 1) + (K2 - 1) samples to its left (op 4 one more),
// runs the FIRs from there and stores.  The algorithm (1, 2, 3) and the
// vibrato flag are template parameters: the bucket spec makes them static,
// so a bucket runs only its own operator stack.  The constants (polynomial
// coefficients and their 12-bit splits, 1/sr, the DAC levels, the FIR
// weights) come from the host (ops/synth.py:bank_consts) in one struct
// passed by value, so the kernel holds no second copy of them.
//
// Long filters.  A lowpass whose FIR would reach 64 taps (sample rates of
// ~221 kHz and up) is, on the eager path, the doubling scan of
// ops/synth.py:_one_pole_scan over the whole bucket: b = (1 - a) x, then
// for d = 1, 2, 4, ... < L, b[i] = A[i] b[i - d] + b[i] where i >= d.
// Where i >= d its A[i] is the same for every i, a**d squared up in f32
// from a (p below, from the host), so a step is one rounded multiply and
// one rounded add a sample.  Such a bucket runs as passes over
// [count, L] rows: the bank kernel with unit filters (the signal
// unfiltered: 1 * x is exact), then each lowpass as a pass of its own, in
// order: an FIR (fir_kernel) or the scan, whose steps d < kTile run in
// shared memory over a tile and its kTile - 1 causal halo
// (scan_tile_kernel) and each later step is one launch
// (scan_step_kernel).  Every pass zeroes each row from its clamp on.  At
// 230 kHz, 4 s of the benchmark's request (11 buckets, 7.1 M live
// note-samples, ~8 launches a bucket) the bank takes 2.32 ms against the
// eager bank's 120.7 ms (chip_smoke.py, H100 80GB HBM3 at 700 W).
//
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;                 // output samples a block
constexpr int kMaxTaps = 63;                // an FIR's taps (kernels/
                                            // __init__.py:
                                            // VOICE_BANK_MAX_TAPS - 1)
constexpr int kSpan = kTile + 2 * (kMaxTaps - 1) + 1;   // tile + halo
constexpr int kScanSteps = 10;              // the scan's steps in shared
static_assert(1 << kScanSteps == kTile, "");  // memory: d < kTile
constexpr int kFm32 = 36, kFmI = 26;        // pack widths (patternlab.py:
constexpr int kPg32 = 10, kPgI = 10;        // prepare_np)

// ops/synth.py:BANK_CONSTS, field for field.
struct BankConsts {
  float sin_c[5];      // detmath._SF
  float cos_c[5];      // detmath._CF
  float exp2_c[7];     // detmath._E2F
  float sin4_pair[2];  // sig12_pair of _S32[4]
  float cos4_pair[2];  // sig12_pair of _C32[4]
  float exp26_pair[2]; // sig12_pair of _E2C[6]
  float inv_sr;        // f32(1 / sr)
  float pi;            // f32(pi)
  float inv12;         // f32(1 / 12)
  float alg2_gain;     // f32(0.6)
  float dac_m1;        // f32(2**13 - 1)
  float inv_dac;       // f32(1 / dac_m1)
  float w1[kMaxTaps];  // first FIR's weights (the PSG's only one)
  float w2[kMaxTaps];  // second FIR's weights (FM)
};

// A lowpass pass's FIR weights, zero-padded.
struct Taps {
  float w[kMaxTaps];
};

// The doubling scan's constants: c = f32(1 - a), then p[s] = a**(2**s),
// each the f32 square of the one before (p[0] = a).
struct ScanConsts {
  float c;
  float p[kScanSteps];
};

// one IEEE rounding each: nvcc never contracts these into an FMA
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// fixq.round_sig12: the significand rounded to 12 bits
__device__ __forceinline__ float sig12(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x800u) & 0xFFFFF000u);
}

// (ah*bh + ah*bl) + al*bh with (bh, bl) = sig12_pair(b): the precise
// twins' Horner step, each product exact
__device__ __forceinline__ float dot3(float ah, float al, float bh, float bl) {
  return add(add(mul(ah, bh), mul(ah, bl)), mul(al, bh));
}

__device__ __forceinline__ void pair(float x, float& hi, float& lo) {
  hi = sig12(x);
  lo = sig12(sub(x, hi));
}

__device__ __forceinline__ float quadrant(int m, float sp, float cp) {
  return m == 0 ? sp : m == 1 ? cp : m == 2 ? -sp : -cp;
}

// detmath.sin_cycles: sin(2 pi x)
__device__ __forceinline__ float sin_cycles(float x, const BankConsts& c) {
  const float x4 = mul(x, 4.0f);
  const float q = rintf(x4);
  const float v = mul(sub(x4, q), 0.25f);
  const int m = (int)q & 3;
  const float z = mul(v, v);
  float sp = add(c.sin_c[3], mul(z, c.sin_c[4]));
  sp = add(c.sin_c[2], mul(z, sp));
  sp = add(c.sin_c[1], mul(z, sp));
  sp = mul(v, add(c.sin_c[0], mul(z, sp)));
  float cp = add(c.cos_c[3], mul(z, c.cos_c[4]));
  cp = add(c.cos_c[2], mul(z, cp));
  cp = add(c.cos_c[1], mul(z, cp));
  cp = add(c.cos_c[0], mul(z, cp));
  return quadrant(m, sp, cp);
}

// detmath.sin_cycles_precise
__device__ __forceinline__ float sin_cycles_precise(float x,
                                                    const BankConsts& c) {
  const float x4 = mul(x, 4.0f);
  const float q = rintf(x4);
  const float v = mul(sub(x4, q), 0.25f);
  const int m = (int)q & 3;
  float zh, zl, th, tl;
  pair(mul(v, v), zh, zl);
  float sp = add(c.sin_c[3], dot3(zh, zl, c.sin4_pair[0], c.sin4_pair[1]));
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    pair(sp, th, tl);
    sp = add(c.sin_c[k], dot3(zh, zl, th, tl));
  }
  float vh, vl;
  pair(v, vh, vl);
  pair(sp, th, tl);
  sp = dot3(vh, vl, th, tl);
  float cp = add(c.cos_c[3], dot3(zh, zl, c.cos4_pair[0], c.cos4_pair[1]));
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    pair(cp, th, tl);
    cp = add(c.cos_c[k], dot3(zh, zl, th, tl));
  }
  return quadrant(m, sp, cp);
}

// detmath.exp2_precise: 2**y
__device__ __forceinline__ float exp2_precise(float y, const BankConsts& c) {
  const float k = rintf(y);
  float rh, rl, th, tl;
  pair(sub(y, k), rh, rl);
  float p = add(c.exp2_c[5], dot3(rh, rl, c.exp26_pair[0], c.exp26_pair[1]));
#pragma unroll
  for (int j = 4; j >= 0; --j) {
    pair(p, th, tl);
    p = add(c.exp2_c[j], dot3(rh, rl, th, tl));
  }
  pair(p, th, tl);
  p = dot3(rh, rl, th, tl);
  const int ki = min(max((int)k, -126), 126);
  return mul(add(1.0f, p), __int_as_float((ki + 127) << 23));
}

// envelopes.adsr_from_consts at sample i
__device__ __forceinline__ float adsr(int i, int n, int n_a, int n_d,
                                      int n_r, float inv_na, float inv_nd,
                                      float inv_dr, float startv, float s) {
  if (i >= n) return 0.0f;
  if (i < n_a) {
    const float ramp = mul((float)i, inv_na);
    return mul(ramp, ramp);
  }
  if (i < n_a + n_d)
    return add(1.0f, mul(sub(s, 1.0f), mul((float)(i - n_a), inv_nd)));
  const int rel_start = n - n_r;
  if (i < rel_start) return s;
  const float ramp =
      n_r > 1 ? sub(1.0f, mul((float)(i - rel_start), inv_dr)) : 1.0f;
  return mul(startv, mul(ramp, ramp));
}

// envelopes.micro_fade_gain at sample i (n >= 0).  Out of line, so the
// seven kernels share one copy of cosf; the back ramp wins, as in the
// eager selects (the two never overlap: fade_n <= n / 3 or n - 8 > 8).
__device__ __noinline__ float fade_gain(int i, int n, int fade, float pi) {
  if (n <= 16) return 1.0f;
  if (i == 0 || i == n - 1) return 0.0f;
  const int fade_n = max(min(n / 3, fade), 8);
  int k;
  if (i >= n - fade_n)
    k = n - 1 - i;
  else if (i < fade_n)
    k = i;
  else
    return 1.0f;
  const float denom = (float)max(fade_n - 1, 1);
  return sub(0.5f, mul(0.5f, cosf(__fdiv_rn(mul(pi, (float)k), denom))));
}

// synth.quantize_to_bits
__device__ __forceinline__ float quantize(float x, float levels_m1,
                                          float inv_levels_m1) {
  const float y = fminf(fmaxf(x, -1.0f), 1.0f);
  return mul(rintf(mul(y, levels_m1)), inv_levels_m1);
}

// one tap sum of the truncated FIR: y = w0*x[j], then y + w_k*x[j - k]
__device__ __forceinline__ float fir(const float* s, int j, const float* w,
                                     int K) {
  float y = mul(w[0], s[j]);
  for (int k = 1; k < K; ++k) y = add(y, mul(w[k], s[j - k]));
  return y;
}

// The FIR weights into shared memory (constant indices: the struct stays
// in the parameter bank).
__device__ __forceinline__ void load_weights(const float (&src)[kMaxTaps],
                                             float* dst) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) dst[k] = src[k];
  }
}

// The block's tile [tile0, tile0 + kTile) of row `o` (clipped to L):
// zero it from the note's clamp min(n, n_total - start) on (n, start: the
// row's first two ints, `q`) and return where that starts, `live`; the
// block computes [tile0, live), nothing where live == tile0.
__device__ __forceinline__ int tile_live(const int32_t* q, int L, int tile0,
                                         int n_total, float* o) {
  const int seg = min(__ldg(q), n_total - __ldg(q + 1));
  const int end = min(tile0 + kTile, L);
  const int live = max(min(end, seg), tile0);
  for (int p = live + threadIdx.x; p < end; p += kThreads) o[p] = 0.0f;
  return live;
}

// One FM note's rows of fm32 / fmi (patternlab.py:prepare_np's columns).
struct FmNote {
  const float* f;
  const int32_t* q;
  int n;

  // operator k's signal at sample i: carrier cycles (times the vibrato
  // ratio), reduced, plus the phase-modulation term, its sine, envelope
  // and level (synth.fm_note's op_sig)
  template <bool kVib, bool kPm>
  __device__ __forceinline__ float op(int k, int i, float t, float vib,
                                      float pm, const BankConsts& c) const {
    float cyc = mul(__ldg(f + 1 + k), t);
    if (kVib) cyc = mul(cyc, vib);
    float r0 = sub(cyc, rintf(cyc));
    if (kPm) r0 = add(r0, pm);
    const float sig = sin_cycles(r0, c);
    const float env = adsr(i, n, __ldg(q + 14 + k), __ldg(q + 18 + k),
                           __ldg(q + 22 + k), __ldg(f + 20 + k),
                           __ldg(f + 24 + k), __ldg(f + 28 + k),
                           __ldg(f + 32 + k), __ldg(f + 13 + k));
    return mul(mul(sig, env), __ldg(f + 5 + k));
  }

  // the phase-modulation term of operator k from modulator m
  __device__ __forceinline__ float pm(int k, float m) const {
    return mul(sig12(__ldg(f + 9 + k)), sig12(m));
  }
};

template <int kAlg, bool kVib>
__global__ void __launch_bounds__(kThreads)
fm_bank_kernel(const float* __restrict__ f32, const int32_t* __restrict__ i32,
               int L, int tiles, int n_total, int fade, int K1, int K2,
               const BankConsts c, float* __restrict__ out) {
  __shared__ float s_o4[kSpan];     // op 4, then the first FIR's output
  __shared__ float s_vib[kSpan];    // the vibrato ratio
  __shared__ float s_x[kSpan];      // the pre-filter signal
  __shared__ float s_w1[kMaxTaps], s_w2[kMaxTaps];

  const int row = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x % tiles) * kTile;
  const FmNote note{f32 + (int64_t)row * kFm32, i32 + (int64_t)row * kFmI,
                    __ldg(i32 + (int64_t)row * kFmI)};
  float* o = out + (int64_t)row * L;
  const int live = tile_live(note.q, L, tile0, n_total, o);
  if (live == tile0) return;

  load_weights(c.w1, s_w1);
  load_weights(c.w2, s_w2);
  // s_*[j] holds sample base + j
  const int halo = (K1 - 1) + (K2 - 1);
  const int base = tile0 - halo - 1;
  const int cnt = live - base;
  const float fb = sig12(fmaxf(__ldg(note.f + 17), 0.0f));
  const float lfo_hz = __ldg(note.f + 18), lfo_depth = __ldg(note.f + 19);
  const float vel = __ldg(note.f + 0);

  // 1. the vibrato ratio and op 4 (zero left of the note: the shift's pad)
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const int p = base + j;
    float o4 = 0.0f, vib = 1.0f;
    if (p >= 0) {
      const float t = mul((float)p, c.inv_sr);
      if (kVib) {
        const float v = sin_cycles_precise(mul(lfo_hz, t), c);
        vib = exp2_precise(mul(mul(lfo_depth, v), c.inv12), c);
      }
      o4 = note.op<kVib, false>(3, p, t, vib, 0.0f, c);
    }
    s_o4[j] = o4;
    s_vib[j] = vib;
  }
  __syncthreads();

  // 2. the algorithm's stack, velocity, DAC quantizer and fade
  for (int j = 1 + threadIdx.x; j < cnt; j += kThreads) {
    const int p = base + j;
    float y = 0.0f;
    if (p >= 0) {
      const float t = mul((float)p, c.inv_sr);
      const float vib = s_vib[j];
      const float o4 = s_o4[j];
      if (kAlg == 3) {
        const float o1 = note.op<kVib, false>(0, p, t, vib, 0.0f, c);
        const float o2 = note.op<kVib, false>(1, p, t, vib, 0.0f, c);
        const float o3 = note.op<kVib, false>(2, p, t, vib, 0.0f, c);
        y = mul(add(add(add(o1, o2), o3), o4), 0.25f);
      } else {
        const float o4e = fb > 0.0f ? add(o4, mul(fb, sig12(s_o4[j - 1])))
                                    : o4;
        const float o3 = note.op<kVib, true>(2, p, t, vib, note.pm(2, o4e), c);
        if (kAlg == 1) {
          const float o2 =
              note.op<kVib, true>(1, p, t, vib, note.pm(1, o3), c);
          y = note.op<kVib, true>(0, p, t, vib, note.pm(0, o2), c);
        } else {
          const float o2 = note.op<kVib, false>(1, p, t, vib, 0.0f, c);
          const float o1 =
              note.op<kVib, true>(0, p, t, vib, note.pm(0, o2), c);
          y = mul(add(o3, o1), c.alg2_gain);
        }
      }
      y = quantize(mul(y, vel), c.dac_m1, c.inv_dac);
      y = mul(y, fade_gain(p, note.n, fade, c.pi));
    }
    s_x[j] = y;
  }
  __syncthreads();

  // 3. the first lowpass, over the tile and the second one's halo
  for (int j = K1 + threadIdx.x; j < cnt; j += kThreads)
    s_o4[j] = base + j >= 0 ? fir(s_x, j, s_w1, K1) : 0.0f;
  __syncthreads();

  // 4. the second lowpass over the tile, stored
  for (int j = halo + 1 + threadIdx.x; j < cnt; j += kThreads)
    o[base + j] = fir(s_o4, j, s_w2, K2);
}

__global__ void __launch_bounds__(kThreads)
psg_bank_kernel(const float* __restrict__ f32, const int32_t* __restrict__ i32,
                const float* __restrict__ orbit,
                const int32_t* __restrict__ orbit_base,
                const int32_t* __restrict__ orbit_pos,
                const int32_t* __restrict__ orbit_len, int L, int tiles,
                int n_total, int fade, int K, const BankConsts c,
                float* __restrict__ out) {
  __shared__ float s_x[kSpan];
  __shared__ float s_w[kMaxTaps];

  const int row = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x % tiles) * kTile;
  const float* f = f32 + (int64_t)row * kPg32;
  const int32_t* q = i32 + (int64_t)row * kPgI;
  const int n = __ldg(q + 0);
  float* o = out + (int64_t)row * L;
  const int live = tile_live(q, L, tile0, n_total, o);
  if (live == tile0) return;

  load_weights(c.w1, s_w);
  const int base = tile0 - (K - 1);
  const int cnt = live - base;
  const float hz = __ldg(f + 0), vel = __ldg(f + 1), duty = __ldg(f + 2);
  const float s = __ldg(f + 3), levels_m1 = __ldg(f + 4);
  const float inv_levels_m1 = __ldg(f + 5);
  const bool noise = __ldg(q + 6) != 0;
  const int seed = __ldg(q + 5) & 0x7FFF;
  const int o_base = __ldg(orbit_base + seed);
  const int o_pos = __ldg(orbit_pos + seed) + 1;
  const int o_len = __ldg(orbit_len + seed);

  // synth.psg_note up to the lowpass
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const int p = base + j;
    float y = 0.0f;
    if (p >= 0) {
      const float env = adsr(p, n, __ldg(q + 7), __ldg(q + 8), __ldg(q + 9),
                             __ldg(f + 6), __ldg(f + 7), __ldg(f + 8),
                             __ldg(f + 9), s);
      float sig;
      if (noise) {
        sig = __ldg(orbit + o_base + (o_pos + p) % o_len);
      } else {
        const float prod = mul(mul((float)p, c.inv_sr), hz);
        sig = sub(prod, floorf(prod)) < duty ? 1.0f : -1.0f;
      }
      y = quantize(mul(mul(sig, env), vel), levels_m1, inv_levels_m1);
      y = mul(y, fade_gain(p, n, fade, c.pi));
    }
    s_x[j] = y;
  }
  __syncthreads();

  for (int j = K - 1 + threadIdx.x; j < cnt; j += kThreads)
    o[base + j] = fir(s_x, j, s_w, K);
}

// One lowpass pass as an FIR of K taps: out = the FIR of each row of in.
__global__ void __launch_bounds__(kThreads)
fir_kernel(const float* __restrict__ in, const int32_t* __restrict__ i32,
           int i_stride, int L, int tiles, int n_total, int K, const Taps t,
           float* __restrict__ out) {
  __shared__ float s_x[kTile + kMaxTaps - 1];
  __shared__ float s_w[kMaxTaps];

  const int row = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x % tiles) * kTile;
  const float* x = in + (int64_t)row * L;
  float* o = out + (int64_t)row * L;
  const int live = tile_live(i32 + (int64_t)row * i_stride, L, tile0,
                             n_total, o);
  if (live == tile0) return;

  load_weights(t.w, s_w);
  const int base = tile0 - (K - 1);
  const int cnt = live - base;
  for (int j = threadIdx.x; j < cnt; j += kThreads)
    s_x[j] = base + j >= 0 ? x[base + j] : 0.0f;
  __syncthreads();
  for (int j = K - 1 + threadIdx.x; j < cnt; j += kThreads)
    o[base + j] = fir(s_x, j, s_w, K);
}

// The scan's first pass: b = c * in, then its steps d = 1 .. kTile / 2
// over the tile and its causal halo of kTile - 1 samples, in shared
// memory.  Entry j of a buffer holds sample base + j; after step s it is
// the eager b[base + j] for j >= 2**(s + 1) - 1, so the tile's (j >=
// kTile - 1) are exact at the end.
__global__ void __launch_bounds__(kThreads)
scan_tile_kernel(const float* __restrict__ in,
                 const int32_t* __restrict__ i32, int i_stride, int L,
                 int tiles, int n_total, const ScanConsts sc,
                 float* __restrict__ out) {
  __shared__ float s_b[2][2 * kTile - 1];

  const int row = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x % tiles) * kTile;
  const float* x = in + (int64_t)row * L;
  float* o = out + (int64_t)row * L;
  const int live = tile_live(i32 + (int64_t)row * i_stride, L, tile0,
                             n_total, o);
  if (live == tile0) return;

  const int base = tile0 - (kTile - 1);
  const int cnt = live - base;
  for (int j = threadIdx.x; j < cnt; j += kThreads)
    s_b[0][j] = base + j >= 0 ? mul(sc.c, x[base + j]) : 0.0f;
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < kScanSteps; ++s) {
    const int d = 1 << s;
    const float* b = s_b[s & 1];
    float* nb = s_b[(s & 1) ^ 1];
    for (int j = threadIdx.x; j < cnt; j += kThreads)
      nb[j] = j >= d && base + j >= d ? add(mul(sc.p[s], b[j - d]), b[j])
                                      : b[j];
    __syncthreads();
  }
  for (int j = kTile - 1 + threadIdx.x; j < cnt; j += kThreads)
    o[base + j] = s_b[kScanSteps & 1][j];
}

// One later step of the scan, d >= kTile: out[i] = pd * in[i - d] + in[i]
// where i >= d, else in[i].
__global__ void __launch_bounds__(kThreads)
scan_step_kernel(const float* __restrict__ in,
                 const int32_t* __restrict__ i32, int i_stride, int L,
                 int tiles, int n_total, int d, float pd,
                 float* __restrict__ out) {
  const int row = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x % tiles) * kTile;
  const float* x = in + (int64_t)row * L;
  float* o = out + (int64_t)row * L;
  const int live = tile_live(i32 + (int64_t)row * i_stride, L, tile0,
                             n_total, o);
  for (int p = tile0 + threadIdx.x; p < live; p += kThreads)
    o[p] = p >= d ? add(mul(pd, x[p - d]), x[p]) : x[p];
}

template <int kAlg, bool kVib>
void fm_start(unsigned blocks, cudaStream_t s, const float* f32,
              const int32_t* i32, int L, int tiles, int n_total, int fade,
              int K1, int K2, const BankConsts& c, float* out) {
  fm_bank_kernel<kAlg, kVib><<<blocks, kThreads, 0, s>>>(
      f32, i32, L, tiles, n_total, fade, K1, K2, c, out);
}

// the grid (count notes x tiles of L), or 0 where it would not fit
unsigned grid_of(int count, int L, int* tiles) {
  *tiles = (L + kTile - 1) / kTile;
  const long long blocks = (long long)count * *tiles;
  return blocks > 0 && blocks < (1LL << 31) ? (unsigned)blocks : 0u;
}

bool consts_of(const float* consts, int n_consts, BankConsts* c) {
  if (n_consts * sizeof(float) != sizeof(BankConsts)) return false;
  memcpy(c, consts, sizeof(BankConsts));
  return true;
}

}  // namespace

// One FM bucket on `stream`: out f32[count, L] from its rows f32
// [count, 36] and i32 [count, 26] (device pointers), algorithm `alg`
// (1-3) and the vibrato flag; `consts` is a HOST array of the
// BankConsts floats (copied into the kernel's arguments), 1 <= K1, K2 <=
// 63, or K1 = K2 = 0 for the signal unfiltered (the lowpasses run as
// passes of their own).  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a bad argument.
extern "C" int vb_fm_launch(const float* f32, const int32_t* i32, int count,
                            int L, int n_total, int alg, int vib, int fade,
                            int K1, int K2, const float* consts, int n_consts,
                            float* out, void* stream) {
  BankConsts c;
  int tiles;
  const unsigned blocks = grid_of(count, L, &tiles);
  const bool unfiltered = K1 == 0 && K2 == 0;
  if (!blocks || alg < 1 || alg > 3 ||
      (!unfiltered && (K1 < 1 || K1 > kMaxTaps || K2 < 1 || K2 > kMaxTaps)) ||
      !consts_of(consts, n_consts, &c))
    return (int)cudaErrorInvalidValue;
  if (unfiltered) {
    c.w1[0] = c.w2[0] = 1.0f;
    K1 = K2 = 1;
  }
  cudaStream_t s = (cudaStream_t)stream;
  void (*start)(unsigned, cudaStream_t, const float*, const int32_t*, int,
                int, int, int, int, int, const BankConsts&, float*);
  if (vib)
    start = alg == 1 ? &fm_start<1, true> : alg == 2 ? &fm_start<2, true>
                                                     : &fm_start<3, true>;
  else
    start = alg == 1 ? &fm_start<1, false> : alg == 2 ? &fm_start<2, false>
                                                      : &fm_start<3, false>;
  start(blocks, s, f32, i32, L, tiles, n_total, fade, K1, K2, c, out);
  return (int)cudaGetLastError();
}

// One PSG bucket on `stream`: out f32[count, L] from its rows f32
// [count, 10] and i32 [count, 10] and the LFSR orbit tables (orbit f32,
// base / pos / len i32, each [2**15]; device pointers); `consts` as for
// vb_fm_launch (w1 the lowpass), 1 <= K <= 63, or 0 for the signal
// unfiltered.
extern "C" int vb_psg_launch(const float* f32, const int32_t* i32, int count,
                             int L, int n_total, const float* orbit,
                             const int32_t* orbit_base,
                             const int32_t* orbit_pos,
                             const int32_t* orbit_len, int fade, int K,
                             const float* consts, int n_consts, float* out,
                             void* stream) {
  BankConsts c;
  int tiles;
  const unsigned blocks = grid_of(count, L, &tiles);
  if (!blocks || K < 0 || K > kMaxTaps || !consts_of(consts, n_consts, &c))
    return (int)cudaErrorInvalidValue;
  if (K == 0) {
    c.w1[0] = 1.0f;
    K = 1;
  }
  psg_bank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f32, i32, orbit, orbit_base, orbit_pos, orbit_len, L, tiles, n_total,
      fade, K, c, out);
  return (int)cudaGetLastError();
}

// One lowpass pass on `stream` as an FIR: out f32[count, L] = the FIR of
// weights `w` (a HOST array of K floats, 1 <= K <= 63) along each row of
// in f32[count, L], zero from each row's clamp on; n and start are the
// first two ints of each row of i32 [count, i_stride] (device pointers).
extern "C" int vb_fir_launch(const float* in, const int32_t* i32,
                             int i_stride, int count, int L, int n_total,
                             int K, const float* w, float* out,
                             void* stream) {
  Taps t = {};
  int tiles;
  const unsigned blocks = grid_of(count, L, &tiles);
  if (!blocks || i_stride < 2 || K < 1 || K > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  memcpy(t.w, w, K * sizeof(float));
  fir_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, i32, i_stride, L, tiles, n_total, K, t, out);
  return (int)cudaGetLastError();
}

// One launch of a lowpass pass as the doubling scan, rows and clamp as
// for vb_fir_launch; `coefs` is a HOST array (c, p[0], p[1], ...) of
// n_coefs floats (ScanConsts, continued).  d = 0: the first pass, b = c *
// in and the steps d < kTile; d = kTile, 2 kTile, ... < L: that step.
extern "C" int vb_scan_launch(const float* in, const int32_t* i32,
                              int i_stride, int count, int L, int n_total,
                              int d, const float* coefs, int n_coefs,
                              float* out, void* stream) {
  int tiles;
  const unsigned blocks = grid_of(count, L, &tiles);
  const int s = d == 0 ? kScanSteps - 1 : 31 - __builtin_clz((unsigned)d);
  if (!blocks || i_stride < 2 || d < 0 || (d && (d < kTile || d >= L ||
                                                (d & (d - 1)))) ||
      n_coefs < s + 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 0) {
    ScanConsts sc;
    memcpy(&sc, coefs, sizeof(sc));
    scan_tile_kernel<<<blocks, kThreads, 0, st>>>(in, i32, i_stride, L,
                                                  tiles, n_total, sc, out);
  } else {
    scan_step_kernel<<<blocks, kThreads, 0, st>>>(
        in, i32, i_stride, L, tiles, n_total, d, coefs[1 + s], out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
