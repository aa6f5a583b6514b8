// The tape's scan engine on Hopper (sm_90a): the per-sample playback
// recurrence of TapeTUC with its position, inertia and splice state.
//
// Replaces no Pallas kernel: the JAX package runs this engine as a
// lax.scan over output samples, audio_suite_tpu/ops/varispeed.py:126-224
// (tape_scan_render).  Its step, for sample i with the carried state
// (whole, frac, speed, rem, sidx):
//
//   w = whole mod n (floored);  sec = #{k : starts[k] <= w} - 1, clipped
//   [s0, e0) = the section (e0 = s0 + 1 where ends[sec] <= s0)
//   idx0, fr = the read index of w + frac / 2^22 in the section, forward
//              or reversed (_read_index: the reverse read in (-1, 0)
//              keeps idx0 = 0 and a negative fraction), idx0 clipped to
//              [0, n - 1]
//   s = (1 - fr) * audio[idx0] + fr * audio[min(idx0 + 1, n - 1)]
//   anti-click: dmin = min_k |idx0 - b_k|; where dmin < smooth_len,
//              s *= max(0, 1 - strength * (smooth_len - dmin) / smooth_len)
//   splice:    a hit (idx0 on a boundary) with rem <= 0 sets rem = E,
//              sidx = 0; while rem > 0 and sidx < E, s *= env[sidx],
//              rem -= 1, sidx += 1
//   out[i] = clip(s, -1, 1)
//   speed = speeds_q[sec], or with inertia speed += q(((target - speed)
//              * alpha)), q the rounding to the 2^-22 grid
//   inc = rint(speed * mod_q[i] * 2^22);  frac += inc; whole = w + the
//              carry out of frac's 22 bits
//
// Design.  The chain (whole, frac, speed, rem, sidx) never reads the
// audio, so it runs apart from the read:
//
// - tape_chain_kernel: one warp walks the T steps with the section and
//   boundary tables in shared memory and writes, per sample, idx0, fr and
//   the splice envelope's index (-1 where no envelope applies), and at
//   the end the final state.  Its 32 lanes all compute every step alike,
//   so none diverges; lane k brings in mod_q of step k of a 32-step group
//   a group ahead (one coalesced load: off the chain) and keeps step k's
//   outputs, which leave in one coalesced store per array.  The section
//   and the boundary test are cached: the section count #{starts <= w} is
//   constant on the interval between the neighbouring starts around w,
//   and idx0 can hit no boundary while it stays strictly between its two
//   neighbouring boundaries.  The common step (whole in [0, 2n), w in the
//   section's interval and inside the section, idx0 inside its boundary
//   interval) is a straight line of selects with one branch; any other
//   step searches the tables again (over the whole table, in any order),
//   which gives the JAX package's count and hit exactly.  The splice and
//   inertia switches are template arguments, so the step holds no branch
//   on them, and the step loop is unrolled 4 times.
// - tape_read_kernel: one thread a sample reads, applies the anti-click
//   gain (a function of idx0 alone), then the envelope, and clips, in the
//   step's order.
//
// Rounding.  Every f32 operation is written with __f*_rn, which nvcc never
// contracts into a fused multiply-add, so each rounds once, in the JAX
// step's order; rint and the f32-to-int conversion round half to even
// (rintf, __float2int_rn), like jnp.rint; the integer ops are the int32
// ops of the step.  The result is bit-equal to tape_scan_render_plain
// (audio_suite_torch/ops/varispeed.py).
//
// Limits.  The function's bound is its bytes: the read is a gather of 8
// bytes and 16 bytes of streams a sample, microseconds at the full tape.
// This design is held far above it by its own dependency chain: a step
// cannot start before the one before it has advanced the position (whole
// mod n, the section and its speed, with inertia the speed's update, the
// increment's two multiplies and conversion, the carry), one warp issues
// the chain's instructions one after another with no other warp to hide
// their latencies, and the common step's one branch waits on the read
// index it tests.  The position is an integer sum, so a warp could also
// advance 32 steps at once by a prefix sum where no step leaves its
// section: a later design.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFracBits = 22;
constexpr int kPosOne = 1 << kFracBits;
constexpr float kPosOneF = 4194304.0f;          // 2^22
constexpr float kPosInvF = 2.384185791015625e-07f;  // 2^-22, exact
constexpr int kReadThreads = 256;
// shared words of the tables: 4 per section and 1 per boundary (48 KB)
constexpr int kMaxTableWords = 12288;

struct Consts {
  int n, S, B, E;
  int anticlick, smooth_len, splice, inertia;
  float strength, inv_smooth, alpha;
};

__device__ __forceinline__ int floor_mod(int x, int m) {  // m > 0
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// the 2^-22 grid rounding (fixq.quantize_f32): exact scale, rint, exact
// scale back
__device__ __forceinline__ float quantize(float x) {
  return __fmul_rn(rintf(__fmul_rn(x, kPosOneF)), kPosInvF);
}

// The scan's carried state and its caches.  step() runs a straight line of
// selects for the common step (the position in [0, 2n), its section
// unchanged, the read index strictly between its two neighbouring
// boundaries) and takes one branch, to general(), for any other.
template <bool kSplice, bool kInertia>
struct Chain {
  const int* starts;
  const int* ends;
  const float* speeds;
  const int* rev;
  const int* bnd;
  Consts c;
  // carried state
  int whole, frac, rem, sidx;
  float speed;
  // section cache: the count holds for lo <= w < hi (INT_MIN / INT_MAX:
  // no start on that side; w lies in [0, n) with n < 2^31)
  int lo, hi;
  int s0, e0, len, rv;
  float target;
  // boundary cache: idx0 hits none while blo < idx0 < bhi
  int blo, bhi;

  __device__ __forceinline__ void find_section(int w) {
    int cnt = 0;
    lo = INT_MIN;
    hi = INT_MAX;
    for (int k = 0; k < c.S; ++k) {
      const int s = starts[k];
      if (w >= s) {
        ++cnt;
        lo = s > lo ? s : lo;
      } else {
        hi = s < hi ? s : hi;
      }
    }
    int sec = cnt - 1;
    sec = sec < 0 ? 0 : (sec > c.S - 1 ? c.S - 1 : sec);
    s0 = starts[sec];
    e0 = ends[sec] <= s0 ? s0 + 1 : ends[sec];
    len = e0 - s0;
    rv = rev[sec];
    target = speeds[sec];
  }

  // the boundary test by search; on a hit the cache is left empty, so
  // the next step searches again
  __device__ __forceinline__ bool find_boundary(int idx0) {
    bool hit = false;
    blo = INT_MIN;
    bhi = INT_MAX;
    for (int k = 0; k < c.B; ++k) {
      const int b = bnd[k];
      if (b == idx0) {
        hit = true;
      } else if (b < idx0) {
        blo = b > blo ? b : blo;
      } else {
        bhi = b < bhi ? b : bhi;
      }
    }
    if (hit) blo = bhi = idx0;
    return hit;
  }

  // _read_index of (w, frac) in the cached section, clipped to [0, n - 1]
  __device__ __forceinline__ void read_index(int local, int& idx0,
                                             float& fr) const {
    const int idx_f = s0 + local;
    const int a = e0 - 1 - local;
    int idx_r = frac > 0 ? a - 1 : a;
    int num_r = frac > 0 ? kPosOne - frac : 0;
    if (a == 0 && frac > 0) {          // read position in (-1, 0)
      idx_r = 0;
      num_r = -frac;
    }
    idx0 = rv ? idx_r : idx_f;
    fr = __fmul_rn((float)(rv ? num_r : frac), kPosInvF);
    idx0 = idx0 < 0 ? 0 : (idx0 > c.n - 1 ? c.n - 1 : idx0);
  }

  // the step's start for any state: w = whole mod n, the section, the
  // read index and the boundary test, all by search where needed
  __device__ __forceinline__ void general(int& idx0, float& fr, bool& hit) {
    int w = whole;
    if (w < 0 || w >= c.n) w = floor_mod(w, c.n);
    if (w < lo || w >= hi) find_section(w);
    whole = w;
    const int x = w - s0;
    read_index((x >= 0 && x < len) ? x : floor_mod(x, len), idx0, fr);
    hit = kSplice && !(idx0 > blo && idx0 < bhi) && find_boundary(idx0);
  }

  // One step with the step's mod value: the sample's read index,
  // fraction and envelope index (-1: none), and the state advanced.
  __device__ __forceinline__ void step(float mq, int& idx0, float& fr,
                                       int& gi) {
    const int w = whole >= c.n ? whole - c.n : whole;
    const int x = w - s0;
    read_index(x, idx0, fr);
    bool hit = false;
    const bool common = (unsigned)whole < 2u * (unsigned)c.n && w >= lo &&
                        w < hi && (unsigned)x < (unsigned)len &&
                        (!kSplice || (idx0 > blo && idx0 < bhi));
    if (common) {
      whole = w;
    } else {
      general(idx0, fr, hit);
    }
    gi = -1;
    if (kSplice) {
      if (hit && rem <= 0) {
        rem = c.E;
        sidx = 0;
      }
      const bool apply = rem > 0 && sidx < c.E;
      gi = apply ? (sidx < 0 ? 0 : (sidx > c.E - 1 ? c.E - 1 : sidx)) : -1;
      rem -= apply;
      sidx += apply;
    }
    if (kInertia)
      speed = __fadd_rn(speed, quantize(__fmul_rn(__fsub_rn(target, speed),
                                                  c.alpha)));
    else
      speed = target;
    const int inc = __float2int_rn(__fmul_rn(__fmul_rn(speed, mq), kPosOneF));
    const int f = frac + inc;
    const int carry = f >> kFracBits;
    whole += carry;
    frac = f - (carry << kFracBits);
  }
};

// One warp: all lanes load the tables, then walk the chain together, each
// lane computing every step alike (the same values, so no lane diverges).
// Lane k holds mod_q of step k of a 32-step group, loaded a group ahead
// with one coalesced load, and hands it to the others by shuffle; lane k
// keeps step k's outputs, and the group's outputs go out in one coalesced
// store per array.  state_in / state_out: (whole, frac, speed's bits, rem,
// sidx).
template <bool kSplice, bool kInertia>
__global__ void __launch_bounds__(32)
    tape_chain_kernel(const float* __restrict__ mod_q, long long T,
                      const int* __restrict__ starts_g,
                      const int* __restrict__ ends_g,
                      const float* __restrict__ speeds_g,
                      const unsigned char* __restrict__ rev_g,
                      const int* __restrict__ bnd_g, Consts c,
                      const int* __restrict__ state_in,
                      int* __restrict__ idx0_out, float* __restrict__ fr_out,
                      int* __restrict__ gi_out, int* __restrict__ state_out) {
  extern __shared__ int smem[];
  int* starts = smem;
  int* ends = starts + c.S;
  float* speeds = reinterpret_cast<float*>(ends + c.S);
  int* rev = reinterpret_cast<int*>(speeds + c.S);
  int* bnd = rev + c.S;
  const int lane = threadIdx.x;
  for (int k = lane; k < c.S; k += 32) {
    starts[k] = starts_g[k];
    ends[k] = ends_g[k];
    speeds[k] = speeds_g[k];
    rev[k] = rev_g[k] != 0;
  }
  for (int k = lane; k < c.B; k += 32) bnd[k] = bnd_g[k];
  __syncwarp();

  Chain<kSplice, kInertia> ch;
  ch.starts = starts;
  ch.ends = ends;
  ch.speeds = speeds;
  ch.rev = rev;
  ch.bnd = bnd;
  ch.c = c;
  ch.whole = state_in[0];
  ch.frac = state_in[1];
  ch.speed = __int_as_float(state_in[2]);
  ch.rem = state_in[3];
  ch.sidx = state_in[4];
  ch.lo = 1;                            // empty: the first step searches
  ch.hi = 0;
  ch.blo = ch.bhi = 0;                  // likewise
  ch.s0 = ch.e0 = ch.len = ch.rv = 0;
  ch.target = 0.0f;

  float mcur = lane < T ? __ldg(mod_q + lane) : 0.0f;
  for (long long base = 0; base < T; base += 32) {
    const long long jn = base + 32 + lane;
    const float mnext = jn < T ? __ldg(mod_q + jn) : 0.0f;
    const int steps = T - base < 32 ? (int)(T - base) : 32;
    int o_idx0 = 0, o_gi = -1;
    float o_fr = 0.0f;
#pragma unroll 4
    for (int k = 0; k < steps; ++k) {
      const float mq = __shfl_sync(0xffffffffu, mcur, k);
      int idx0, gi;
      float fr;
      ch.step(mq, idx0, fr, gi);
      o_idx0 = lane == k ? idx0 : o_idx0;
      o_fr = lane == k ? fr : o_fr;
      o_gi = lane == k ? gi : o_gi;
    }
    if (lane < steps) {
      idx0_out[base + lane] = o_idx0;
      fr_out[base + lane] = o_fr;
      gi_out[base + lane] = o_gi;
    }
    mcur = mnext;
  }
  if (lane == 0) {
    state_out[0] = ch.whole;
    state_out[1] = ch.frac;
    state_out[2] = __float_as_int(ch.speed);
    state_out[3] = ch.rem;
    state_out[4] = ch.sidx;
  }
}

// One thread a sample: the read, the anti-click gain, the envelope, the
// clip (NaN passes the clip, as in jnp.clip and torch.clamp).
__global__ void __launch_bounds__(kReadThreads)
    tape_read_kernel(const float* __restrict__ audio,
                     const int* __restrict__ idx0,
                     const float* __restrict__ fr,
                     const int* __restrict__ gi,
                     const int* __restrict__ bnd_g,
                     const float* __restrict__ env, Consts c,
                     float* __restrict__ out, long long T) {
  extern __shared__ int bnd[];
  for (int k = threadIdx.x; k < c.B; k += blockDim.x) bnd[k] = bnd_g[k];
  __syncthreads();
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= T) return;
  int i0 = idx0[j];
  i0 = i0 < 0 ? 0 : (i0 > c.n - 1 ? c.n - 1 : i0);
  const int i1 = i0 + 1 < c.n ? i0 + 1 : c.n - 1;
  const float f = fr[j];
  float s = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), __ldg(audio + i0)),
                      __fmul_rn(f, __ldg(audio + i1)));
  if (c.anticlick && c.B > 0 && c.smooth_len > 0) {
    int dmin = 1 << 30;
    for (int k = 0; k < c.B; ++k) {
      const int d = abs(i0 - bnd[k]);
      dmin = d < dmin ? d : dmin;
    }
    if (dmin < c.smooth_len) {
      const float x = __fmul_rn((float)(c.smooth_len - dmin), c.inv_smooth);
      float g = __fsub_rn(1.0f, __fmul_rn(c.strength, x));
      g = g < 0.0f ? 0.0f : g;
      s = __fmul_rn(s, g);
    }
  }
  const int e = gi[j];
  if (e >= 0) s = __fmul_rn(s, __ldg(env + e));
  s = s < -1.0f ? -1.0f : s;
  s = s > 1.0f ? 1.0f : s;
  out[j] = s;
}

}  // namespace

// The scan engine on `stream`: out f32[T] and the final state from
// state_in (5 int32: whole, frac, speed's f32 bits, rem, sidx) into
// state_out (5 int32), through the scratch idx0 i32[T], fr f32[T] and
// gi i32[T].  audio f32[n], mod_q f32[T], starts/ends i32[S], speeds_q
// f32[S], reverse u8[S], boundaries i32[B] and env f32[E] are device
// pointers; inv_smooth is the f32 1 / max(1, smooth_len).  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for n < 1,
// S < 1, negative sizes or tables past kMaxTableWords.
extern "C" int ts_launch(const float* audio, int n, const float* mod_q,
                         long long T, const int* starts, const int* ends,
                         const float* speeds_q, const unsigned char* reverse,
                         int S, const int* boundaries, int B,
                         const float* env, int E, int anticlick_on,
                         int smooth_len, float strength, float inv_smooth,
                         int splice_on, int inertia_on, float alpha_q,
                         const int* state_in, int* idx0, float* fr, int* gi,
                         float* out, int* state_out, void* stream) {
  if (n < 1 || S < 1 || B < 0 || E < 0 || T < 0 ||
      4LL * S + B > kMaxTableWords)
    return (int)cudaErrorInvalidValue;
  Consts c{n, S, B, E, anticlick_on != 0, smooth_len,
           splice_on != 0 && B > 0, inertia_on != 0, strength, inv_smooth,
           alpha_q};
  cudaStream_t s = (cudaStream_t)stream;
  decltype(&tape_chain_kernel<false, false>) chain =
      c.splice ? (c.inertia ? &tape_chain_kernel<true, true>
                            : &tape_chain_kernel<true, false>)
               : (c.inertia ? &tape_chain_kernel<false, true>
                            : &tape_chain_kernel<false, false>);
  chain<<<1, 32, (size_t)(4 * S + B) * sizeof(int), s>>>(
      mod_q, T, starts, ends, speeds_q, reverse, boundaries, c, state_in,
      idx0, fr, gi, state_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T == 0) return (int)err;
  const long long blocks = (T + kReadThreads - 1) / kReadThreads;
  tape_read_kernel<<<(unsigned)blocks, kReadThreads,
                     (size_t)B * sizeof(int), s>>>(audio, idx0, fr, gi,
                                                   boundaries, env, c, out,
                                                   T);
  return (int)cudaGetLastError();
}

extern "C" const char* ts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
