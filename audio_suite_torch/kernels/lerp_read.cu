// Linear fractional read of a tape on Hopper (sm_90a).
//
// Replaces the TPU kernel audio_suite_tpu/ops/pallas_read.py:
// _read_kernel_body (its entry, pallas_read_lerp, has no caller in the JAX
// package, whose tape reads through the XLA varispeed._tape_read_blockwise
// with the same contract).  It computes the read's contract in the tape's
// coordinates, not the TPU's VMEM slab:
//
//   i0 = clamp(idx0[j], 0, n - 1);  i1 = min(i0 + 1, n - 1)
//   out[j] = (1 - fr[j]) * audio[i0] + fr[j] * audio[i1]
//
// The TPU kernel streamed a slab of audio rows into VMEM per chunk and
// flagged the 128-sample blocks whose positions left it, for a gather to
// patch.  A thread here gathers its own two samples, so there is no slab,
// no flag and no patch: every sample comes from this kernel.
//
// Rounding.  The arithmetic is written with __fsub_rn / __fmul_rn /
// __fadd_rn, which nvcc never contracts into a fused multiply-add, so each
// operation rounds once, in the order above: the result is bit-equal to
// the plain PyTorch version (audio_suite_torch/ops/lerp_read.py) and to
// NumPy's float32 evaluation of the same formula.
//
// Bound on this card: memory.  Per output sample it reads 4 bytes of idx0
// and 4 of fr (coalesced: thread j reads element j) and writes 4 of out;
// the two audio reads go through the read-only cache (__ldg).  Tape
// positions are near-monotone, advancing at most a few samples per output,
// so the threads of a warp hit a handful of neighbouring cache lines and
// the audio is read from device memory about once: ~16 bytes per sample.
//
// The second kernel, scrub_read_kernel, is the scrub engine's read fused
// with the step after it.  The JAX package's scrub reaches no Pallas
// kernel: it reads through XLA (audio_suite_tpu/models/scrub.py:411-512,
// _read_blockwise_heads, and ops/fixq.py:345, gather_linear_wrap), with
// positions that wrap around the tape and one to three read heads at
// fixed offsets, then applies the head gain, the block envelope and PCM16
// (models/scrub.py:639-651).  This kernel stands in for all of that.
// For sample g of t0 <= g < t1, with w = whole[g] and the heads' offsets
// (ow_h, of_h):
//
//   summed (integer offsets, the blockwise read, form A):
//     p_h = (w + ow_h) mod n
//     x0 = sum_h audio[p_h];  x1 = sum_h audio[(p_h + 1) mod n]
//     f = frac[g] * 2^-22;    r = x0 * (1 - f) + x1 * f
//   per head (form B):
//     f2 = frac[g] + of_h;  c = f2 >> 22;  p_h = (w + ow_h + c) mod n
//     f = (f2 - (c << 22)) * 2^-22
//     r = sum_h ((1 - f) * audio[p_h] + f * audio[(p_h + 1) mod n])
//   y = (r * gain) * env[g / block_size]
//   out[g] = y  (f32)  or  int16(clamp(rint(y * 32768), -32768, 32767))
//
// Both sums start from 0 and run in head order, as in the JAX package;
// every operation rounds once, in this order (__f*_rn), so the kernel is
// bit-equal to scrub_read_plain, which is heads_read_plain followed by the
// envelope and PCM16 step.
//
// Bound: bytes.  The tape once (4n), whole and frac (8 B a sample), the
// output (2 B a sample in PCM16, 4 in f32) and the envelope (4 B a block):
// at bench config 2 (n 480 000, T 1 439 744, 1 406 blocks) 16.32 MB in
// PCM16, 4.87 us at 3.35 TB/s, 19.20 MB in f32, 5.73 us; ~18 f32
// operations a sample are 0.39 us at 67 TFLOP/s.  The read is a chain of
// two dependent memory round trips (positions, then the taps they
// address), so what holds it is latency: the design keeps many gathers
// in flight and the instructions between them few.
//
// - Four samples a thread, kThreads apart (kVec; a block covers 1 024
//   samples): each warp-wide load of whole and frac is one 128-byte row,
//   and each warp-wide gather covers 32 neighbouring samples, one or two
//   cache lines of a head's tape.  A thread's eight samples side by side
//   (16-byte loads) would spread each warp-wide gather over ~7 lines.
// - One branch-free block from the positions to the arithmetic: the head
//   count is a template argument, every tap index is computed first, then
//   all 2 x heads x 4 gathers are issued together, then the sums.  Runtime
//   branches between a thread's taps (a head loop, a carry check, a mod)
//   split the block and serialise the gathers' round trips.
// - 32-bit index arithmetic.  The launcher reduces each head offset mod n
//   on the host; where positions lie in [0, 2n) (all of bench config 2's
//   do) one conditional subtraction reduces w mod n, so p_h = (w mod n) +
//   (ow_h mod n) + c lies in [0, 2n) for a carry c of 0 or 1 (which fits
//   an unsigned int for n < 2^31) and one more conditional subtraction
//   wraps it.  Form A has no carry; form B's is 0 or 1 whenever frac and
//   of_h lie in [0, 2^22), as every position of a render does.  Any other
//   position takes a 32-bit mod, any other carry (a fraction outside that
//   range) the 64-bit mod with Python's sign rule, each in a per-thread
//   branch that config 2 never takes: a 64-bit mod per head and sample
//   would cost about as much as the memory time.
// - The epilogue fused: each sample's envelope value (block g / bs, a
//   shift where bs is a power of two) is loaded beside its position, and
//   PCM16 is written directly: no f32 buffer, no repeat of the envelope,
//   no second pass.  The launch covers [t0, t1) of the output, so the
//   live-control render launches once per control segment into one
//   buffer.
//
// Tried and measured (read_ab.py): staging each head's tape window for a
// tile in shared memory (a block min / max, coalesced loads, gathers from
// shared memory) and a persistent grid were both slower than direct
// gathers through L1; two, eight or sixteen samples a thread, and a
// minimum of four blocks an SM, slower than four with no minimum (warm);
// an unsigned division for every block size 20% slower than the shift.
//
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeads = 3;
constexpr int kFracBits = 22;
constexpr float kPosInv = 1.0f / (1 << kFracBits);
constexpr int kVec = 4;                     // samples a thread of scrub_read
constexpr int kTile = kThreads * kVec;      // samples a block

struct Heads {
  int whole[kMaxHeads];   // each head's whole offset, reduced mod n
  int frac[kMaxHeads];
};

// (pw + ow + c) mod n for pw and ow in [0, n): with kWide any carry c, by
// a 64-bit mod with Python's sign rule; else c is 0 or 1, the sum lies in
// [0, 2n) (which fits an unsigned int for n < 2^31), and one conditional
// subtraction wraps it
template <bool kWide>
__device__ __forceinline__ unsigned tap(int pw, int ow, int c, int n) {
  if (kWide) {
    const int64_t r = ((int64_t)pw + ow + c) % n;
    return (unsigned)(r < 0 ? r + n : r);
  }
  const unsigned p = (unsigned)pw + (unsigned)ow + (unsigned)c;
  return p >= (unsigned)n ? p - (unsigned)n : p;
}

// The read of a thread's kVec samples, before the gain: every tap index
// first, then every gather, then the arithmetic, in one branch-free block
// so that the compiler issues the thread's 2 * kHeads * kVec gathers
// together
template <int kHeads, bool kSummed, bool kWide>
__device__ __forceinline__ void read_vec(const float* __restrict__ audio,
                                         int n, const Heads& heads,
                                         const int (&pw)[kVec],
                                         const int (&fq)[kVec],
                                         float (&r)[kVec]) {
  unsigned p0[kVec][kHeads], p1[kVec][kHeads];
  int fr[kVec][kHeads];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      int c = 0;
      fr[k][h] = fq[k];
      if (!kSummed) {
        // int32 sums wrap, as the plain version's do
        const unsigned f2 = (unsigned)fq[k] + (unsigned)heads.frac[h];
        c = (int)f2 >> kFracBits;
        fr[k][h] = (int)(f2 - ((unsigned)c << kFracBits));
      }
      p0[k][h] = tap<kWide>(pw[k], heads.whole[h], c, n);
      p1[k][h] = p0[k][h] + 1 == (unsigned)n ? 0u : p0[k][h] + 1;
    }
  }
  float a0[kVec][kHeads], a1[kVec][kHeads];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      a0[k][h] = __ldg(audio + p0[k][h]);
      a1[k][h] = __ldg(audio + p1[k][h]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (kSummed) {
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        x0 = __fadd_rn(x0, a0[k][h]);
        x1 = __fadd_rn(x1, a1[k][h]);
      }
      const float f = __fmul_rn((float)fr[k][0], kPosInv);
      r[k] = __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, f)), __fmul_rn(x1, f));
    } else {
      float y = 0.0f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float f = __fmul_rn((float)fr[k][h], kPosInv);
        y = __fadd_rn(y, __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), a0[k][h]),
                                   __fmul_rn(f, a1[k][h])));
      }
      r[k] = y;
    }
  }
}

// A block's tile is kTile samples from the 32-sample boundary at or below
// t0; a thread takes its samples kThreads apart, so each warp-wide load,
// gather and store covers 32 neighbouring samples: a 128-byte row of whole
// and frac and, positions being near-monotone, one or two cache lines of
// each head's tape.  Indices are 32-bit (the launcher checks t1 < 2^30).
template <int kHeads, bool kSummed, bool kI16>
__global__ void __launch_bounds__(kThreads)
scrub_read_kernel(const float* __restrict__ audio, int n,
                  const int32_t* __restrict__ whole,
                  const int32_t* __restrict__ frac,
                  const float* __restrict__ env, int bs, int bs_shift,
                  void* __restrict__ out, int t0, int t1, Heads heads,
                  float gain) {
  const int g0 = (t0 & ~31) + (int)blockIdx.x * kTile + (int)threadIdx.x;
  const unsigned len = (unsigned)(t1 - t0);
  int pw[kVec], fq[kVec];
  unsigned b[kVec];
  float e[kVec];
  bool in[kVec];
  // envelope block g / bs: a shift where bs is a power of two (bench
  // config 2's 1 024; the division took 20% more time there, read_ab.py)
  if (bs_shift >= 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      b[k] = (unsigned)(g0 + k * kThreads) >> bs_shift;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      b[k] = (unsigned)(g0 + k * kThreads) / (unsigned)bs;
  }
  // whole, frac and the envelope of each sample, issued together; a
  // sample outside [t0, t1) reads nothing and stores nothing
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int g = g0 + k * kThreads;
    in[k] = (unsigned)(g - t0) < len;
    pw[k] = in[k] ? __ldg(whole + g) : 0;
    fq[k] = in[k] ? __ldg(frac + g) : 0;
    e[k] = in[k] ? __ldg(env + b[k]) : 0.0f;
  }
  // whole mod n: where a thread's positions lie in [0, 2n), as bench
  // config 2's all do (0 .. 444 248 for n 480 000), one conditional
  // subtraction; a thread with any other position takes a 32-bit mod, and
  // form B's carries other than 0 or 1 (fractions outside [0, 2^22)) the
  // 64-bit tap, each in a branch of its own
  bool rare = false;
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    rare |= pw[k] < 0 || (unsigned)pw[k] >= 2u * (unsigned)n;
  if (rare) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int w = pw[k] % n;
      pw[k] = w < 0 ? w + n : w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      pw[k] = pw[k] >= n ? pw[k] - n : pw[k];
  }
  bool wide = false;
  if (!kSummed) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const unsigned f2 = (unsigned)fq[k] + (unsigned)heads.frac[h];
        wide |= (unsigned)((int)f2 >> kFracBits) > 1u;
      }
    }
  }
  float r[kVec];
  if (wide) {
    read_vec<kHeads, kSummed, true>(audio, n, heads, pw, fq, r);
  } else {
    read_vec<kHeads, kSummed, false>(audio, n, heads, pw, fq, r);
  }

  // gain, envelope, PCM16 (round half to even, as torch; the conversion
  // saturates, then the clamp)
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float y = __fmul_rn(__fmul_rn(r[k], gain), e[k]);
    const int g = g0 + k * kThreads;
    if (!in[k]) continue;
    if (kI16) {
      const int v = __float2int_rn(__fmul_rn(y, 32768.0f));
      static_cast<int16_t*>(out)[g] = (int16_t)max(-32768, min(32767, v));
    } else {
      static_cast<float*>(out)[g] = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lerp_read_kernel(const float* __restrict__ audio,
                 const int32_t* __restrict__ idx0,
                 const float* __restrict__ fr, float* __restrict__ out,
                 int64_t T, int n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= T) return;
  int i0 = idx0[j];
  i0 = i0 < 0 ? 0 : (i0 > n - 1 ? n - 1 : i0);
  const int i1 = i0 + 1 < n ? i0 + 1 : n - 1;
  const float f = fr[j];
  const float x0 = __ldg(audio + i0);
  const float x1 = __ldg(audio + i1);
  out[j] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), x0), __fmul_rn(f, x1));
}

template <int kHeads>
void sr_start(bool summed, bool i16, unsigned blocks, cudaStream_t stream,
              const float* audio, int n, const int32_t* whole,
              const int32_t* frac, const float* env, int bs, int bs_shift,
              void* out, int t0, int t1, const Heads& heads, float gain) {
  if (summed && i16)
    scrub_read_kernel<kHeads, true, true><<<blocks, kThreads, 0, stream>>>(
        audio, n, whole, frac, env, bs, bs_shift, out, t0, t1, heads, gain);
  else if (summed)
    scrub_read_kernel<kHeads, true, false><<<blocks, kThreads, 0, stream>>>(
        audio, n, whole, frac, env, bs, bs_shift, out, t0, t1, heads, gain);
  else if (i16)
    scrub_read_kernel<kHeads, false, true><<<blocks, kThreads, 0, stream>>>(
        audio, n, whole, frac, env, bs, bs_shift, out, t0, t1, heads, gain);
  else
    scrub_read_kernel<kHeads, false, false><<<blocks, kThreads, 0, stream>>>(
        audio, n, whole, frac, env, bs, bs_shift, out, t0, t1, heads, gain);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers: audio f32[n] with 0 < n < 2^31, idx0 i32[T],
// fr f32[T], out f32[T].
extern "C" int lr_launch(const float* audio, const int32_t* idx0,
                         const float* fr, float* out, long long T, int n,
                         void* stream) {
  if (T <= 0) return 0;
  const long long blocks = (T + kThreads - 1) / kThreads;
  lerp_read_kernel<<<(unsigned)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(audio, idx0, fr, out,
                                             (int64_t)T, n);
  return (int)cudaGetLastError();
}

// The scrub's fused read on `stream`: out[g] for t0 <= g < t1 (the
// formula above); returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head count outside 1..3 or a bad size.
// audio f32[n] with 0 < n < 2^31, whole/frac i32[>= t1], env f32
// [> (t1 - 1) / block_size] and out (int16 with out_i16, else f32)
// [>= t1] are device pointers, 0 <= t0 <= t1 < 2^30; off_whole/off_frac
// are HOST arrays of `count` offsets (copied into the kernel's
// arguments); `summed` selects form A, which takes only off_whole (the
// caller checks every off_frac is 0).
extern "C" int sr_launch(const float* audio, int n, const int32_t* whole,
                         const int32_t* frac, const float* env,
                         int block_size, void* out, int out_i16,
                         long long t0, long long t1, int count,
                         const int* off_whole, const int* off_frac,
                         int summed, float gain, void* stream) {
  if (count < 1 || count > kMaxHeads || n < 1 || block_size < 1 ||
      t0 < 0 || t1 >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (t1 <= t0) return 0;
  Heads heads{};
  for (int h = 0; h < count; ++h) {
    const int r = off_whole[h] % n;
    heads.whole[h] = r < 0 ? r + n : r;
    heads.frac[h] = off_frac[h];
  }
  int bs_shift = -1;                  // block g / bs as a shift, where it is
  for (int b = 0; b < 31; ++b)
    if (block_size == 1 << b) bs_shift = b;
  const unsigned blocks =
      (unsigned)((t1 - (t0 & ~31LL) + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  void (*start)(bool, bool, unsigned, cudaStream_t, const float*, int,
                const int32_t*, const int32_t*, const float*, int, int,
                void*, int, int, const Heads&, float);
  start = count == 1 ? &sr_start<1> : count == 2 ? &sr_start<2>
                                                 : &sr_start<3>;
  start(summed != 0, out_i16 != 0, blocks, s, audio, n, whole, frac, env,
        block_size, bs_shift, out, (int)t0, (int)t1, heads, gain);
  return (int)cudaGetLastError();
}

extern "C" const char* lr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
