// Linear fractional read of a tape on Hopper (sm_90a).
//
// Replaces the TPU kernel audio_suite_tpu/ops/pallas_read.py:
// _read_kernel_body (reached through pallas_read_lerp).  It computes the
// read's contract in the tape's coordinates, not the TPU's VMEM slab:
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
// The second form, heads_read_kernel, is the scrub engine's read: the same
// TPU kernel's contract as the JAX package's scrub computes it
// (audio_suite_tpu/models/scrub.py: _read_blockwise_heads and
// fixq.gather_linear_wrap), with positions that wrap around the tape and
// one to three read heads at fixed offsets, scaled by the head gain.  Per
// output sample j, with w = whole[j] and the heads' offsets (ow_h, of_h):
//
//   summed (integer offsets, the blockwise read, form A):
//     p_h = (w + ow_h) mod n
//     x0 = sum_h audio[p_h];  x1 = sum_h audio[(p_h + 1) mod n]
//     f = frac[j] * 2^-22;    out[j] = (x0 * (1 - f) + x1 * f) * gain
//   per head (form B):
//     f2 = frac[j] + of_h;  c = f2 >> 22;  p_h = (w + ow_h + c) mod n
//     f = (f2 - (c << 22)) * 2^-22
//     y = sum_h ((1 - f) * audio[p_h] + f * audio[(p_h + 1) mod n])
//     out[j] = y * gain
//
// Both sums start from 0 and run in head order, as in the JAX package.
// The mod is the non-negative one (head offsets are negative), exact for
// any int32 position and offset: the launcher reduces each head offset
// mod n on the host, the kernel reduces w mod n once (a 32-bit mod), so
// p_h = (w mod n) + (ow_h mod n) + c lies in [0, 2n) for a carry c of 0 or
// 1 and one subtraction wraps it; any other carry takes a 64-bit mod.
// Same rounding discipline as above: bit-equal to heads_read_plain.  Bound
// the same way: 12 bytes a sample (whole, frac, out) and the tape, which
// at scrub sizes (~2 MB) sits in the L2; a position moves at most a few
// samples per output, so a warp's 2 x heads reads hit a few lines.  A
// 64-bit mod per head and sample would cost about as many integer
// instructions as the memory time, hence the 32-bit reduction.
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

struct Heads {
  int count;
  int whole[kMaxHeads];   // each head's whole offset, reduced mod n
  int frac[kMaxHeads];
};

// x mod n in [0, n) for x in [0, 2n) (the common case), else by a 64-bit
// mod with Python's sign rule
__device__ __forceinline__ int64_t wrap(int64_t x, int n) {
  if (x >= n) x -= n;
  if (x >= 0 && x < n) return x;
  const int64_t r = x % n;
  return r < 0 ? r + n : r;
}

template <bool kSummed>
__global__ void __launch_bounds__(kThreads)
heads_read_kernel(const float* __restrict__ audio,
                  const int32_t* __restrict__ whole,
                  const int32_t* __restrict__ frac, float* __restrict__ out,
                  int64_t T, int n, Heads heads, float gain) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= T) return;
  int pw = whole[j] % n;
  pw += pw < 0 ? n : 0;                       // whole mod n, in [0, n)
  const int32_t fq = frac[j];
  float y;
  if (kSummed) {
    float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads.count) {
        const int64_t p = wrap((int64_t)pw + heads.whole[h], n);
        const int64_t p1 = p + 1 == n ? 0 : p + 1;
        x0 = __fadd_rn(x0, __ldg(audio + p));
        x1 = __fadd_rn(x1, __ldg(audio + p1));
      }
    }
    const float f = __fmul_rn((float)fq, kPosInv);
    y = __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, f)), __fmul_rn(x1, f));
  } else {
    y = 0.0f;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads.count) {
        int32_t f2 = fq + heads.frac[h];
        const int32_t c = f2 >> kFracBits;
        f2 -= c * (1 << kFracBits);
        const int64_t p = wrap((int64_t)pw + heads.whole[h] + c, n);
        const int64_t p1 = p + 1 == n ? 0 : p + 1;
        const float f = __fmul_rn((float)f2, kPosInv);
        y = __fadd_rn(y, __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f),
                                             __ldg(audio + p)),
                                   __fmul_rn(f, __ldg(audio + p1))));
      }
    }
  }
  out[j] = __fmul_rn(y, gain);
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

// The wrap-around multi-head read on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a head count outside
// 1..3.  audio f32[n] with 0 < n < 2^31, whole/frac i32[T], out f32[T]
// are device pointers; off_whole/off_frac are HOST arrays of `count`
// offsets (copied into the kernel's arguments); `summed` selects form A,
// which takes only off_whole (the caller checks every off_frac is 0).
extern "C" int hr_launch(const float* audio, const int32_t* whole,
                         const int32_t* frac, float* out, long long T, int n,
                         int count, const int* off_whole,
                         const int* off_frac, int summed, float gain,
                         void* stream) {
  if (count < 1 || count > kMaxHeads) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  Heads heads{};
  heads.count = count;
  for (int h = 0; h < count; ++h) {
    const int r = off_whole[h] % n;
    heads.whole[h] = r < 0 ? r + n : r;
    heads.frac[h] = off_frac[h];
  }
  const unsigned blocks = (unsigned)((T + kThreads - 1) / kThreads);
  if (summed) {
    heads_read_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        audio, whole, frac, out, (int64_t)T, n, heads, gain);
  } else {
    heads_read_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        audio, whole, frac, out, (int64_t)T, n, heads, gain);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
