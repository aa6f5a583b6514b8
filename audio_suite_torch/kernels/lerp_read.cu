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
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

extern "C" const char* lr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
