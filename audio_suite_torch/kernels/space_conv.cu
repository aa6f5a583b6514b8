// The combined space kernel of a Microsound render, ER (x) IR, on Hopper
// (sm_90a): the early-reflection tap kernel convolved with the impulse
// response, summed in f64 and rounded once to f32.
//
// Replaces no TPU kernel: the JAX package convolves the two on the host
// with NumPy (audio_suite_tpu/models/microsound.py:1116, np.convolve in
// f64).  The port did the same (models/microsound.py:_space_kernels), and
// as its memo is keyed on the render's seed, every new seed paid a dense
// f64 np.convolve of 8 642 x 8 192 taps at config 3 (er_taps 320,
// er_max_ms 45, 192 kHz): 70.8 M multiply-adds on one host core, 16-18 ms
// of a 24-36 ms render while the card waited.  This kernel displaces that
// convolution on a CUDA device.
//
// What it computes.  The ER kernel is sparse: at most er_taps + 1 of its
// taps are nonzero (the dry tap and the reflections; 321 at config 3).  The
// host hands the kernel only those, as offsets and f32 gains in ascending
// offset order (np.flatnonzero), and the IR in f64, all in one copy
// (ops/space.py:space_conv_inputs).  For each output j in
// [0, n_er + n_ir - 1):
//
//   out[j] = f32( sum over the taps t, ascending, with 0 <= j - offs[t]
//                 < n_ir, of f64(gains[t]) * ir[j - offs[t]] )
//
// Every multiply and every add is __dmul_rn / __dadd_rn, so nvcc contracts
// nothing into an FMA and each op rounds once, in the order of the plain
// PyTorch sum (ops/space.py:er_ir_convolve_plain): the two are
// bit-equal.  A product whose ER tap is an exact zero is an
// exact zero, so leaving those taps out changes no bit against the dense
// sum; the f32 result matched np.convolve's in every sample on the
// tests' fixed seed set (tests/test_torch_space_conv.py).
//
// Bound on this card.  Operations: the products that are not zero, one
// f64 multiply and one f64 add each, 2 x 321 x 8 192 = 5.26 M f64
// instructions at config 3; the H100 issues ~16.7 T f64 instructions a
// second (132 SMs x 64 f64 lanes x 1.98 GHz), so 0.31 us.  Bytes: the f64
// IR (64 KB), the taps (2.5 KB) and the f32 output (67 KB), under 0.2 MB,
// 0.05 us at 3.35 TB/s.  Both are far below a launch's few microseconds,
// and the host's 16-18 ms.
//
// Design.  One thread an output sample, kThreads a block (16 833 outputs:
// 132 blocks at config 3, one an SM).  The taps go through shared memory
// in stages of at most kMaxStage (one stage of 321 at config 3, 3.8 KB,
// sized from the count), the gains widened to f64 once; every thread of a
// block reads the same tap at once (a broadcast) and IR samples at
// consecutive addresses (coalesced; the 64 KB IR stays in L1 and L2).  A
// thread's sum is one chain of dependent f64 adds, in tap order.
//
// Measured (H100 80GB HBM3 at 700 W, chip_smoke.py --space, config 3's
// seed 5: 314 nonzero taps): 17.7 us warm, 21.4 us with the L2 flushed,
// against 17.8 ms for the host np.convolve.  Not the launch but that
// chain sets the time: 16 833 threads are 4 warps an SM, too few to hide
// the ~110 cycles of each step (a load of ir[k], then the add).  Loads
// made unconditional (a clamped index, a zero product where out of
// range) could run ahead of the chain; at 0.02 ms of a ~20 ms render that
// is not worth a less plain loop yet.
//
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStage = 2048;  // taps a shared-memory stage: 24 KB

__global__ void __launch_bounds__(kThreads)
space_conv_kernel(const int32_t* __restrict__ offs,
                  const float* __restrict__ gains, int n_taps, int stage,
                  const double* __restrict__ ir, int n_ir,
                  float* __restrict__ out, int n_out) {
  extern __shared__ double s_gain[];  // [stage] f64 gains, then the offsets
  int32_t* s_off = reinterpret_cast<int32_t*>(s_gain + stage);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  for (int t0 = 0; t0 < n_taps; t0 += stage) {
    const int m = min(stage, n_taps - t0);
    __syncthreads();  // the previous stage is read by every thread
    for (int i = threadIdx.x; i < m; i += kThreads) {
      s_gain[i] = (double)gains[t0 + i];
      s_off[i] = offs[t0 + i];
    }
    __syncthreads();
    if (j < n_out) {
      for (int i = 0; i < m; ++i) {
        const int k = j - s_off[i];
        if ((unsigned)k < (unsigned)n_ir)
          acc = __dadd_rn(acc, __dmul_rn(s_gain[i], ir[k]));
      }
    }
  }
  if (j < n_out) out[j] = __double2float_rn(acc);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers: offs i32 [n_taps] (ascending), gains f32 [n_taps], ir f64
// [n_ir], out f32 [n_out]; n_taps >= 0, n_ir >= 1, n_out >= 1.
extern "C" int sc_launch(const int32_t* offs, const float* gains, int n_taps,
                         const double* ir, int n_ir, float* out, int n_out,
                         void* stream) {
  const int stage = n_taps < 1 ? 1 : (n_taps < kMaxStage ? n_taps : kMaxStage);
  const size_t smem = (size_t)stage * (sizeof(double) + sizeof(int32_t));
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  space_conv_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      offs, gains, n_taps, stage, ir, n_ir, out, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* sc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
