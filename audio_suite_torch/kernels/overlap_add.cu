// Ordered overlap-add on Hopper (sm_90a).
//
// Replaces the TPU kernel audio_suite_tpu/ops/pallas_oa.py:_ring_kernel
// (reached through ring_overlap_add, called from
// audio_suite_tpu/models/microsound.py:919).  It computes the contract of
// pallas_oa.overlap_add_dus, not the TPU's VMEM ring:
//
//   for e = 0..E-1, in event order:
//     s = clamp(starts[e], 0, N - Lw)
//     out[s + j] += vals[e, j]        for j in [0, Lw)
//
// Design.  Each CTA owns one tile of kTile output samples; each thread owns
// kPerThread samples of it, strided by the block size so that neighbouring
// threads read neighbouring addresses.  A thread loads out[pos] once, walks
// the events IN ORDER adding vals[e, pos - s] where its window covers pos,
// and writes out[pos] once.  Every sample therefore receives exactly the
// additions of the sequential loop, in the same order: the result is bit-
// identical to overlap_add_dus and to the plain PyTorch loop, whatever the
// base value of out.  No float atomics; starts need not be sorted.  The
// event starts are staged in shared memory (kStage at a time), and an event
// whose window misses the tile is skipped by the whole CTA at once.
//
// Bound on this card: memory.  Every window sample is read once from
// device memory (E * Lw floats) and every output sample read and written
// once; the event scan costs E compares per CTA from shared memory.  A
// tile -> event-range index and TMA loads of the windows are left for
// later work.
//
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;   // output samples per CTA
constexpr int kStage = 2048;                   // event starts per stage

__global__ void __launch_bounds__(kThreads)
overlap_add_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ starts,
                   float* __restrict__ out, int E, int Lw, int64_t N) {
  __shared__ int64_t s_start[kStage];
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int64_t hi = N - Lw;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t pos = tile0 + threadIdx.x + k * kThreads;
    acc[k] = pos < N ? out[pos] : 0.0f;
  }

  for (int e0 = 0; e0 < E; e0 += kStage) {
    const int ne = min(kStage, E - e0);
    __syncthreads();                   // previous stage fully consumed
    for (int j = threadIdx.x; j < ne; j += kThreads) {
      int64_t s = starts[e0 + j];
      s = s < 0 ? 0 : (s > hi ? hi : s);
      s_start[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < ne; ++j) {
      const int64_t s = s_start[j];
      if (s >= tile0 + kTile || s + Lw <= tile0) continue;  // whole CTA
      const float* __restrict__ v = vals + (int64_t)(e0 + j) * Lw;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int64_t d = tile0 + threadIdx.x + k * kThreads - s;
        if (d >= 0 && d < Lw) acc[k] += v[d];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t pos = tile0 + threadIdx.x + k * kThreads;
    if (pos < N) out[pos] = acc[k];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers: vals f32[E * Lw], starts i32[E], out f32[N], with
// 0 < Lw <= N.
extern "C" int oa_launch(const float* vals, const int32_t* starts, float* out,
                         int E, int Lw, long long N, void* stream) {
  const long long tiles = (N + kTile - 1) / kTile;
  overlap_add_kernel<<<(unsigned)tiles, kThreads, 0,
                       (cudaStream_t)stream>>>(vals, starts, out, E, Lw,
                                               (int64_t)N);
  return (int)cudaGetLastError();
}

extern "C" const char* oa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
