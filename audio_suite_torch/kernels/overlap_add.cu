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
// Order.  Each CTA owns one tile of kTile output samples; each thread owns
// kPerThread samples of it, strided by the block size so that neighbouring
// threads read neighbouring addresses.  A thread loads out[pos] once, adds
// vals[e, pos - s] for every event whose window covers pos, IN EVENT ORDER,
// and writes out[pos] once.  Every sample so receives exactly the additions
// of the sequential loop, in the same order: the result is bit-identical to
// overlap_add_dus and to the plain PyTorch loop, whatever the base value of
// out.  No float atomics; starts need not be sorted.
//
// Bound on this card: memory.  The kernel must read every window sample
// once (E * Lw floats) and read and write every output sample once; its
// E * Lw adds are negligible.  At the Microsound config-3 shapes (E 288,
// Lw 19 456, N 851 968) that is 22.41 MB + 6.82 MB = 29.23 MB, so 8.7 us at
// 3.35 TB/s.  In the render the windows were just written by the grain
// chain, so most of them are still in the 50 MB L2, and the kernel is
// designed for that case; from device memory (L2 flushed) it reaches
// under half of that bound (numbers below).
//
// Design.
// 1. A hit list per tile, built by the whole CTA.  Per stage of kStage
//    events, each thread tests only its own events (j = tid + k * kThreads)
//    against the tile; __ballot_sync / __popc within each warp and an
//    exclusive scan over the warps' counts compact the covering events into
//    a shared-memory list in ascending event order.  A thread so makes
//    about E / kThreads compares, where testing every event made E; a
//    config-3 tile is covered by only ~7 of the 288.
// 2. Loads of later hits overlap the adds of earlier ones.  The walk keeps
//    a ring of kDepth hits in registers (kDepth 2: a double buffer): the
//    window reads of the next kDepth - 1 hits are in flight while the
//    current hit is added, beside the kPerThread independent reads of each
//    hit.  The adds keep their order, so the result stays bit-equal.
// 3. Balance.  kPerThread 8 and kThreads 256 make 2048-sample tiles: 416
//    CTAs at config 3, 7.2 hits per tile on average, 21 at most, 5 tiles
//    with 20 or more (the 18 padding events all start at the render's
//    end).  ptxas -v: 48 registers, 8256 bytes of shared
//    memory, no spills, so 5 CTAs (40 of 64 warps) fit on an SM and the
//    whole grid is one wave of ~3.2 CTAs per SM: the stacked tiles start
//    first and overlap the light ones.  Chosen by measurement (oa_ab.py at
//    config 3, one H100 80GB HBM3 at 700 W; medians of 6 turns in one
//    process, warm / L2 flushed): this design 10.4 / 22.9 us; 8 samples in
//    1024-sample tiles 10.5 / 22.3; 16 samples 11.3 / 24.2; 4 samples
//    13.2 / 22.6; with an L2 bulk prefetch of every hit 11.7 / 23.4;
//    cp.async rings in shared memory 12.2 / 19.3 (8 samples, 3 deep) and
//    12.8 / 18.5 (4 samples, 6 deep); the earlier design, in which every
//    thread tested every event, 38.5 / 46.7.  The cp.async rings are
//    faster from device memory, but the render's windows are in the L2,
//    where this design is fastest.
//
// Later work: fusing the amp x mask prologue (models/microsound.py,
// chunk_body: the windows' gain and validity mask, then .contiguous())
// into the kernel would save the 22 MB write and re-read of the windows.
//
// Built by audio_suite_torch/kernels/__init__.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;   // output samples per CTA
constexpr int kStage = 1024;                   // events per stage: the hit
                                               // list's capacity
constexpr int kDepth = 2;                      // hits in the register ring

// The thread's window samples of one hit; d0 = tile0 - s.  Samples outside
// the window are not read (the add skips them too).
__device__ __forceinline__ void fetch(const float* __restrict__ vals, int Lw,
                                      int e, int d0,
                                      float (&buf)[kPerThread]) {
  const float* __restrict__ v = vals + (int64_t)e * Lw;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int d = d0 + (int)threadIdx.x + k * kThreads;
    buf[k] = (unsigned)d < (unsigned)Lw ? __ldg(v + d) : 0.0f;
  }
}

__device__ __forceinline__ void add(float (&acc)[kPerThread], int Lw, int d0,
                                    const float (&buf)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int d = d0 + (int)threadIdx.x + k * kThreads;
    if ((unsigned)d < (unsigned)Lw) acc[k] += buf[k];
  }
}

__global__ void __launch_bounds__(kThreads)
overlap_add_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ starts,
                   float* __restrict__ out, int E, int Lw, int64_t N) {
  __shared__ int s_e[kStage];          // hit list: event index
  __shared__ int s_d[kStage];          //           tile0 - clamped start
  __shared__ int s_count[2][kWarps];   // hits per warp, by round parity
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int64_t hi = N - Lw;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t pos = tile0 + threadIdx.x + k * kThreads;
    acc[k] = pos < N ? out[pos] : 0.0f;
  }

  int round = 0;
  for (int e0 = 0; e0 < E; e0 += kStage) {
    const int ne = min(kStage, E - e0);
    __syncthreads();                   // the previous stage's list is spent

    // 1. compact the events of this stage that cover the tile, in order
    int nh = 0;
    for (int j0 = 0; j0 < ne; j0 += kThreads, ++round) {
      const int j = j0 + threadIdx.x;
      bool hit = false;
      int64_t d0 = 0;
      if (j < ne) {
        int64_t s = starts[e0 + j];
        s = s < 0 ? 0 : (s > hi ? hi : s);
        hit = s < tile0 + kTile && s + Lw > tile0;
        d0 = tile0 - s;                // in (-kTile, Lw) for a hit
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      int* count = s_count[round & 1];
      if (lane == 0) count[warp] = __popc(m);
      __syncthreads();
      int slot = nh, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = count[w];
        slot += w < warp ? c : 0;
        total += c;
      }
      if (hit) {
        slot += __popc(m & ((1u << lane) - 1u));
        s_e[slot] = e0 + j;
        s_d[slot] = (int)d0;
      }
      nh += total;
    }
    __syncthreads();                   // the list is complete

    // 2. walk the list, kDepth - 1 hits ahead
    float buf[kDepth][kPerThread];
    int dsl[kDepth];
#pragma unroll
    for (int i = 0; i < kDepth - 1; ++i) {
      if (i < nh) {
        dsl[i] = s_d[i];
        fetch(vals, Lw, s_e[i], dsl[i], buf[i]);
      }
    }
    for (int h0 = 0; h0 < nh; h0 += kDepth) {
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        // fetch hit f into the slot that hit h0 + i - 1 was added from
        const int f = h0 + i + kDepth - 1;
        const int fs = (i + kDepth - 1) % kDepth;
        if (f < nh) {
          dsl[fs] = s_d[f];
          fetch(vals, Lw, s_e[f], dsl[fs], buf[fs]);
        }
        if (h0 + i < nh) add(acc, Lw, dsl[i], buf[i]);
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
