// Per-sample grain recurrences of the Microsound generators on Hopper
// (sm_90a): the stick-slip friction loop, the gated logistic map and the
// waveguide's feedback delay lines.
//
// Replaces no Pallas kernel: the JAX package runs these recurrences as
// lax.scan (audio_suite_tpu/ops/generators.py:188 gen_stick_slip, :214
// gen_micro_chaos, :304 waveguide_splinters), which XLA compiles into one
// loop on the TPU.  Run eagerly in PyTorch every step of every recurrence
// is its own launches (a 2 048-sample stick-slip ~25 000, the factory
// waveguide ~130 000); here each recurrence is one launch, one thread per
// event, its state in registers.
//
// Arithmetic.  Every multiply and add is __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA, and each op rounds
// once in the JAX scan's order: the results are bit-equal to the plain
// PyTorch loops beside the dispatchers in audio_suite_torch/ops/
// generators.py (stick_slip_scan_plain, chaos_scan_plain,
// waveguide_scan_plain).  Comparisons are JAX's (<=, <).
//
// Layout.  Inputs and outputs are [E, L] row-major, one row per event.  A
// block is one warp of 32 events.  The warp walks its 32 rows in tiles of
// kTile steps: lane c loads and stores columns c and c + 32 of each row,
// so one load instruction reads 32 consecutive floats of one row
// (coalesced); the tile goes through shared memory, and each lane then
// steps its own row (row pitch kTile + 1: no bank conflicts).  The next
// tile's loads are issued into registers before the current tile is
// stepped, so their latency hides behind the recurrence.  The output
// overwrites the consumed input in the tile and is stored the same
// coalesced way.
//
// Bound on this card.  Bytes: the inputs read once and the output written
// once, 12 bytes a sample for stick-slip (two f32 in, one out), 8 for
// micro-chaos (its y0 negligible) and 8 a sample a line for the waveguide.
// At the factory settings (E 160 with padding, L 2 048) that is 3.9, 2.6
// and 2.6 MB, ~1 us at 3.35 TB/s.  The dependency chain: stick-slip and
// micro-chaos read the step before at every step, so their chain is L
// steps of a few dependent f32 operations of 4 cycles (the force's add,
// compare and select; the map's two multiplies): 8-12 us at 2 048 steps
// and 1 980 MHz, which governs.  The waveguide's v(t) reads v(t - d), so a
// line's chain is only L / d links long (4 at the factory d of 480-9 600),
// and line l + 1 at step t needs only line l at step t, so the lines
// pipeline: ~0.07 us.  Its bytes govern, and this kernel, which steps the
// L x lines samples of an event in series on one thread, is far from
// them.  Its redesign: steps of one tile whose t - d falls in an earlier
// tile (all of them where d >= kTile) do not depend on each other, so
// the tile's steps can run across the lanes of a warp, and the lines
// behind each other, instead of one thread per event.

// The waveguide.  Each line runs over the whole grain from a zeroed ring
// of d floats whose write pointer wraps at d, so the value read at step t
// is v(t - d), the one written d steps before, and 0 before step d: a
// d >= L never wraps and reads only zeros (the factory d is 480-9 600
// against L 2 048).  The literal (1 - mix) * y + mix * v stays even then
// (not the identity in f32).  When t - d lies in the current tile the
// value comes from the tile's v in shared memory; otherwise from the ring,
// in global scratch of min(dmax, L) floats per event (one row per thread,
// read and written only by it), whose slots for a tile are read together
// at the tile's start.  A slot is written only if a later step reads it.
// A padding event's d of 0 behaves as 1, as in the scan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 2 * kWarp;   // a stepping warp and a staging warp
constexpr int kTile = 64;             // steps staged per tile
constexpr int kCols = kTile / kWarp;  // columns of a row per lane
constexpr int kPitch = kTile + 1;     // row pitch in shared memory

// Stage rows [e0, e0 + 32) x columns [t0, t0 + T) of src into tile
// (zeros past T; rows past E read row E - 1 and are never stored).  All
// 64 loads of a lane are issued before the first store to shared memory,
// and each load instruction reads 32 consecutive floats of one row.
__device__ __forceinline__ void load_tile(float (*tile)[kPitch],
                                          const float* src, int E, int L,
                                          int e0, int t0, int T) {
  const int lane = threadIdx.x & (kWarp - 1);
  float v[kWarp][kCols];
#pragma unroll
  for (int row = 0; row < kWarp; ++row) {
    const float* p = src + (int64_t)min(e0 + row, E - 1) * L + t0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + j * kWarp;
      v[row][j] = c < T ? p[c] : 0.0f;
    }
  }
#pragma unroll
  for (int row = 0; row < kWarp; ++row) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) tile[row][lane + j * kWarp] = v[row][j];
  }
}

// Store rows [e0, e0 + 32) x columns [t0, t0 + T) of the tile to dst.
__device__ __forceinline__ void store_tile(float (*tile)[kPitch], float* dst,
                                           int E, int L, int e0, int t0,
                                           int T) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int row = 0; row < kWarp; ++row) {
    float* p = dst + (int64_t)min(e0 + row, E - 1) * L + t0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + j * kWarp;
      if (e0 + row < E && c < T) p[c] = tile[row][c];
    }
  }
}

// The walk over the rows' tiles, with two tile buffers: while the
// stepping warp (threads 0-31, one event each) steps tile i in buffer
// i & 1, the staging warp (threads 32-63) stores tile i - 1 and loads
// tile i + 1 into the other buffer; one block barrier a tile.
// step(b, c, t) computes column c (step t) of this lane's row in buffer b
// and leaves its output in the first input's tile.
template <int N, typename Step>
__device__ __forceinline__ void walk(float (*tiles)[2][kWarp][kPitch],
                                     const float* const* src, float* dst,
                                     int E, int L, int e0, bool live,
                                     Step step) {
  const bool stager = threadIdx.x >= kWarp;
  const int ntiles = (L + kTile - 1) / kTile;
  if (stager) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      load_tile(tiles[k][0], src[k], E, L, e0, 0, min(kTile, L));
  }
  __syncthreads();
  for (int i = 0; i < ntiles; ++i) {
    const int b = i & 1;
    const int t0 = i * kTile;
    const int T = min(kTile, L - t0);
    if (!stager) {
      if (live) {
        if (T == kTile) {
#pragma unroll 16
          for (int c = 0; c < kTile; ++c) step(b, c, t0 + c);
        } else {
          for (int c = 0; c < T; ++c) step(b, c, t0 + c);
        }
      }
    } else {
      if (i > 0) store_tile(tiles[0][b ^ 1], dst, E, L, e0, t0 - kTile,
                            kTile);
      if (i + 1 < ntiles) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          load_tile(tiles[k][b ^ 1], src[k], E, L, e0, t0 + kTile,
                    min(kTile, L - t0 - kTile));
      }
    }
    __syncthreads();
  }
  if (stager) {
    const int t0 = (ntiles - 1) * kTile;
    store_tile(tiles[0][(ntiles - 1) & 1], dst, E, L, e0, t0, L - t0);
  }
}

// xs[e, t]: the stick-slip friction loop (generators.py:194-206).
__global__ void __launch_bounds__(kThreads)
stick_slip_kernel(const float* __restrict__ bn, const float* __restrict__ on,
                  float* __restrict__ xs, int E, int L, float thr,
                  float build, float decay, float nz) {
  __shared__ float tiles[2][2][kWarp][kPitch];
  const int lane = threadIdx.x & (kWarp - 1);
  const int e0 = blockIdx.x * kWarp;
  bool sticking = true;
  float force = 0.0f;
  const float* src[2] = {bn, on};
  const bool live = threadIdx.x < kWarp && e0 + lane < E;
  walk<2>(tiles, src, xs, E, L, e0, live, [&](int buf, int c, int) {
    const float b = tiles[0][buf][lane][c];
    const float o = tiles[1][buf][lane][c];
    const float force_stick = __fadd_rn(
        force, __fmul_rn(build, __fadd_rn(__fmul_rn(b, nz), 0.2f)));
    const bool new_sticking_s = fabsf(force_stick) <= thr;
    const float out_slip = __fadd_rn(force, __fmul_rn(0.25f, o));
    float force_slip = __fmul_rn(force, decay);
    const bool back = fabsf(force_slip) < 0.02f;
    force_slip = back ? 0.0f : force_slip;
    tiles[0][buf][lane][c] = sticking ? 0.0f : out_slip;
    force = sticking ? force_stick : force_slip;
    sticking = sticking ? new_sticking_s : back;
  });
}

// xs[e, t]: the gated logistic map (generators.py:223-229) from y0[e].
__global__ void __launch_bounds__(kThreads)
chaos_kernel(const float* __restrict__ gates, const float* __restrict__ y0,
             float* __restrict__ xs, int E, int L, float r, float gate) {
  __shared__ float tiles[1][2][kWarp][kPitch];
  const int lane = threadIdx.x & (kWarp - 1);
  const int e0 = blockIdx.x * kWarp;
  const bool live = threadIdx.x < kWarp && e0 + lane < E;
  float y = live ? y0[e0 + lane] : 0.0f;
  const float* src[1] = {gates};
  walk<1>(tiles, src, xs, E, L, e0, live, [&](int buf, int c, int) {
    y = __fmul_rn(__fmul_rn(r, y), __fsub_rn(1.0f, y));
    const float v = __fsub_rn(y, 0.5f);
    tiles[0][buf][lane][c] = tiles[0][buf][lane][c] < gate ? v : 0.0f;
  });
}

// y[e, :]: the waveguide's delay lines in order (generators.py:308-322),
// line 0 reading x, each later line reading and overwriting y (each
// lane rereads only what it wrote).  The value read at step t is v(t - d),
// written d steps before into slot t mod d of the ring: from the current
// tile's v (shared memory) when t - d lies in the tile, else from the
// ring, whose slots for the tile are fetched together at the tile's start.
// ring: E x cap floats, cap >= min(d, L) for every d.
__global__ void __launch_bounds__(kThreads)
waveguide_kernel(const float* __restrict__ x, const int32_t* __restrict__ d,
                 const float* __restrict__ g, const float* __restrict__ mix,
                 float* y, float* __restrict__ ring, int E, int L, int lines,
                 int cap) {
  __shared__ float tiles[1][2][kWarp][kPitch];
  __shared__ float vt[kWarp][kPitch];    // this tile's v
  __shared__ float pref[kWarp][kPitch];  // ring values read in this tile
  const int lane = threadIdx.x & (kWarp - 1);
  const int e0 = blockIdx.x * kWarp;
  const int e = e0 + lane;
  const bool live = threadIdx.x < kWarp && e < E;
  float* my_ring = ring + (int64_t)(live ? e : 0) * cap;
  for (int ln = 0; ln < lines; ++ln) {
    const int de = live ? max(d[(int64_t)e * lines + ln], 1) : 1;
    const float ge = live ? g[(int64_t)e * lines + ln] : 0.0f;
    const float me = live ? mix[(int64_t)e * lines + ln] : 0.0f;
    const float keep = __fsub_rn(1.0f, me);
    int wp = 0;                          // the ring slot of step t
    const float* src[1] = {ln == 0 ? x : y};
    walk<1>(tiles, src, y, E, L, e0, live, [&](int buf, int c, int t) {
      if (c == 0) {
        // the tile's ring reads: v(t' - d) for t' - d before the tile
        int s = wp;
        const int n = min(de, kTile);
#pragma unroll 8
        for (int k = 0; k < n; ++k) {
          pref[lane][k] = (t + k >= de && s < cap) ? my_ring[s] : 0.0f;
          s = s + 1 >= de ? 0 : s + 1;
        }
      }
      const float yt = tiles[0][buf][lane][c];
      const float b = t < de ? 0.0f : (c < de ? pref[lane][c]
                                              : vt[lane][c - de]);
      const float v = __fadd_rn(yt, __fmul_rn(ge, b));
      vt[lane][c] = v;
      if (t + de < L && wp < cap) my_ring[wp] = v;
      wp = wp + 1 >= de ? 0 : wp + 1;
      tiles[0][buf][lane][c] = __fadd_rn(__fmul_rn(keep, yt),
                                         __fmul_rn(me, v));
    });
  }
}

inline unsigned blocks(int E) { return (unsigned)((E + kWarp - 1) / kWarp); }

}  // namespace

// Each launch function runs on `stream` and returns cudaGetLastError()
// (0 on success).  Pointers are device pointers to contiguous row-major
// arrays; E > 0, L > 0.

// bn, on, xs: f32 [E, L].
extern "C" int gs_stick_slip(const float* bn, const float* on, float* xs,
                             int E, int L, float thr, float build,
                             float decay, float nz, void* stream) {
  stick_slip_kernel<<<blocks(E), kThreads, 0, (cudaStream_t)stream>>>(
      bn, on, xs, E, L, thr, build, decay, nz);
  return (int)cudaGetLastError();
}

// gates, xs: f32 [E, L]; y0: f32 [E].
extern "C" int gs_chaos(const float* gates, const float* y0, float* xs,
                        int E, int L, float r, float gate, void* stream) {
  chaos_kernel<<<blocks(E), kThreads, 0, (cudaStream_t)stream>>>(
      gates, y0, xs, E, L, r, gate);
  return (int)cudaGetLastError();
}

// x, y: f32 [E, L] (distinct); d: i32 [E, lines]; g, mix: f32 [E, lines];
// ring: f32 [E, cap] scratch, cap >= 1 and >= min(d, L) for every d.
extern "C" int gs_waveguide(const float* x, const int32_t* d, const float* g,
                            const float* mix, float* y, float* ring, int E,
                            int L, int lines, int cap, void* stream) {
  waveguide_kernel<<<blocks(E), kThreads, 0, (cudaStream_t)stream>>>(
      x, d, g, mix, y, ring, E, L, lines, cap);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
