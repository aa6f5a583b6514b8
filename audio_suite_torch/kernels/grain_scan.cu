// Per-sample grain recurrences of the Microsound generators on Hopper
// (sm_90a): the stick-slip friction loop, the gated logistic map and the
// waveguide's feedback delay lines.
//
// Replaces no Pallas kernel: the JAX package runs these recurrences as
// lax.scan (audio_suite_tpu/ops/generators.py:188 gen_stick_slip, :214
// gen_micro_chaos, :304 waveguide_splinters), which XLA compiles into one
// loop on the TPU.  Run eagerly in PyTorch every step of every recurrence
// is its own launches (a 2 048-sample stick-slip ~25 000, the factory
// waveguide ~130 000); here each recurrence is one launch.
//
// Arithmetic.  Every multiply and add is __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA, and each op rounds
// once in the JAX scan's order: the results are bit-equal to the plain
// PyTorch loops beside the dispatchers in audio_suite_torch/ops/
// generators.py (stick_slip_scan_plain, chaos_scan_plain,
// waveguide_scan_plain).  Comparisons are JAX's (<=, <).
//
// Bound on this card.  Bytes: the inputs read once and the output written
// once, 12 bytes a sample for stick-slip (two f32 in, one out), 8 for
// micro-chaos (its y0 negligible) and 8 a sample for the waveguide (x in,
// y out, whatever its lines).  At the factory settings (E 160 with
// padding, L 2 048) that is 3.9, 2.6 and 2.6 MB, ~1 us at 3.35 TB/s.  The
// dependency chain: stick-slip and micro-chaos read the step before at
// every step, so their chain is L steps of a few dependent f32 operations
// of 4 cycles (the force's add, compare and select; the map's two
// multiplies): 8-12 us at 2 048 steps and 1 980 MHz, which governs.  The
// waveguide's v(t) reads v(t - d), so a line's chain is only L / d links
// long, and its bytes govern.
//
// Stick-slip (one thread per event, a warp of 32 events a block).  The
// warp walks its 32 rows in tiles of kTile steps: lane c loads and stores
// columns c and c + 32 of each row, so one load instruction reads 32
// consecutive floats of one row (coalesced); the tile goes through shared
// memory, and each lane then steps its own row (row pitch kTile + 1: no
// bank conflicts).  A staging warp loads the next tile into registers
// and stores the last one while the stepping warp steps the current one;
// one block barrier a tile.
//
// Micro-chaos (one thread per event: a stepping warp of which lanes 0-7
// step 8 events, and a producer warp).  The map's y never reads the
// gates, so the stepping warp does nothing but the chain: kChaosK steps of
// y in registers, only the two multiplies on it, then the block into a
// ring of y tiles of kChaosTile steps in shared memory; one mbarrier
// arrival a tile, and a wait only when it is kChaosYs tiles ahead of the
// producer.  The producer keeps the gates kChaosGates - 1 tiles ahead with
// cp.async, started before the first step, masks each tile of y by its
// gates (u < gate ? y - 0.5 : 0) and stores it, 16 bytes a lane over whole
// rows where rows are aligned (coalesced).  No block barrier sits in the
// chain.  The sizes are measured (H100): the producer's hand-off costs
// ~1 000 cycles a tile whatever its width, which a tile of 32 steps (~290
// cycles of chain) could not hide and one of 256 does; 8 events a block
// rather than 32 spread the rows over more SMs.
//
// The waveguide (one block per event).  The JAX scan writes ring slot
// t mod d at step t, so the slot read at step t holds v(t - d), 0 before
// step d: v(t) = y(t) + g v(t - d), and the steps t = j (mod d) form an
// independent column of floor((L - 1 - j) / d) + 1 links (a d of 0 acts
// as 1).  A line with d >= L has one link a column:
// it is pointwise, y(t) -> (1 - mix) y(t) + mix (y(t) + g 0), the two
// literal ops kept (neither is the identity in f32 for +-0).  The lines
// run in order, in place over the event's row, one block barrier between
// passes: each run of consecutive pointwise lines is one pass, kWgVec
// samples a thread through the run's lines in registers; each line with
// d < L is one pass in which thread k owns the columns j = k (mod
// blockDim) and walks t = j, j + d, ... with v(t - d) in a register, so
// consecutive threads touch consecutive t (coalesced, and no bank
// conflicts).  The row lives in shared memory (dynamic, opted in above
// 48 KB) where it fits: a first pointwise pass reads x itself, a first
// column pass finds the row staged there with cp.async, and the last pass
// writes y.  Otherwise the passes run in place over y in global memory
// (L2-resident).

#include <algorithm>
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

// ---- micro-chaos

constexpr int kChaosK = 32;       // steps a register block
constexpr int kChaosTile = 256;   // steps a tile (kChaosK-step blocks)
constexpr int kChaosRows = 8;     // events a block: lanes 0-7 step
constexpr int kChaosGates = 6;    // gate tiles in flight
constexpr int kChaosYs = 4;       // tiles of y between the two warps
constexpr int kChaosPitch = kChaosTile + 4;   // a y tile's row pitch: 16-byte
//                                               rows, the stepping lanes'
//                                               STS.128 free of conflicts

struct ChaosSmem {
  float gates[kChaosGates][kChaosRows][kChaosTile];
  float ys[kChaosYs][kChaosRows][kChaosPitch];
  uint64_t full[kChaosYs];        // y tile written (the stepping warp's 32)
  uint64_t empty[kChaosYs];       // y tile stored (the producer's 32)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// The phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// kChaosK steps of the map from y, into out
__device__ __forceinline__ void chaos_chain(float (&out)[kChaosK], float& y,
                                            float r) {
#pragma unroll
  for (int k = 0; k < kChaosK; ++k) {
    y = __fmul_rn(__fmul_rn(r, y), __fsub_rn(1.0f, y));
    out[k] = y;
  }
}

// xs[e, t]: the gated logistic map (generators.py:223-229) from y0[e].
// Lanes 0-7 of warp 0 step events e0 + lane; warp 1 brings the gates in
// and masks and stores the steps.  Dynamic shared memory: a ChaosSmem.
__global__ void __launch_bounds__(2 * kWarp)
chaos_kernel(const float* __restrict__ gates, const float* __restrict__ y0,
             float* __restrict__ xs, int E, int L, float r, float gate) {
  extern __shared__ __align__(16) unsigned char chaos_smem[];
  ChaosSmem& sm = *reinterpret_cast<ChaosSmem*>(chaos_smem);
  const int lane = threadIdx.x & (kWarp - 1);
  const int e0 = blockIdx.x * kChaosRows;
  const int nt = (L + kChaosTile - 1) / kChaosTile;
  if (threadIdx.x < kChaosYs) {
    mbar_init(&sm.full[threadIdx.x], kWarp);
    mbar_init(&sm.empty[threadIdx.x], kWarp);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < kWarp) {
    // the stepping warp: blocks of kChaosK steps in registers into the
    // tile's y in shared memory (waiting only if the producer is kChaosYs
    // tiles behind), one arrival a tile
    const bool live = lane < kChaosRows;
    float y = live && e0 + lane < E ? y0[e0 + lane] : 0.0f;
    for (int i = 0; i < nt; ++i) {
      const int s = i % kChaosYs;
#pragma unroll 1
      for (int b = 0; b < kChaosTile / kChaosK; ++b) {
        float v[kChaosK];
        chaos_chain(v, y, r);
        if (b == 0 && i >= kChaosYs)
          mbar_wait(&sm.empty[s], (uint32_t)(i / kChaosYs - 1) & 1);
        if (live) {
          float4* row =
              reinterpret_cast<float4*>(&sm.ys[s][lane][b * kChaosK]);
#pragma unroll
          for (int k = 0; k < kChaosK / 4; ++k)
            row[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                 v[4 * k + 3]);
        }
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // the producer: the gates kChaosGates - 1 tiles ahead by cp.async (one
  // commit group a tile), 16 bytes a lane where every row of the tile is
  // aligned and whole, else 4 bytes a lane; then each tile of y masked by
  // its gates and stored, consecutive lanes on consecutive floats of a
  // row (coalesced)
  constexpr int kQuads = kChaosTile / 4;    // float4s in a tile's row
  constexpr int kLoads = kChaosRows * kQuads / kWarp;   // float4s a lane
  const bool vec = (L & 3) == 0 && aligned16(gates) && aligned16(xs);
  auto load = [&](int i) {
    if (i < nt) {
      const int s = i % kChaosGates, t0 = i * kChaosTile;
      const int T = min(kChaosTile, L - t0);
      if (vec && T == kChaosTile) {
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int row = (lane + j * kWarp) / kQuads;
          const int c = (lane + j * kWarp) % kQuads * 4;
          cp_async16(&sm.gates[s][row][c],
                     gates + (int64_t)min(e0 + row, E - 1) * L + t0 + c);
        }
      } else {
        for (int row = 0; row < kChaosRows; ++row)
          for (int c = lane; c < T; c += kWarp)
            cp_async4(&sm.gates[s][row][c],
                      gates + (int64_t)min(e0 + row, E - 1) * L + t0 + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < kChaosGates - 1; ++i) load(i);
  for (int i = 0; i < nt; ++i) {
    load(i + kChaosGates - 1);   // into the stage that tile i - 1 freed
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kChaosGates - 1)
                 : "memory");
    __syncwarp();
    const int sg = i % kChaosGates, sy = i % kChaosYs, t0 = i * kChaosTile;
    const int T = min(kChaosTile, L - t0);
    mbar_wait(&sm.full[sy], (uint32_t)(i / kChaosYs) & 1);
    if (vec && T == kChaosTile) {
      // every read first, then the stores: one stretch without branches
      float4 o[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int row = (lane + j * kWarp) / kQuads;
        const int c = (lane + j * kWarp) % kQuads * 4;
        const float4 u =
            *reinterpret_cast<const float4*>(&sm.gates[sg][row][c]);
        const float4 v = *reinterpret_cast<const float4*>(&sm.ys[sy][row][c]);
        o[j] = make_float4(u.x < gate ? __fsub_rn(v.x, 0.5f) : 0.0f,
                           u.y < gate ? __fsub_rn(v.y, 0.5f) : 0.0f,
                           u.z < gate ? __fsub_rn(v.z, 0.5f) : 0.0f,
                           u.w < gate ? __fsub_rn(v.w, 0.5f) : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int row = (lane + j * kWarp) / kQuads;
        const int c = (lane + j * kWarp) % kQuads * 4;
        if (e0 + row < E)
          *reinterpret_cast<float4*>(xs + (int64_t)(e0 + row) * L + t0 + c) =
              o[j];
      }
    } else {
      for (int row = 0; row < kChaosRows && e0 + row < E; ++row)
        for (int c = lane; c < T; c += kWarp)
          xs[(int64_t)(e0 + row) * L + t0 + c] =
              sm.gates[sg][row][c] < gate
                  ? __fsub_rn(sm.ys[sy][row][c], 0.5f) : 0.0f;
    }
    mbar_arrive(&sm.empty[sy]);
    __syncwarp();                // every lane's reads of stage sg are done
  }
}

// ---- the waveguide

constexpr int kWgMaxThreads = 1024;
constexpr int kWgVec = 16;       // samples a thread holds in a pointwise pass

// Lines [a, b), all pointwise (d >= L), over the row: src -> dst, which may
// be the same (each sample read and written by one thread).
__device__ __forceinline__ void wg_pointwise(const float* src, float* dst,
                                             int L, int a, int b,
                                             const float* pg, const float* pm,
                                             const float* pk) {
  const int n = blockDim.x;
  for (int base = threadIdx.x; base < L; base += n * kWgVec) {
    float v[kWgVec];
#pragma unroll
    for (int k = 0; k < kWgVec; ++k) {
      const int t = base + k * n;
      v[k] = t < L ? src[t] : 0.0f;
    }
    for (int l = a; l < b; ++l) {
      const float gl = pg[l], ml = pm[l], kl = pk[l];
#pragma unroll
      for (int k = 0; k < kWgVec; ++k)
        v[k] = __fadd_rn(__fmul_rn(kl, v[k]),
                         __fmul_rn(ml, __fadd_rn(v[k], __fmul_rn(gl, 0.0f))));
    }
#pragma unroll
    for (int k = 0; k < kWgVec; ++k) {
      const int t = base + k * n;
      if (t < L) dst[t] = v[k];
    }
  }
}

// One line of delay dd < L over the row, column by column: src -> dst.
__device__ __forceinline__ void wg_columns(const float* src, float* dst,
                                           int L, int dd, float gl, float ml,
                                           float kl) {
  for (int j = threadIdx.x; j < dd; j += blockDim.x) {
    float prev = 0.0f;                     // v(t - d), 0 before step d
    for (int t = j; t < L; t += dd) {
      const float yt = src[t];
      const float v = __fadd_rn(yt, __fmul_rn(gl, prev));
      dst[t] = __fadd_rn(__fmul_rn(kl, yt), __fmul_rn(ml, v));
      prev = v;
    }
  }
}

// y[e, :]: the waveguide's delay lines in order (generators.py:308-322)
// over x[e, :].  Dynamic shared memory: the lines' d, g, mix and 1 - mix
// (4 x lines words), then, if `staged`, the row (L floats).
__global__ void __launch_bounds__(kWgMaxThreads)
waveguide_kernel(const float* __restrict__ x, const int32_t* __restrict__ d,
                 const float* __restrict__ g, const float* __restrict__ mix,
                 float* y, int L, int lines, int staged) {
  extern __shared__ __align__(16) float smem[];
  int* pd = reinterpret_cast<int*>(smem);
  float* pg = smem + lines;
  float* pm = smem + 2 * lines;
  float* pk = smem + 3 * lines;
  float* row = smem + 4 * lines;           // 16-byte aligned
  const int e = blockIdx.x;
  for (int l = threadIdx.x; l < lines; l += blockDim.x) {
    const int64_t k = (int64_t)e * lines + l;
    pd[l] = max(d[k], 1);
    pg[l] = g[k];
    pm[l] = mix[k];
    pk[l] = __fsub_rn(1.0f, mix[k]);
  }
  const float* xr = x + (int64_t)e * L;
  float* yr = y + (int64_t)e * L;
  const float* src = xr;
  __syncthreads();
  if (staged && pd[0] < L) {
    // the first pass walks columns: the row to shared memory first (a
    // first pointwise pass reads x itself, kWgVec loads a thread in flight)
    int t = 0;
    if (aligned16(xr)) {
      for (int q = threadIdx.x; q < L / 4; q += blockDim.x)
        cp_async16(row + 4 * q, xr + 4 * q);
      t = L / 4 * 4;
    }
    for (t += threadIdx.x; t < L; t += blockDim.x) cp_async4(row + t, xr + t);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
    src = row;
    __syncthreads();
  }
  float* mid = staged ? row : yr;   // where a pass before the last writes
  int a = 0;                        // the pending run of pointwise lines
  for (int l = 0; l < lines; ++l) {
    if (pd[l] >= L) continue;
    if (a < l) {
      wg_pointwise(src, mid, L, a, l, pg, pm, pk);
      __syncthreads();
      src = mid;
    }
    float* dst = l + 1 == lines ? yr : mid;
    wg_columns(src, dst, L, pd[l], pg[l], pm[l], pk[l]);
    __syncthreads();
    src = dst;
    a = l + 1;
  }
  if (a < lines) wg_pointwise(src, yr, L, a, lines, pg, pm, pk);
}

inline unsigned blocks(int E) { return (unsigned)((E + kWarp - 1) / kWarp); }

// Lets `kernel` take `bytes` of dynamic shared memory: above 48 KB only by
// opting in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

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
  const cudaError_t err = allow_smem(chaos_kernel, sizeof(ChaosSmem));
  if (err != cudaSuccess) return (int)err;
  chaos_kernel<<<(unsigned)((E + kChaosRows - 1) / kChaosRows), 2 * kWarp,
                 sizeof(ChaosSmem), (cudaStream_t)stream>>>(gates, y0, xs, E,
                                                            L, r, gate);
  return (int)cudaGetLastError();
}

// x, y: f32 [E, L] (distinct); d: i32 [E, lines]; g, mix: f32 [E, lines];
// lines > 0.  One block per event, of L / 8 threads rounded up to a warp
// (128 to 1 024); the row in shared memory where it fits the device's
// opt-in limit.
extern "C" int gs_waveguide(const float* x, const int32_t* d, const float* g,
                            const float* mix, float* y, int E, int L,
                            int lines, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t params = (size_t)16 * lines;
  const bool staged = params + (size_t)4 * L <= (size_t)optin;
  const size_t bytes = params + (staged ? (size_t)4 * L : 0);
  err = allow_smem(waveguide_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int want = (L / 8 + kWarp - 1) / kWarp * kWarp;
  const int threads = std::min(kWgMaxThreads, std::max(4 * kWarp, want));
  waveguide_kernel<<<(unsigned)E, threads, bytes, (cudaStream_t)stream>>>(
      x, d, g, mix, y, L, lines, (int)staged);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
