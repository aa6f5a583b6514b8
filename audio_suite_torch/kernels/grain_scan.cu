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
// generators.py (stick_slip_noise_scan_plain, chaos_scan_plain,
// waveguide_scan_plain).  Comparisons are JAX's (<=, <).
//
// Bound on this card.  Bytes: the inputs read once and the output written
// once, 4 bytes a sample for stick-slip, which draws its own noise (xs
// out; the seeds negligible), 8 for micro-chaos (its y0 negligible) and 8
// a sample for the waveguide (x in, y out, whatever its lines).  At the
// factory settings (E 160 with padding, L 2 048) that is 1.3, 2.6 and 2.6
// MB, ~1 us at 3.35 TB/s.  The dependency chain: stick-slip and micro-chaos
// read the step before at every step, so their chain is L steps of a few
// dependent f32 operations of 4 cycles (the force's add, compare and
// select; the map's two multiplies): 8-12 us at 2 048 steps and 1 980 MHz,
// 0.13-0.2 ms at 32 768.  The waveguide's v(t) reads v(t - d), so a line's
// chain is only L / d links long, and its bytes govern.  Stick-slip
// also hashes its noise: 24 murmur3 finalizers a sample (two
// Irwin-Hall(12) normals), ~12.6 SASS instructions each (H100 build:
// ~8.3 of them integer add, logic, shift and I2FP at 64 a clock an SM);
// at config 3's width (E 288, L 32 768) 226.5 M hashes, ~0.11 ms spread
// over the 132 SMs, under the chain's 0.2 ms.
//
// Stick-slip (a stepping warp and kSsProducers producer warps a block, a
// few events a block).  The chain-independent terms of each step, a =
// build (bn nz + 0.2) and o = 0.25 on, are the producers' work: they fill
// a ring of kSsStages tiles of kSsTile steps in shared memory, and the
// stepping warp's lanes 0 .. rows - 1 step one event each (the other lanes
// a scratch row), force and sticking in registers, kSsK steps a register
// block in PTX (ss_chain: no predicate on the chain).  Each block loads
// the next block's terms before it steps, writes its outputs over its a
// terms, and the last of a tile frees the tile's slot with one mbarrier
// arrival; blocks go in pairs, one branch a pair.  The producers store a
// freed tile's outputs (consecutive lanes on consecutive steps of a row:
// coalesced) and refill it.  No block barrier sits in the chain.  The
// producers make the terms from the seeds: both normals hashed in
// registers, bit-equal to ops/noise.py's normal.  The host gives a block
// ceil(E / SMs) events (3 at E 288: 96 blocks, one an SM; 2 at the
// factory's 160), so each SM hashes and steps a few events.  Measured
// (H100, chip_smoke.py): ~23 cycles a step at 1 980 MHz, as fast as with
// the noise rows read from memory, so the stepping warp, not the
// producers, sets the time.  Each step issues ~8
// instructions of the integer pipe (compares to masks, selects, lop3),
// which takes 2 cycles a warp instruction; other encodings of the step
// (all predicates, a deferred reset, the back test as a sign) were no
// faster.
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
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

// ---- mbarriers and cp.async (the stick-slip and micro-chaos rings)

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

// ---- stick-slip

constexpr int kSsK = 32;            // steps a register block
constexpr int kSsTile = 128;        // steps a tile (an even count of blocks)
constexpr int kSsStages = 8;        // tiles in the ring
constexpr int kSsMaxRows = 8;       // events a block at most
constexpr int kSsProducers = 3;     // producer warps
constexpr int kSsThreads = (1 + kSsProducers) * kWarp;
constexpr int kSsPitch = kSsTile + 4;   // a tile row's pitch: 16-byte rows
constexpr uint32_t kGolden = 0x9E3779B9u;   // ops/noise.py's constants
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;

struct SsArgs {
  const int32_t* seed;      // [E]
  float* xs;                // f32 [E, L]
  int E, L, rows;           // rows: events a block
  float thr, build, decay, nz;
  float back;               // |force| < back exactly where |force decay|
  //                           rounds below 0.02 (ss_back_limit)
  uint32_t cb[12], co[12];  // the normals' stream terms, (s 12 + j + 1) M2
};

// Dynamic shared memory: the full and empty mbarriers of each stage, the
// block's seed keys, then the a and o tiles [stage][row][kSsPitch], each
// stage with a scratch row past the block's rows (the stepping warp's
// spare lanes read and write it).
constexpr size_t kSsHead = 2 * kSsStages * sizeof(uint64_t) +
                           kSsMaxRows * sizeof(uint32_t);
static_assert(kSsHead % 16 == 0, "the tiles start 16-byte aligned");
static_assert(kSsTile % (2 * kSsK) == 0 && kSsK % 4 == 0, "tile of blocks");

inline size_t ss_smem_bytes(int rows) {
  return kSsHead +
         (size_t)2 * kSsStages * (rows + 1) * kSsPitch * sizeof(float);
}

// murmur3's finalizer (ops/noise.py _mix) of h with its low 8 bits cleared:
// (h' >> 8) << 8, at most 24 significant bits, which converts to f32 exactly.
__device__ __forceinline__ uint32_t ss_hash_hi24(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return (h ^ (h >> 16)) & 0xFFFFFF00u;
}

// ops/noise.py's normal from the sample's key: the 12 uniforms
// u_j = (h_j >> 8) 2^-24, h_j = mix(key + c_j), summed left to right in
// f32, then - 6.  Summed here as u_j 2^32 (the exact conversions above),
// then scaled by 2^-32: scaling by a power of two scales each partial
// sum's rounding with it (no term or sum is subnormal or overflows), so the
// sum is bit-equal to the unscaled one, with no multiply a uniform.
__device__ __forceinline__ float ss_normal(uint32_t key,
                                           const uint32_t (&c)[12]) {
  float acc = __uint2float_rn(ss_hash_hi24(key + c[0]));
#pragma unroll
  for (int j = 1; j < 12; ++j)
    acc = __fadd_rn(acc, __uint2float_rn(ss_hash_hi24(key + c[j])));
  return __fsub_rn(__fmul_rn(acc, 0x1p-32f), 6.0f);
}

// The step's chain-independent terms from its two normals, in the plain
// loop's order: a = build (bn nz + 0.2), o = 0.25 on.
__device__ __forceinline__ void ss_terms(const SsArgs& args, float bn,
                                         float on, float& a, float& o) {
  a = __fmul_rn(args.build, __fadd_rn(__fmul_rn(bn, args.nz), 0.2f));
  o = __fmul_rn(0.25f, on);
}

__device__ __forceinline__ void ss_load(float (&a)[kSsK], float (&o)[kSsK],
                                        const float* pa, const float* po) {
#pragma unroll
  for (int k = 0; k < kSsK; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(pa + k);
    const float4 y = *reinterpret_cast<const float4*>(po + k);
    a[k] = x.x; a[k + 1] = x.y; a[k + 2] = x.z; a[k + 3] = x.w;
    o[k] = y.x; o[k + 1] = y.y; o[k + 2] = y.z; o[k + 3] = y.w;
  }
}

__device__ __forceinline__ void ss_store(float* p, const float (&v)[kSsK]) {
#pragma unroll
  for (int k = 0; k < kSsK; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// One step of the friction loop (generators.py:194-206) in PTX: force in
// %0, sticking in %1 as a mask (all ones while sticking), the step's terms
// a and o in operands A and O, its output into operand OUT; %98 thr, %99
// decay, %100 the back limit.  Each op rounds once as in the plain loop
// (.rn, no FMA), and the compares are the plain loop's, except that
// |force decay| < 0.02 is |force| < back (ss_back_limit), the same set of
// forces, so the compare waits for no multiply.  The selects on sticking
// are lop3 on masks: nvcc keeps sticking as a predicate or an integer
// bool, with a compare, a select and a predicate op on the chain at every
// step, which ran slower on the H100.  lop3's tables (a
// 0xF0, b 0xCC, c 0xAA): 0x30 a & ~b; 0xE4 c ? a : b; 0xCA a ? b : c.
#define SS_STEP(OUT, A, O)                                          \
  "add.rn.f32 fs, %0, %" #A ";\n"                                   \
  "add.rn.f32 os, %0, %" #O ";\n"                                   \
  "mul.rn.f32 fl, %0, %99;\n"                                       \
  "abs.f32 t, %0;\n"                                                \
  "setp.lt.f32 pb, t, %100;\n"                                      \
  "selp.f32 fl, 0f00000000, fl, pb;\n"                              \
  "selp.b32 mb, -1, 0, pb;\n"                                       \
  "abs.f32 t, fs;\n"                                                \
  "set.le.u32.f32 mn, t, %98;\n"                                    \
  "lop3.b32 %" #OUT ", os, %1, os, 0x30;\n"                         \
  "lop3.b32 %0, fs, fl, %1, 0xE4;\n"                                \
  "lop3.b32 %1, %1, mn, mb, 0xCA;\n"

static_assert(kSsK == 32, "ss_chain's PTX steps 32 times");

// kSsK steps of the friction loop from the terms a and o, into out (the
// plain loop: force_stick = force + a; out_slip = force + o; force_slip =
// force decay, 0 where |force_slip| < 0.02; out = sticking ? 0 :
// out_slip; force = sticking ? force_stick : force_slip; sticking =
// sticking ? |force_stick| <= thr : |force_slip| < 0.02).
__device__ __forceinline__ void ss_chain(float (&out)[kSsK],
                                         const float (&a)[kSsK],
                                         const float (&o)[kSsK],
                                         float& force, uint32_t& sticking,
                                         float thr, float decay, float back) {
  asm("{\n"
      ".reg .f32 fs, os, fl, t;\n"
      ".reg .b32 mn, mb;\n"
      ".reg .pred pb;\n"
      SS_STEP(2, 34, 66)
      SS_STEP(3, 35, 67)
      SS_STEP(4, 36, 68)
      SS_STEP(5, 37, 69)
      SS_STEP(6, 38, 70)
      SS_STEP(7, 39, 71)
      SS_STEP(8, 40, 72)
      SS_STEP(9, 41, 73)
      SS_STEP(10, 42, 74)
      SS_STEP(11, 43, 75)
      SS_STEP(12, 44, 76)
      SS_STEP(13, 45, 77)
      SS_STEP(14, 46, 78)
      SS_STEP(15, 47, 79)
      SS_STEP(16, 48, 80)
      SS_STEP(17, 49, 81)
      SS_STEP(18, 50, 82)
      SS_STEP(19, 51, 83)
      SS_STEP(20, 52, 84)
      SS_STEP(21, 53, 85)
      SS_STEP(22, 54, 86)
      SS_STEP(23, 55, 87)
      SS_STEP(24, 56, 88)
      SS_STEP(25, 57, 89)
      SS_STEP(26, 58, 90)
      SS_STEP(27, 59, 91)
      SS_STEP(28, 60, 92)
      SS_STEP(29, 61, 93)
      SS_STEP(30, 62, 94)
      SS_STEP(31, 63, 95)
      SS_STEP(32, 64, 96)
      SS_STEP(33, 65, 97)
      "}\n"
      : "+f"(force), "+r"(sticking), "=f"(out[0]), "=f"(out[1]),
        "=f"(out[2]), "=f"(out[3]), "=f"(out[4]), "=f"(out[5]), "=f"(out[6]),
        "=f"(out[7]), "=f"(out[8]), "=f"(out[9]), "=f"(out[10]),
        "=f"(out[11]), "=f"(out[12]), "=f"(out[13]), "=f"(out[14]),
        "=f"(out[15]), "=f"(out[16]), "=f"(out[17]), "=f"(out[18]),
        "=f"(out[19]), "=f"(out[20]), "=f"(out[21]), "=f"(out[22]),
        "=f"(out[23]), "=f"(out[24]), "=f"(out[25]), "=f"(out[26]),
        "=f"(out[27]), "=f"(out[28]), "=f"(out[29]), "=f"(out[30]),
        "=f"(out[31])
      : "f"(a[0]), "f"(a[1]), "f"(a[2]), "f"(a[3]), "f"(a[4]), "f"(a[5]),
        "f"(a[6]), "f"(a[7]), "f"(a[8]), "f"(a[9]), "f"(a[10]), "f"(a[11]),
        "f"(a[12]), "f"(a[13]), "f"(a[14]), "f"(a[15]), "f"(a[16]),
        "f"(a[17]), "f"(a[18]), "f"(a[19]), "f"(a[20]), "f"(a[21]),
        "f"(a[22]), "f"(a[23]), "f"(a[24]), "f"(a[25]), "f"(a[26]),
        "f"(a[27]), "f"(a[28]), "f"(a[29]), "f"(a[30]), "f"(a[31]),
        "f"(o[0]), "f"(o[1]), "f"(o[2]), "f"(o[3]), "f"(o[4]), "f"(o[5]),
        "f"(o[6]), "f"(o[7]), "f"(o[8]), "f"(o[9]), "f"(o[10]), "f"(o[11]),
        "f"(o[12]), "f"(o[13]), "f"(o[14]), "f"(o[15]), "f"(o[16]),
        "f"(o[17]), "f"(o[18]), "f"(o[19]), "f"(o[20]), "f"(o[21]),
        "f"(o[22]), "f"(o[23]), "f"(o[24]), "f"(o[25]), "f"(o[26]),
        "f"(o[27]), "f"(o[28]), "f"(o[29]), "f"(o[30]), "f"(o[31]),
        "f"(thr), "f"(decay), "f"(back));
}
#undef SS_STEP

// xs[e, t]: the stick-slip friction loop (generators.py:194-206) for the
// events [e0, e0 + rows); its terms from the counter noise of the seeds.
// Warp 0 steps, warps 1 .. kSsProducers fill the ring and store the
// outputs.
__global__ void __launch_bounds__(kSsThreads)
stick_slip_kernel(const __grid_constant__ SsArgs args) {
  extern __shared__ __align__(16) unsigned char ss_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ss_smem);   // terms written
  uint64_t* empty = full + kSsStages;                      // outputs written
  uint32_t* skey = reinterpret_cast<uint32_t*>(empty + kSsStages);
  float* ta = reinterpret_cast<float*>(ss_smem + kSsHead);
  const int R = args.rows, E = args.E, L = args.L;
  const int stage = (R + 1) * kSsPitch;    // floats a stage of a or o
  float* to = ta + kSsStages * stage;
  const int lane = threadIdx.x & (kWarp - 1);
  const int e0 = blockIdx.x * R;
  const int nt = (L + kSsTile - 1) / kSsTile;
  if (threadIdx.x < kSsStages) {
    mbar_init(&full[threadIdx.x], kSsProducers * kWarp);
    mbar_init(&empty[threadIdx.x], kWarp);
  }
  if (threadIdx.x < R)
    skey[threadIdx.x] =
        (uint32_t)args.seed[min(e0 + (int)threadIdx.x, E - 1)] * kGolden;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < kWarp) {
    // the stepping warp: lane r steps event e0 + r; lanes past rows step
    // the scratch row
    constexpr int kBlocks = kSsTile / kSsK;   // even: a pair never
    //                                           straddles two tiles
    const int row = min(lane, R) * kSsPitch;
    float force = 0.0f;
    uint32_t sticking = 0xFFFFFFFFu;
    float a0[kSsK], o0[kSsK], a1[kSsK], o1[kSsK], v[kSsK];
    mbar_wait(&full[0], 0);
    ss_load(a0, o0, ta + row, to + row);
    // blocks b and b + 1 of tile i: each loads the next block's terms
    // before it steps its own (the tile's next, then the next tile's first
    // block, waiting for it; past the last tile the loads read a stale
    // slot and are never stepped) and writes its outputs over its a terms
#pragma unroll 1
    for (int b = 0; b < nt * kBlocks; b += 2) {
      const int i = b / kBlocks, k = b % kBlocks;
      float* pa = ta + (i % kSsStages) * stage + row + k * kSsK;
      const float* po = to + (i % kSsStages) * stage + row + k * kSsK;
      ss_load(a1, o1, pa + kSsK, po + kSsK);
      ss_chain(v, a0, o0, force, sticking, args.thr, args.decay, args.back);
      ss_store(pa, v);
      const bool last = k + 2 == kBlocks;
      int off = 2 * kSsK;                    // the next block: this tile's
      if (last) {                            // or the next tile's first
        const int i1 = i + 1;
        if (i1 < nt)
          mbar_wait(&full[i1 % kSsStages], (uint32_t)(i1 / kSsStages) & 1);
        off = ((i1 % kSsStages) - (i % kSsStages)) * stage - k * kSsK;
      }
      ss_load(a0, o0, pa + off, po + off);
      ss_chain(v, a1, o1, force, sticking, args.thr, args.decay, args.back);
      ss_store(pa + kSsK, v);
      if (last) mbar_arrive(&empty[i % kSsStages]);
    }
    return;
  }

  // the producers: sample q = row kSsTile + column of a tile, thread p
  // taking q = p, p + NP, ... (consecutive lanes on consecutive steps)
  constexpr int NP = kSsProducers * kWarp;
  const int p = threadIdx.x - kWarp;
  const int n = R * kSsTile;
  // tile j's outputs, over its a terms once the stepping warp frees it, to xs
  auto store = [&](int j) {
    const int s = j % kSsStages, t0 = j * kSsTile;
    mbar_wait(&empty[s], (uint32_t)(j / kSsStages) & 1);
    const float* src = ta + s * stage;
    for (int q = p; q < n; q += NP) {
      const int row = q / kSsTile, c = q % kSsTile;
      if (e0 + row < E && t0 + c < L)
        args.xs[(int64_t)(e0 + row) * L + t0 + c] = src[row * kSsPitch + c];
    }
  };
  for (int i = 0; i < nt; ++i) {
    const int s = i % kSsStages, t0 = i * kSsTile;
    if (i >= kSsStages) store(i - kSsStages);
    for (int q = p; q < n; q += NP) {
      const int row = q / kSsTile, c = q % kSsTile;
      const uint32_t key = skey[row] + (uint32_t)(t0 + c) * kM1;
      float a, o;
      ss_terms(args, ss_normal(key, args.cb), ss_normal(key, args.co), a, o);
      ta[s * stage + row * kSsPitch + c] = a;
      to[s * stage + row * kSsPitch + c] = o;
    }
    mbar_arrive(&full[s]);
  }
  for (int j = max(0, nt - kSsStages); j < nt; ++j) store(j);
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

// Lets `kernel` take `bytes` of dynamic shared memory: above 48 KB only by
// opting in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The least float b >= 0 with |b decay| >= 0.02f or NaN, in f32 rounded to
// nearest as on the card (0 for a NaN or infinite decay, +inf for a decay
// of 0): |f decay| rounds monotonically in |f|, so |f decay| < 0.02f
// exactly where |f| < b, NaN and infinite f included (inf 0 is NaN, and
// inf < inf is false).
float ss_back_limit(float decay) {
  const float d = std::fabs(decay);
  if (std::isnan(d)) return 0.0f;
  auto back = [d](uint32_t bits) {
    float f;
    std::memcpy(&f, &bits, 4);
    const volatile float p = f * d;
    return std::fabs(p) < 0.02f;
  };
  uint32_t lo = 0, hi = 0x7F800000u;   // back(lo) or lo is the answer
  if (!back(0)) return 0.0f;           // |0 * inf| is NaN
  while (hi - lo > 1) {                // back(lo), !back(hi)
    const uint32_t mid = lo + (hi - lo) / 2;
    (back(mid) ? lo : hi) = mid;
  }
  float b;
  std::memcpy(&b, &hi, 4);
  return b;
}

// One stick-slip launch: ceil(E / SMs) events a block, at most kSsMaxRows,
// so that every SM hashes and steps a few events.
cudaError_t ss_launch(SsArgs args, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  args.rows = std::min(kSsMaxRows, std::max(1, (args.E + sms - 1) / sms));
  args.back = ss_back_limit(args.decay);
  const size_t bytes = ss_smem_bytes(args.rows);
  err = allow_smem(stick_slip_kernel, bytes);
  if (err != cudaSuccess) return err;
  stick_slip_kernel<<<(unsigned)((args.E + args.rows - 1) / args.rows),
                      kSsThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Each launch function runs on `stream` and returns cudaGetLastError()
// (0 on success).  Pointers are device pointers to contiguous row-major
// arrays; E > 0, L > 0.

// seed: i32 [E] (as uint32); xs: f32 [E, L].  The noise rows are
// ops/noise.py's normal(seed, t, stream_build) and normal(seed, t,
// stream_out) for t in [0, L).
extern "C" int gs_stick_slip_noise(const int32_t* seed, float* xs, int E,
                                   int L, float thr, float build, float decay,
                                   float nz, unsigned stream_build,
                                   unsigned stream_out, void* stream) {
  SsArgs args = {seed, xs, E, L, 0, thr, build, decay, nz, 0.0f, {}, {}};
  for (unsigned j = 0; j < 12; ++j) {
    args.cb[j] = (stream_build * 12u + j + 1u) * kM2;
    args.co[j] = (stream_out * 12u + j + 1u) * kM2;
  }
  return (int)ss_launch(args, (cudaStream_t)stream);
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
