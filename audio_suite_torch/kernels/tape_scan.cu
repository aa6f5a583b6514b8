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
// Design.  The position is an exact integer, p = whole * 2^22 + frac, and
// nothing read from the audio feeds back into the state.  Where the
// section, the speed and the splice state hold still, p after j steps is
// the start plus a prefix sum of increments that depend on mod_q alone.
// The steps are cut into chunks of K (a power of two, 32 to 4 096):
//
// - tape_sums_kernel (the whole card): one warp a chunk sums the chunk's
//   increments in int64 at the speed of each of the first kTableRows
//   sections, with the chunk's last increment and whether every increment
//   lies in [0, kIncMax] (no int32 overflow in frac + inc).
// - tape_walk_kernel (one block): walks the chunks in order with the
//   state.  At a chunk start whose step is the common one (the position in
//   [0, n), its section cached, its read index strictly between its two
//   neighbouring boundaries) with a steady speed (inertia off, or its
//   update leaving it bit for bit), warp 0 takes the sums of the next 128
//   chunks at that speed, four a lane (from a window of the table's row in
//   shared memory where the speed is the section's own, which the block
//   refills; else the block's warps sum them from mod_q), scans the lanes'
//   sums (int64), and each lane tests its chunks in order, each chunk's
//   first and last read position: both common and every increment in
//   [0, kIncMax] (jump_group).  The position is then
//   monotone over the chunk, and the section's interval and the read
//   index's interval between boundaries are intervals, so the two ends
//   hold every step in.  The chunks before the first that fails are
//   jumped: their start states come from the scan, the splice advances in
//   closed form (min(rem, E - sidx) applications, clipped to the steps).
//   A chunk that fails is walked by warp 0 (walk_chunk): from a common
//   step at a steady speed the same test on runs of 32 steps, else a
//   round of up to 32 steps (the increments' prefix sum, with inertia its
//   speeds first, one update after another: the only sequential part), a
//   ballot for the first step that is not the common one, the steps
//   before it in closed form and that step by the chain's own step() (the
//   section and boundary searches, the wrap, the trigger).  The walk
//   writes each chunk's start state and kind, the walked chunks' count and
//   the final state.
// - tape_replay_kernel (the whole card): one block a chunk.  A jumped
//   chunk's warps take four slices (each slice's start from the block's
//   scan of their sums) and rebuild the positions by prefix sum from the
//   chunk's start state, the read index, the envelope's index (sidx + j
//   for the first applications), and read, apply the gains and clip.  A
//   walked chunk's warp 0 walks it again from its start state with
//   walk_chunk, a piece of kPiece steps at a time, keeping each step's
//   read index, fraction and envelope index in shared memory, and the
//   block reads the piece.
//
// Rounding.  Every f32 operation is written with __f*_rn, which nvcc never
// contracts into a fused multiply-add, so each rounds once, in the JAX
// step's order; rint and the f32-to-int conversion round half to even
// (rintf, __float2int_rn), like jnp.rint; positions are summed in int64,
// exact, and split into the step's int32 words.  The result is bit-equal
// to tape_scan_render_plain (audio_suite_torch/ops/varispeed.py), and
// does not depend on K.
//
// Limits.  The function's bound is its bytes: the read is a gather of 8
// bytes and 16 bytes of streams a sample; this design reads mod_q twice
// (the sums and the replay) and moves the table and the records besides.
// The sums and the replay run at the card's width.  What stays
// sequential is the walk, one SM: a decision a 128 chunks (window reads,
// the 64-bit scan, four pairs of tests, a ballot, the start states'
// stores: a chain of dependent latencies), and for each walked chunk its
// runs and rounds, which with inertia before its speed freezes run the
// speed's update step after step (six dependent f32 operations).  Where
// the speed in force is no section's own (inertia frozen off its target)
// the walk sums the chunks itself, at one SM's share of the memory rate.
//
// The control tables (ts_tables_launch).  The device engine renders from
// compact tables (visits, constant speed runs, splice triggers) that the
// C++ walk ast_tape_tables (native/ast_runtime.cpp) builds on the host by
// taking one thread through every output sample.  With inertia off a
// visit's speed is its section's, so the walk is a search: a visit ends at
// the first sample whose increments' prefix reaches the section's end,
// and a splice trigger lies in the few samples where the read index can
// equal a boundary.  The same chunks answer both:
//
// - tables_sums_kernel (the whole card): one warp a chunk computes each
//   sample's wow/flutter modulation in registers (the C++'s expression,
//   each f32 operation rounded once) and sums the int64 increments at the
//   speed of each of the first kTableRows distinct section speeds.
//   Nothing of size T is written.
// - tables_walk_kernel (one block, every thread holding the same state):
//   for each visit the section and its distance to the section's end,
//   then seek(): the chunks' sums, kTabThreads at a time and scanned,
//   find the chunk where the prefix reaches the distance (a speed with no
//   row sums its chunks itself), and that chunk's increments, recomputed
//   and scanned, the exact sample.  With the splice on, each boundary
//   the visit can reach, in time order, gets its window by the same
//   search and the C++'s per-sample rule inside it.  The records are
//   capped at a capacity and counted past it (the caller retries with
//   room), then packed after a header.
//
// Its bound is the sums' operations: 39 f32 operations a sample for the
// modulation (each sine needs its quadrant's one polynomial; sin_cycles
// computes both and selects, 57 in all) and 3 a speed.  The walk is a
// chain of block-wide scans, a few a visit and a window, each a few
// barriers long.  The decisions are
// the C++ walk's integers, held bit-equal in the tests.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFracBits = 22;
constexpr int kPosOne = 1 << kFracBits;
constexpr int kFracMask = kPosOne - 1;
constexpr float kPosOneF = 4194304.0f;              // 2^22
constexpr float kPosInvF = 2.384185791015625e-07f;  // 2^-22, exact
// the largest increment with no int32 overflow in frac + inc, frac < 2^22
constexpr int kIncMax = INT_MAX - kFracMask;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkWarps = 16;    // the walk's block
constexpr int kLaneChunks = 4;    // chunks a lane in a walk decision
constexpr int kGroupChunks = 32 * kLaneChunks;
constexpr int kReplayWarps = 4;   // sums: one chunk a warp; replay: one
//                                   chunk a block
constexpr int kPiece = 256;       // steps of a walked chunk a replay piece
constexpr int kTableRows = 16;    // sections whose speed the sums cover
constexpr int kTableWindow = 1024;  // the walk's shared window of the table
constexpr int kMinChunk = 32;
constexpr int kMaxChunk = 4096;
// a chunk's record: whole, frac, speed's bits, rem, sidx, kind (bit 0:
// jumped, bit 1: its section reversed), s0, e0
constexpr int kRecWords = 8;
// shared words of the tables: 4 per section and 1 per boundary (48 KB)
constexpr int kMaxTableWords = 12288;

struct Consts {
  int n, S, B, E;
  int anticlick, smooth_len, splice, inertia;
  float strength, inv_smooth, alpha;
};

struct Tables {
  const int* starts;
  const int* ends;
  const float* speeds;
  const int* rev;
  const int* bnd;
};

__device__ __forceinline__ int floor_mod(int x, int m) {  // m > 0
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the 2^-22 grid rounding (fixq.quantize_f32): exact scale, rint, exact
// scale back
__device__ __forceinline__ float quantize(float x) {
  return __fmul_rn(rintf(__fmul_rn(x, kPosOneF)), kPosInvF);
}

// the step's increment: rint(speed * mq * 2^22)
__device__ __forceinline__ int increment(float speed, float mq) {
  return __float2int_rn(__fmul_rn(__fmul_rn(speed, mq), kPosOneF));
}

// the splice envelope's applications in `steps` steps with no trigger
__device__ __forceinline__ long long applications(int rem, int sidx, int E,
                                                  long long steps) {
  long long a = (long long)E - sidx;
  a = rem < a ? rem : a;
  return a < 0 ? 0 : (a > steps ? steps : a);
}

__device__ __forceinline__ long long warp_scan(long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// The warp copies src[0, L) to shared memory (cp.async, 4 bytes a copy,
// all in flight at once), then waits for its copies.
__device__ __forceinline__ void stage_copy(float* dst,
                                           const float* __restrict__ src,
                                           int L, int lane) {
  for (int j = lane; j < L; j += 32) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + j);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + j));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// _read_index of (w, frac) at `local` = w - s0 in the section [s0, e0),
// clipped to [0, n - 1]
__device__ __forceinline__ void read_index(int s0, int e0, int rv, int n,
                                           int local, int frac, int& idx0,
                                           float& fr) {
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
  idx0 = clampi(idx0, 0, n - 1);
}

// the read, the anti-click gain, the envelope, the clip (NaN passes the
// clip, as in jnp.clip and torch.clamp)
__device__ __forceinline__ float tape_sample(const float* __restrict__ audio,
                                             const int* bnd,
                                             const float* __restrict__ env,
                                             const Consts& c, int i0, float f,
                                             int gi) {
  const int i1 = i0 + 1 < c.n ? i0 + 1 : c.n - 1;
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
  if (gi >= 0 && c.E > 0) s = __fmul_rn(s, __ldg(env + gi));
  s = s < -1.0f ? -1.0f : s;
  s = s > 1.0f ? 1.0f : s;
  return s;
}

// The tables in shared memory (all threads of the block load them; the
// caller synchronises).
__device__ Tables load_tables(int* smem, const int* __restrict__ starts_g,
                              const int* __restrict__ ends_g,
                              const float* __restrict__ speeds_g,
                              const unsigned char* __restrict__ rev_g,
                              const int* __restrict__ bnd_g, const Consts& c) {
  int* starts = smem;
  int* ends = starts + c.S;
  float* speeds = reinterpret_cast<float*>(ends + c.S);
  int* rev = reinterpret_cast<int*>(speeds + c.S);
  int* bnd = rev + c.S;
  for (int k = threadIdx.x; k < c.S; k += blockDim.x) {
    starts[k] = starts_g[k];
    ends[k] = ends_g[k];
    speeds[k] = speeds_g[k];
    rev[k] = rev_g[k] != 0;
  }
  for (int k = threadIdx.x; k < c.B; k += blockDim.x) bnd[k] = bnd_g[k];
  return Tables{starts, ends, speeds, rev, bnd};
}

// The scan's carried state and its caches.  step() runs a straight line of
// selects for the common step (the position in [0, 2n), its section
// unchanged, the read index strictly between its two neighbouring
// boundaries) and takes one branch, to general(), for any other.
template <bool kSplice, bool kInertia>
struct Chain {
  Tables t;
  Consts c;
  // carried state
  int whole, frac, rem, sidx;
  float speed;
  // section cache: the count holds for lo <= w < hi (INT_MIN / INT_MAX:
  // no start on that side; w lies in [0, n) with n < 2^31)
  int lo, hi;
  int sec, s0, e0, len, rv;
  float target;
  // boundary cache: idx0 hits none while blo < idx0 < bhi
  int blo, bhi;

  __device__ __forceinline__ void init(const Tables& tb, const Consts& cc,
                                       int w, int f, float sp, int r,
                                       int si) {
    t = tb;
    c = cc;
    whole = w;
    frac = f;
    speed = sp;
    rem = r;
    sidx = si;
    lo = 1;                             // empty: the first step searches
    hi = 0;
    blo = bhi = 0;                      // likewise
    sec = s0 = e0 = len = rv = 0;
    target = 0.0f;
  }

  __device__ __forceinline__ void find_section(int w) {
    int cnt = 0;
    lo = INT_MIN;
    hi = INT_MAX;
    for (int k = 0; k < c.S; ++k) {
      const int s = t.starts[k];
      if (w >= s) {
        ++cnt;
        lo = s > lo ? s : lo;
      } else {
        hi = s < hi ? s : hi;
      }
    }
    sec = clampi(cnt - 1, 0, c.S - 1);
    s0 = t.starts[sec];
    e0 = t.ends[sec] <= s0 ? s0 + 1 : t.ends[sec];
    len = e0 - s0;
    rv = t.rev[sec];
    target = t.speeds[sec];
  }

  // the boundary test by search; on a hit the cache is left empty, so
  // the next step searches again
  __device__ __forceinline__ bool find_boundary(int idx0) {
    bool hit = false;
    blo = INT_MIN;
    bhi = INT_MAX;
    for (int k = 0; k < c.B; ++k) {
      const int b = t.bnd[k];
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

  // the step's start for any state: w = whole mod n, the section, the
  // read index and the boundary test, all by search where needed
  __device__ __forceinline__ void general(int& idx0, float& fr, bool& hit) {
    int w = whole;
    if (w < 0 || w >= c.n) w = floor_mod(w, c.n);
    if (w < lo || w >= hi) find_section(w);
    whole = w;
    const int x = w - s0;
    read_index(s0, e0, rv, c.n, (x >= 0 && x < len) ? x : floor_mod(x, len),
               frac, idx0, fr);
    hit = kSplice && !(idx0 > blo && idx0 < bhi) && find_boundary(idx0);
  }

  __device__ __forceinline__ float next_speed(float s) const {
    return kInertia
               ? __fadd_rn(s, quantize(__fmul_rn(__fsub_rn(target, s),
                                                 c.alpha)))
               : target;
  }

  // Whether the position p = w * 2^22 + frac (w in [0, n), frac in
  // [0, 2^22)) reads as the common step: its section cached and its read
  // index strictly inside the boundary cache; its read index either way.
  __device__ __forceinline__ bool common_at(long long p, int& idx0,
                                            float& fr) const {
    const long long wl = p >> kFracBits;
    const bool in = wl >= 0 && wl < c.n && wl >= lo && wl < hi;
    const int x = (in ? (int)wl : s0) - s0;
    read_index(s0, e0, rv, c.n, x, (int)(p & kFracMask), idx0, fr);
    return in && (unsigned)x < (unsigned)len &&
           (!kSplice || (idx0 > blo && idx0 < bhi));
  }

  // The state's position, its whole part reduced mod n as the next step
  // reduces it, and whether the next step is the common one.
  __device__ __forceinline__ bool start(long long& p) {
    if (whole < 0 || whole >= c.n) whole = floor_mod(whole, c.n);
    p = ((long long)whole << kFracBits) + frac;
    int idx0;
    float fr;
    return (unsigned)frac < (unsigned)kPosOne && common_at(p, idx0, fr);
  }

  // start(), and whether the speed is steady: v, the speed of every step
  // while the section holds (inertia off: the target; on: a speed its
  // update leaves bit for bit).
  __device__ __forceinline__ bool steady_start(long long& p, float& v) {
    if (!start(p)) return false;
    v = kInertia ? speed : target;
    return !kInertia || __float_as_int(next_speed(v)) == __float_as_int(v);
  }

  // The state after `steps` common steps at the steady speed v that end
  // at position pf: the splice's applications in closed form.
  __device__ __forceinline__ void advance(long long pf, float v,
                                          long long steps) {
    if (kSplice) {
      const int a = (int)applications(rem, sidx, c.E, steps);
      rem -= a;
      sidx += a;
    }
    whole = (int)(pf >> kFracBits);
    frac = (int)(pf & kFracMask);
    speed = v;
  }

  // One step with the step's mod value: the sample's read index,
  // fraction and envelope index (-1: none), and the state advanced.
  __device__ __forceinline__ void step(float mq, int& idx0, float& fr,
                                       int& gi) {
    const int w = whole >= c.n ? whole - c.n : whole;
    const int x = w - s0;
    read_index(s0, e0, rv, c.n, x, frac, idx0, fr);
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
      gi = apply ? clampi(sidx, 0, c.E - 1) : -1;
      rem -= apply;
      sidx += apply;
    }
    speed = next_speed(speed);
    const int f = frac + increment(speed, mq);
    const int carry = f >> kFracBits;
    whole += carry;
    frac = f - (carry << kFracBits);
  }
};

// The warp's test of up to 32 consecutive runs of steps from the common
// position p at a steady speed, lane k holding run k's increment sum s,
// last increment and flag (every increment in [0, kIncMax]): a run jumps
// if its first and last read positions are both common, and the runs
// before the first that fails jump.  The position is then monotone over
// each run, and the section's interval and the read index's interval
// between boundaries are intervals, so the two ends hold every step in.
// Returns how many runs jump; incl: the increments' inclusive scan.
template <bool kSplice, bool kInertia>
__device__ __forceinline__ int jumpable(const Chain<kSplice, kInertia>& ch,
                                        long long p, int nvalid, long long s,
                                        int last, bool ok, int lane,
                                        long long& incl) {
  incl = warp_scan(s, lane);
  const long long first = p + incl - s;
  int ix;
  float fx;
  const bool jump = lane < nvalid && ok && ch.common_at(first, ix, fx) &&
                    ch.common_at(first + s - last, ix, fx);
  const unsigned bad = __ballot_sync(kFull, !jump);
  return bad ? __ffs(bad) - 1 : 32;
}

// The read index, fraction and envelope index of `steps` common steps at
// the steady speed v from position p (mod values mqs[0, steps)) into
// o_idx0, o_fr, o_gi, 32 at a time.
template <bool kSplice, bool kInertia>
__device__ void emit_steady(const Chain<kSplice, kInertia>& ch, long long p,
                            float v, const float* mqs, int steps, int lane,
                            int* o_idx0, float* o_fr, int* o_gi) {
  const int a = kSplice ? (int)applications(ch.rem, ch.sidx, ch.c.E, steps)
                        : 0;
  for (int t = 0; t < steps; t += 32) {
    const int j = t + lane;
    const int inc = j < steps ? increment(v, mqs[j]) : 0;
    const long long incl = warp_scan(inc, lane);
    int idx0;
    float fr;
    ch.common_at(p + incl - inc, idx0, fr);
    if (j < steps) {
      o_idx0[j] = idx0;
      o_fr[j] = fr;
      o_gi[j] = j < a ? clampi(ch.sidx + j, 0, ch.c.E - 1) : -1;
    }
    p += __shfl_sync(kFull, incl, 31);
  }
}

// Walk the L steps of one chunk (mod values mqs, in shared memory) from
// the chain's state, all 32 lanes holding the same chain.  From a common
// step at a steady speed, the next up to 32 runs of 32 steps are tested
// (jumpable) and the runs that jump advance in closed form.  Otherwise a
// round of up to 32 steps: at a speed v_j a step (inertia: the speed's
// updates one after another, unless it is steady), the increments' prefix
// sum gives each step's position; the first step that is not the common
// one (or whose increment could overflow) is found by ballot; the steps
// before it advance in closed form and that step runs step().  With
// kEmit, step i's read index, fraction and envelope index go to
// o_idx0[i], o_fr[i], o_gi[i].
template <bool kSplice, bool kInertia, bool kEmit>
__device__ void walk_chunk(Chain<kSplice, kInertia>& ch, const float* mqs,
                           int L, int lane, int* o_idx0, float* o_fr,
                           int* o_gi) {
  for (int i = 0; i < L;) {
    long long p;
    float v;
    if (ch.steady_start(p, v)) {
      const int r0 = i + 32 * lane;
      const int len = L - r0 < 0 ? 0 : (L - r0 > 32 ? 32 : L - r0);
      long long s = 0;
      int last = 0;
      bool ok = true;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int u = (t + lane) & 31;  // rotated: no shared-memory conflicts
        if (u < len) {
          const int inc = increment(v, mqs[r0 + u]);
          s += inc;
          ok &= (inc >= 0) & (inc <= kIncMax);
          if (u == len - 1) last = inc;
        }
      }
      const int runs = (L - i + 31) / 32;
      long long incl;
      const int f = jumpable(ch, p, runs < 32 ? runs : 32, s, last, ok, lane,
                             incl);
      if (f > 0) {
        const int steps = L - i < 32 * f ? L - i : 32 * f;
        if (kEmit)
          emit_steady(ch, p, v, mqs + i, steps, lane, o_idx0 + i, o_fr + i,
                      o_gi + i);
        ch.advance(p + __shfl_sync(kFull, incl, f - 1), v, steps);
        i += steps;
        continue;
      }
    }
    const int m = L - i < 32 ? L - i : 32;
    int ix = 0, gi = -1, f = 0;
    float fx = 0.0f;
    if (ch.start(p)) {
      v = kInertia ? ch.speed : ch.target;
      if (kInertia && __float_as_int(ch.next_speed(v)) != __float_as_int(v)) {
        float sp = v;
        for (int k = 0; k < m; ++k) {
          sp = ch.next_speed(sp);
          v = lane == k ? sp : v;
        }
      }
      const int inc = lane < m ? increment(v, mqs[i + lane]) : 0;
      const long long incl = warp_scan(inc, lane);
      const bool ok = lane < m && inc <= kIncMax &&
                      ch.common_at(p + incl - inc, ix, fx);
      const unsigned bad = __ballot_sync(kFull, !ok);
      f = bad ? __ffs(bad) - 1 : 32;
      if (f > 0) {
        if (kSplice) {
          const int a = (int)applications(ch.rem, ch.sidx, ch.c.E, f);
          gi = lane < a ? clampi(ch.sidx + lane, 0, ch.c.E - 1) : -1;
        }
        ch.advance(p + __shfl_sync(kFull, incl, f - 1),
                   __shfl_sync(kFull, v, f - 1), f);
      }
    }
    if (f < m) {                        // that step by the chain's code
      int i0, g;
      float fr;
      ch.step(mqs[i + f], i0, fr, g);
      if (lane == f) {
        ix = i0;
        fx = fr;
        gi = g;
      }
    }
    const int done = f < m ? f + 1 : m;
    if (kEmit && lane < done) {
      o_idx0[i + lane] = ix;
      o_fr[i + lane] = fx;
      o_gi[i + lane] = gi;
    }
    i += done;
  }
}

struct ChunkSum {
  long long sum;
  int last;
  bool ok;
};

// One warp: the sum of chunk [base, base + L)'s increments at speed v, its
// last increment, and whether every increment lies in [0, kIncMax].
__device__ __forceinline__ ChunkSum chunk_sum(const float* __restrict__ mod_q,
                                              long long base, int L, float v,
                                              int lane) {
  long long s = 0;
  int last = 0;
  bool ok = true;
#pragma unroll 16
  for (int j = lane; j < L; j += 32) {
    const int inc = increment(v, __ldg(mod_q + base + j));
    s += inc;
    ok &= (inc >= 0) & (inc <= kIncMax);
    last = inc;
  }
  return ChunkSum{warp_sum(s), __shfl_sync(kFull, last, (L - 1) & 31),
                  __all_sync(kFull, ok) != 0};
}

struct Scratch {
  int* rec;               // [nchunks][kRecWords]
  int* nwalked;           // [1]: the walked chunks' count
  int4* tab;              // [R][nchunks]: sum's low and high words,
                          // last increment, flag
};

__host__ __device__ inline long long table_offset(long long nchunks) {
  return (kRecWords * nchunks + 1 + 3) / 4 * 4;  // 16-byte aligned
}

__host__ __device__ inline Scratch scratch_at(int* base, long long nchunks,
                                              int R) {
  Scratch s;
  s.rec = base;
  s.nwalked = base + kRecWords * nchunks;
  s.tab = reinterpret_cast<int4*>(base + table_offset(nchunks));
  return s;
}

// One warp a chunk: its sums at the first R sections' speeds (the chunk's
// mod values stay in L1 from the first row to the last).
__global__ void __launch_bounds__(kReplayWarps * 32)
    tape_sums_kernel(const float* __restrict__ mod_q, long long T, int K,
                     long long nchunks, const float* __restrict__ speeds_g,
                     int R, Scratch sc) {
  const int lane = threadIdx.x & 31;
  const long long ck = (long long)blockIdx.x * kReplayWarps +
                       (threadIdx.x >> 5);
  if (ck >= nchunks) return;
  const long long base = ck * K;
  const int L = T - base < K ? (int)(T - base) : K;
  for (int r = 0; r < R; ++r) {
    const ChunkSum cs = chunk_sum(mod_q, base, L, __ldg(speeds_g + r), lane);
    if (lane == 0)
      sc.tab[r * nchunks + ck] = make_int4((int)cs.sum, (int)(cs.sum >> 32),
                                           cs.last, cs.ok);
  }
}

// Warp 0's decision on the (up to kGroupChunks) chunks from ck, lane k
// holding chunks ck + kLaneChunks k .. + kLaneChunks - 1, whose table
// entries (sum's words, last increment, flag) start at e: from the common
// position p at the steady speed v, the lanes' sums are scanned, each lane
// tests its chunks in order as jumpable() tests a run, and the chunks
// before the first that fails jump: they get their records and the state
// advances past them.  Returns how many.
template <bool kSplice, bool kInertia>
__device__ int jump_group(Chain<kSplice, kInertia>& ch, long long p, float v,
                          long long ck, int nvalid, const int4* e, int K,
                          long long T, int* rec, int lane) {
  long long s[kLaneChunks], first[kLaneChunks], tot = 0;
  int last[kLaneChunks];
  bool ok[kLaneChunks];
#pragma unroll
  for (int t = 0; t < kLaneChunks; ++t) {
    const int g = kLaneChunks * lane + t;
    const int4 x = g < nvalid ? e[g] : make_int4(0, 0, 0, 0);
    s[t] = ((long long)x.y << 32) | (unsigned)x.x;
    last[t] = x.z;
    ok[t] = g < nvalid && x.w != 0;
    tot += s[t];
  }
  // each chunk's first position, and whether it jumps, all at once; j:
  // the chunks that jump before the lane's first that fails
  first[0] = p + warp_scan(tot, lane) - tot;
#pragma unroll
  for (int t = 1; t < kLaneChunks; ++t) first[t] = first[t - 1] + s[t - 1];
  int j = kLaneChunks;
#pragma unroll
  for (int t = kLaneChunks - 1; t >= 0; --t) {
    int ix;
    float fx;
    const bool a = ch.common_at(first[t], ix, fx);
    const bool b = ch.common_at(first[t] + s[t] - last[t], ix, fx);
    if (!(ok[t] && a && b)) j = t;
  }
  const long long end = j < kLaneChunks ? first[j] : first[0] + tot;
  const unsigned bad = __ballot_sync(kFull, j < kLaneChunks);
  const int fl = bad ? __ffs(bad) - 1 : 32;   // the first lane that fails
  const int f = kLaneChunks * fl + (fl < 32 ? __shfl_sync(kFull, j, fl) : 0);
  const int mine = lane < fl ? kLaneChunks : (lane == fl ? j : 0);
#pragma unroll
  for (int t = 0; t < kLaneChunks; ++t) {
    if (t < mine) {
      const long long g = kLaneChunks * lane + t;
      const int a = kSplice ? (int)applications(ch.rem, ch.sidx, ch.c.E,
                                                 g * K)
                            : 0;
      int4* r = reinterpret_cast<int4*>(rec + (ck + g) * kRecWords);
      r[0] = make_int4((int)(first[t] >> kFracBits),
                       (int)(first[t] & kFracMask), __float_as_int(v),
                       ch.rem - a);
      r[1] = make_int4(ch.sidx + a, 1 | (ch.rv << 1), ch.s0, ch.e0);
    }
  }
  if (f > 0) {
    const long long steps = (long long)f * K;
    ch.advance(__shfl_sync(kFull, end, fl < 32 ? fl : 31), v,
               T - ck * K < steps ? T - ck * K : steps);
  }
  return f;
}

// Warp 0 walks chunk ck and records it as walked.
template <bool kSplice, bool kInertia>
__device__ void walk_one(Chain<kSplice, kInertia>& ch,
                         const float* __restrict__ mod_q, long long T, int K,
                         long long ck, float* stage, const Scratch& sc,
                         int& nwalked, int lane) {
  if (lane == 0) {
    int* r = sc.rec + ck * kRecWords;
    r[0] = ch.whole;
    r[1] = ch.frac;
    r[2] = __float_as_int(ch.speed);
    r[3] = ch.rem;
    r[4] = ch.sidx;
    r[5] = 0;
    r[6] = r[7] = 0;
  }
  ++nwalked;
  const long long base = ck * K;
  const int L = T - base < K ? (int)(T - base) : K;
  __syncwarp();
  stage_copy(stage, mod_q + base, L, lane);
  walk_chunk<kSplice, kInertia, false>(ch, stage, L, lane, nullptr, nullptr,
                                       nullptr);
}

// One block walks the chunks in order (see the note at the top): warp 0
// holds the chain and decides, reading the sums' table from a window of
// kTableWindow chunks of one row in shared memory; the block's warps fill
// that window, or sum the next kGroupChunks chunks where the speed in
// force has no row in the table.
template <bool kSplice, bool kInertia>
__global__ void __launch_bounds__(kWalkWarps * 32)
    tape_walk_kernel(const float* __restrict__ mod_q, long long T, int K,
                     long long nchunks, const int* __restrict__ starts_g,
                     const int* __restrict__ ends_g,
                     const float* __restrict__ speeds_g,
                     const unsigned char* __restrict__ rev_g,
                     const int* __restrict__ bnd_g, Consts c, int R,
                     const int* __restrict__ state_in, Scratch sc,
                     int* __restrict__ state_out) {
  enum { kDone, kSum, kFill };
  extern __shared__ int smem[];
  __shared__ int4 window[kTableWindow];
  __shared__ int4 sums[kGroupChunks];
  __shared__ long long s_ck;
  __shared__ float s_v;
  __shared__ int s_mode, s_row;
  const Tables tb = load_tables(smem, starts_g, ends_g, speeds_g, rev_g,
                                bnd_g, c);
  float* stage = reinterpret_cast<float*>(smem + 4 * c.S + c.B);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Chain<kSplice, kInertia> ch;
  ch.init(tb, c, state_in[0], state_in[1], __int_as_float(state_in[2]),
          state_in[3], state_in[4]);
  long long ck = 0, p = 0;
  float v = 0.0f;
  int nwalked = 0, mode = kDone;
  // the window holds row w_row's entries of chunks [w_lo, w_hi)
  long long w_lo = 0, w_hi = 0;
  int w_row = -1;
  __syncthreads();
  for (;;) {
    if (warp == 0) {
      // decide from the window (or walk) until the block must act
      for (mode = kDone; ck < nchunks;) {
        const bool go = ch.steady_start(p, v);
        const int nvalid = nchunks - ck < kGroupChunks ? (int)(nchunks - ck)
                                                       : kGroupChunks;
        if (go) {
          if (!(ch.sec < R && __float_as_int(v) == __float_as_int(ch.target))) {
            mode = kSum;
            break;
          }
          if (!(w_row == ch.sec && ck >= w_lo && ck + nvalid <= w_hi)) {
            mode = kFill;
            break;
          }
        }
        int f = 0;
        if (go) {
          f = jump_group(ch, p, v, ck, nvalid, window + (ck - w_lo), K, T,
                         sc.rec, lane);
          ck += f;
        }
        if (f < nvalid) {
          walk_one(ch, mod_q, T, K, ck, stage, sc, nwalked, lane);
          ++ck;
        }
      }
      if (lane == 0) {
        s_mode = mode;
        s_ck = ck;
        s_v = v;
        s_row = ch.sec;
      }
    }
    __syncthreads();
    const int m = s_mode;
    const long long cg = s_ck;
    if (m == kDone) break;
    if (m == kFill) {
      const int4* row = sc.tab + (long long)s_row * nchunks + cg;
      for (int k = threadIdx.x; k < kTableWindow && cg + k < nchunks;
           k += blockDim.x)
        window[k] = row[k];
    } else {
      for (int k = warp; k < kGroupChunks && cg + k < nchunks;
           k += kWalkWarps) {
        const long long base = (cg + k) * K;
        const ChunkSum cs = chunk_sum(mod_q, base,
                                      T - base < K ? (int)(T - base) : K,
                                      s_v, lane);
        if (lane == 0)
          sums[k] = make_int4((int)cs.sum, (int)(cs.sum >> 32), cs.last,
                              cs.ok);
      }
    }
    __syncthreads();
    if (warp == 0) {
      if (mode == kFill) {
        w_row = ch.sec;
        w_lo = ck;
        w_hi = nchunks - ck < kTableWindow ? nchunks : ck + kTableWindow;
      } else {
        const int nvalid = nchunks - ck < kGroupChunks ? (int)(nchunks - ck)
                                                       : kGroupChunks;
        const int f = jump_group(ch, p, v, ck, nvalid, sums, K, T, sc.rec,
                                 lane);
        ck += f;
        if (f < nvalid) {
          walk_one(ch, mod_q, T, K, ck, stage, sc, nwalked, lane);
          ++ck;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    state_out[0] = ch.whole;
    state_out[1] = ch.frac;
    state_out[2] = __float_as_int(ch.speed);
    state_out[3] = ch.rem;
    state_out[4] = ch.sidx;
    *sc.nwalked = nwalked;
  }
}

// One block a chunk.  A jumped chunk: warp w replays the w-th of its
// kReplayWarps slices; each warp sums its slice's increments, the block
// scans the four sums, and each warp rebuilds its positions (64 a round)
// by prefix sum from the chunk's start state, its read index in the
// chunk's section, the envelope's index (sidx + j for the chunk's first
// applications), and reads, applies the gains and clips.  A walked chunk:
// warp 0 walks it again from its start state with walk_chunk, kPiece
// steps at a time, each step's read index, fraction and envelope index
// kept in shared memory, and the block reads each piece.
template <bool kSplice, bool kInertia>
__global__ void __launch_bounds__(kReplayWarps * 32)
    tape_replay_kernel(const float* __restrict__ audio,
                       const float* __restrict__ mod_q, long long T, int K,
                       const int* __restrict__ starts_g,
                       const int* __restrict__ ends_g,
                       const float* __restrict__ speeds_g,
                       const unsigned char* __restrict__ rev_g,
                       const int* __restrict__ bnd_g,
                       const float* __restrict__ env, Consts c,
                       const int* __restrict__ rec, float* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ long long part[kReplayWarps];
  const long long ck = blockIdx.x;
  const int* r = rec + ck * kRecWords;
  const int kind = r[5];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = ck * K;
  const int L = T - base < K ? (int)(T - base) : K;
  if (!(kind & 1)) {
    const Tables tb = load_tables(smem, starts_g, ends_g, speeds_g, rev_g,
                                  bnd_g, c);
    float* stage = reinterpret_cast<float*>(smem + 4 * c.S + c.B);
    int* o_idx0 = reinterpret_cast<int*>(stage + kPiece);
    float* o_fr = reinterpret_cast<float*>(o_idx0 + kPiece);
    int* o_gi = reinterpret_cast<int*>(o_fr + kPiece);
    Chain<kSplice, kInertia> ch;
    ch.init(tb, c, r[0], r[1], __int_as_float(r[2]), r[3], r[4]);
    __syncthreads();
    for (int i0 = 0; i0 < L; i0 += kPiece) {
      const int P = L - i0 < kPiece ? L - i0 : kPiece;
      if (warp == 0) {
        stage_copy(stage, mod_q + base + i0, P, lane);
        walk_chunk<kSplice, kInertia, true>(ch, stage, P, lane, o_idx0,
                                            o_fr, o_gi);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < P; j += blockDim.x)
        out[base + i0 + j] = tape_sample(audio, tb.bnd, env, c, o_idx0[j],
                                         o_fr[j], o_gi[j]);
      __syncthreads();
    }
    return;
  }
  int* bnd = smem + 4 * c.S;
  for (int k = threadIdx.x; k < c.B; k += blockDim.x) bnd[k] = bnd_g[k];
  const float v = __int_as_float(r[2]);
  const int sidx = r[4], rv = kind >> 1, s0 = r[6], e0 = r[7];
  const int a = kSplice ? (int)applications(r[3], sidx, c.E, L) : 0;
  const int span = K / kReplayWarps;
  const int j0 = warp * span;
  const int j1 = j0 + span < L ? j0 + span : L;
  long long own = 0;
  for (int j = j0 + lane; j < j1; j += 32)
    own += increment(v, __ldg(mod_q + base + j));
  own = warp_sum(own);
  if (lane == 0) part[warp] = own;
  __syncthreads();
  long long p = ((long long)r[0] << kFracBits) + r[1];
  for (int w = 0; w < warp; ++w) p += part[w];
  // two tiles of 32 steps at a time, so that each warp has two gathers
  // of the audio in flight; the next pair's mod values load meanwhile
  const float* mqs = mod_q + base;
  float m0 = j0 + lane < j1 ? __ldg(mqs + j0 + lane) : 0.0f;
  float m1 = j0 + 32 + lane < j1 ? __ldg(mqs + j0 + 32 + lane) : 0.0f;
  for (int i = j0; i < j1; i += 64) {
    const int ja = i + lane, jb = ja + 32;
    const float n0 = ja + 64 < j1 ? __ldg(mqs + ja + 64) : 0.0f;
    const float n1 = jb + 64 < j1 ? __ldg(mqs + jb + 64) : 0.0f;
    const int ia = ja < j1 ? increment(v, m0) : 0;
    const int ib = jb < j1 ? increment(v, m1) : 0;
    const long long ca = warp_scan(ia, lane);
    const long long cb = warp_scan(ib, lane);
    const long long ta = __shfl_sync(kFull, ca, 31);
    const long long pa = p + ca - ia, pb = p + ta + cb - ib;
    int xa, xb;
    float fa, fb;
    read_index(s0, e0, rv, c.n, (int)(pa >> kFracBits) - s0,
               (int)(pa & kFracMask), xa, fa);
    read_index(s0, e0, rv, c.n, (int)(pb >> kFracBits) - s0,
               (int)(pb & kFracMask), xb, fb);
    const float sa = tape_sample(audio, bnd, env, c, xa, fa,
                                 ja < a ? clampi(sidx + ja, 0, c.E - 1) : -1);
    const float sb = tape_sample(audio, bnd, env, c, xb, fb,
                                 jb < a ? clampi(sidx + jb, 0, c.E - 1) : -1);
    if (ja < j1) out[base + ja] = sa;
    if (jb < j1) out[base + jb] = sb;
    p += ta + __shfl_sync(kFull, cb, 31);
    m0 = n0;
    m1 = n1;
  }
}

template <bool kSplice, bool kInertia>
cudaError_t launch(const float* audio, const float* mod_q, long long T,
                   int K, const int* starts, const int* ends,
                   const float* speeds_q, const unsigned char* reverse,
                   const int* boundaries, const float* env, const Consts& c,
                   const int* state_in, int* scratch, float* out,
                   int* state_out, cudaStream_t s,
                   cudaEvent_t const* marks) {
  const long long nchunks = (T + K - 1) / K;
  const int R = c.S < kTableRows ? c.S : kTableRows;
  const Scratch sc = scratch_at(scratch, nchunks, R);
  const size_t tables = (size_t)(4 * c.S + c.B) * sizeof(int);
  const unsigned grid = (unsigned)((nchunks + kReplayWarps - 1) /
                                   kReplayWarps);
  if (nchunks > 0) {
    tape_sums_kernel<<<grid, kReplayWarps * 32, 0, s>>>(mod_q, T, K, nchunks,
                                                        speeds_q, R, sc);
  }
  if (marks[0]) cudaEventRecord(marks[0], s);
  const size_t walk_smem = tables + (size_t)K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tape_walk_kernel<kSplice, kInertia>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)walk_smem);
  if (err != cudaSuccess) return err;
  tape_walk_kernel<kSplice, kInertia><<<1, kWalkWarps * 32, walk_smem, s>>>(
      mod_q, T, K, nchunks, starts, ends, speeds_q, reverse, boundaries, c,
      R, state_in, sc, state_out);
  if (marks[1]) cudaEventRecord(marks[1], s);
  if ((err = cudaGetLastError()) != cudaSuccess || nchunks == 0) return err;
  const size_t replay_smem = tables + (size_t)kPiece * 4 * sizeof(float);
  err = cudaFuncSetAttribute(tape_replay_kernel<kSplice, kInertia>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)replay_smem);
  if (err != cudaSuccess) return err;
  tape_replay_kernel<kSplice, kInertia><<<(unsigned)nchunks,
                                          kReplayWarps * 32, replay_smem,
                                          s>>>(
      audio, mod_q, T, K, starts, ends, speeds_q, reverse, boundaries, env,
      c, sc.rec, out);
  return cudaGetLastError();
}

// ---- the control tables (ts_tables_launch) --------------------------------

constexpr int kTabThreads = kWalkWarps * 32;       // the walk's block
constexpr int kTabPer = kMaxChunk / kTabThreads;   // a chunk's steps a thread
constexpr int kTabHead = 16;                       // the output's header words

// The wow/flutter curve's constants (models/tape.py:wow_flutter_consts):
// the phase residues' ratios and their steps of 1 and 32 samples, the
// inverse periods, depths and start phases, the sine's coefficients.
struct ModConsts {
  unsigned wn, wm, fn, fm, ws1, fs1, ws32, fs32;
  float winv, finv, wd, fd, p0w, p0f;
  float sc[5], cc[5];
};

__device__ __forceinline__ unsigned residue(long long j, unsigned num,
                                            unsigned m) {
  return (unsigned)(((unsigned long long)j * num) % m);
}

__device__ __forceinline__ unsigned step_res(unsigned r, unsigned s,
                                             unsigned m) {
  r += s;
  return r >= m ? r - m : r;
}

// fixq.round_sig12: the significand rounded half up to 12 bits
__device__ __forceinline__ float round_sig12(float x) {
  return __int_as_float((__float_as_int(x) + 0x0800) & ~0x0FFF);
}

// sin(2 pi x), x in cycles: detmath.sin_cycles_np's f32 polynomials
__device__ __forceinline__ float sin_cycles(float x, const float* s,
                                            const float* c) {
  const float x4 = __fmul_rn(x, 4.0f);
  const float q = rintf(x4);
  const float v = __fmul_rn(__fsub_rn(x4, q), 0.25f);
  const int m = (int)((long long)q & 3);
  const float z = __fmul_rn(v, v);
  float sp = __fadd_rn(s[3], __fmul_rn(z, s[4]));
  sp = __fadd_rn(s[2], __fmul_rn(z, sp));
  sp = __fadd_rn(s[1], __fmul_rn(z, sp));
  sp = __fmul_rn(v, __fadd_rn(s[0], __fmul_rn(z, sp)));
  float cp = __fadd_rn(c[3], __fmul_rn(z, c[4]));
  cp = __fadd_rn(c[2], __fmul_rn(z, cp));
  cp = __fadd_rn(c[1], __fmul_rn(z, cp));
  cp = __fadd_rn(c[0], __fmul_rn(z, cp));
  const float r = (m & 1) ? cp : sp;
  return (m & 2) ? -r : r;
}

// the quantized speed modulation of the sample whose phase residues are
// rw and rf
__device__ __forceinline__ float mod_value(unsigned rw, unsigned rf,
                                           const ModConsts& m) {
  const float sw = round_sig12(sin_cycles(
      __fadd_rn(m.p0w, __fmul_rn((float)(int)rw, m.winv)), m.sc, m.cc));
  const float sf = round_sig12(sin_cycles(
      __fadd_rn(m.p0f, __fmul_rn((float)(int)rf, m.finv)), m.sc, m.cc));
  float mv = __fadd_rn(__fadd_rn(1.0f, __fmul_rn(m.wd, sw)),
                       __fmul_rn(m.fd, sf));
  mv = mv < 0.1f ? 0.1f : (mv > 3.0f ? 3.0f : mv);
  return quantize(mv);
}

struct TabArgs {
  ModConsts mc;
  long long T, nchunks, s_init;
  int n, S, B, R, Rt, E, K, cap, splice;
};

// the packed input's arrays: starts, ends, reverse, each section's speed
// row (int32 [S] each), the boundaries (int32 [B]), each row's speed (f32
// [R]) and its fixed-point integer (int32 [R]); the splice envelope after
// them is the render's, not the walk's
struct TabIn {
  const int* starts;
  const int* ends;
  const int* rev;
  const int* row;
  const int* bnd;
  const float* rowspd;
  const int* rowt;
};

__host__ __device__ inline TabIn tab_in(const int* in, int S, int B, int R) {
  TabIn t;
  t.starts = in;
  t.ends = in + S;
  t.rev = in + 2 * S;
  t.row = in + 3 * S;
  t.bnd = in + 4 * S;
  t.rowspd = reinterpret_cast<const float*>(in + 4 * S + B);
  t.rowt = in + 4 * S + B + R;
  return t;
}

// scratch: the records' staging (8 tables of cap), the walked chunks'
// flags (nchunks), then the sums' table (int64 [Rt][nchunks])
__host__ __device__ inline long long tab_sums_offset(long long nchunks,
                                                     int cap) {
  return (8LL * cap + nchunks + 1) / 2 * 2;
}

// One warp a chunk: its increments' sums at the first Rt rows' speeds,
// each sample's modulation computed once, in registers.
__global__ void __launch_bounds__(kReplayWarps * 32)
    tables_sums_kernel(ModConsts mc, const float* __restrict__ rowspd, int Rt,
                       long long T, int K, long long nchunks,
                       long long* __restrict__ tab) {
  const int lane = threadIdx.x & 31;
  const long long ck = (long long)blockIdx.x * kReplayWarps +
                       (threadIdx.x >> 5);
  if (ck >= nchunks) return;
  const long long base = ck * K;
  const int L = T - base < K ? (int)(T - base) : K;
  float v[kTableRows];
  long long s[kTableRows];
#pragma unroll
  for (int r = 0; r < kTableRows; ++r) {
    v[r] = r < Rt ? __ldg(rowspd + r) : 0.0f;
    s[r] = 0;
  }
  unsigned rw = residue(base + lane, mc.wn, mc.wm);
  unsigned rf = residue(base + lane, mc.fn, mc.fm);
  for (int j = lane; j < L; j += 32) {
    const float md = mod_value(rw, rf, mc);
#pragma unroll
    for (int r = 0; r < kTableRows; ++r)
      if (r < Rt) s[r] += increment(v[r], md);
    rw = step_res(rw, mc.ws32, mc.wm);
    rf = step_res(rf, mc.fs32, mc.fm);
  }
#pragma unroll
  for (int r = 0; r < kTableRows; ++r) {
    if (r < Rt) {
      const long long t = warp_sum(s[r]);
      if (lane == 0) tab[r * nchunks + ck] = t;
    }
  }
}

// The block's collectives; every thread calls each one.
struct Blk {
  long long* ll;   // [kWalkWarps]
  int* ii;         // [kWalkWarps]
  long long* e;    // [2]
  int lane, warp;

  // the inclusive scan of x over the threads in order; total: the sum
  __device__ long long scan(long long x, long long& total) const {
    const long long inc = warp_scan(x, lane);
    if (lane == 31) ll[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < kWalkWarps ? ll[lane] : 0;
      w = warp_scan(w, lane);
      if (lane < kWalkWarps) ll[lane] = w;
    }
    __syncthreads();
    const long long off = warp ? ll[warp - 1] : 0;
    total = ll[kWalkWarps - 1];
    __syncthreads();
    return off + inc;
  }

  __device__ int min_of(int x) const {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = min(x, __shfl_xor_sync(kFull, x, d));
    if (lane == 0) ii[warp] = x;
    __syncthreads();
    int r = INT_MAX;
    for (int k = 0; k < kWalkWarps; ++k) r = min(r, ii[k]);
    __syncthreads();
    return r;
  }

  // the owner's a and b to every thread
  __device__ void share(bool owner, long long& a, long long& b) const {
    if (owner) {
      e[0] = a;
      e[1] = b;
    }
    __syncthreads();
    a = e[0];
    b = e[1];
    __syncthreads();
  }
};

// The walk's searches.  E(j): the sum of a visit's increments before its
// sample j, from the visit's start; every search runs at one speed v and
// finds the first sample k whose inclusive prefix E(k + 1) reaches a
// target.  Increments are >= 0, so the prefix is monotone and a chunk's
// sum says whether the crossing lies in it.
struct TabWalk {
  TabArgs a;
  TabIn in;
  const long long* tab;
  int* flags;
  Blk blk;

  // the sum of chunk c's increments at v by one thread (v has no row in
  // the sums' table)
  __device__ long long chunk_sum(long long c, float v) const {
    const long long base = c * a.K;
    const int L = a.T - base < a.K ? (int)(a.T - base) : a.K;
    unsigned rw = residue(base, a.mc.wn, a.mc.wm);
    unsigned rf = residue(base, a.mc.fn, a.mc.fm);
    long long s = 0;
    for (int j = 0; j < L; ++j) {
      s += increment(v, mod_value(rw, rf, a.mc));
      rw = step_res(rw, a.mc.ws1, a.mc.wm);
      rf = step_res(rf, a.mc.fs1, a.mc.fm);
    }
    return s;
  }

  // Samples [p, p + m) of one chunk, E = E(p): the first k whose E(k + 1)
  // reaches target, with Ek = E(k) and Ek1 = E(k + 1), or false with E
  // advanced to E(p + m).  The chunk is marked walked.
  __device__ bool exact(long long p, int m, long long& E, long long target,
                        float v, long long& k, long long& Ek,
                        long long& Ek1) const {
    const int per = (m + kTabThreads - 1) / kTabThreads;
    const int t0 = (int)threadIdx.x * per;
    int inc[kTabPer];
    long long own = 0;
    unsigned rw = residue(p + t0, a.mc.wn, a.mc.wm);
    unsigned rf = residue(p + t0, a.mc.fn, a.mc.fm);
#pragma unroll
    for (int u = 0; u < kTabPer; ++u) {
      inc[u] = 0;
      if (u < per && t0 + u < m) {
        inc[u] = increment(v, mod_value(rw, rf, a.mc));
        own += inc[u];
        rw = step_res(rw, a.mc.ws1, a.mc.wm);
        rf = step_res(rf, a.mc.fs1, a.mc.fm);
      }
    }
    if (threadIdx.x == 0) flags[p / a.K] = 1;
    long long total;
    long long run = E + blk.scan(own, total) - own;
    int cand = INT_MAX;
    long long ek = 0, ek1 = 0;
#pragma unroll
    for (int u = 0; u < kTabPer; ++u) {
      if (u < per && t0 + u < m && cand == INT_MAX) {
        if (run + inc[u] >= target) {
          cand = t0 + u;
          ek = run;
          ek1 = run + inc[u];
        }
        run += inc[u];
      }
    }
    const int f = blk.min_of(cand);
    if (f == INT_MAX) {
      E += total;
      return false;
    }
    blk.share(cand == f, ek, ek1);
    k = p + f;
    Ek = ek;
    Ek1 = ek1;
    return true;
  }

  // The first chunk of [c, chi) whose sum brings E to target (chi: none),
  // E advanced to its start: kTabThreads chunks a round, their sums from
  // the table's row, else summed here.
  __device__ long long jump(long long c, long long chi, long long& E,
                            long long target, int row, float v) const {
    for (long long g = c; g < chi; g += kTabThreads) {
      const long long ck = g + threadIdx.x;
      long long s = 0;
      if (ck < chi)
        s = row < a.Rt ? __ldg(tab + (long long)row * a.nchunks + ck)
                       : chunk_sum(ck, v);
      long long total;
      const long long incl = blk.scan(s, total);
      const int f = blk.min_of(ck < chi && E + incl >= target
                                   ? (int)threadIdx.x
                                   : INT_MAX);
      if (f != INT_MAX) {
        long long es = E + incl - s, unused = 0;
        blk.share((int)threadIdx.x == f, es, unused);
        E = es;
        return g + f;
      }
      E += total;
    }
    return chi;
  }

  // The first sample k in [p, kend) whose E(k + 1) reaches target, from
  // E = E(p), with Ek = E(k) and Ek1 = E(k + 1); kend (Ek = Ek1 =
  // E(kend)) if none.  Whole chunks are jumped by their sums; the samples
  // of a partial chunk and of the chunk that holds the crossing are
  // walked.
  __device__ long long seek(long long p, long long E, long long target,
                            long long kend, int row, float v, long long& Ek,
                            long long& Ek1) const {
    bool jumps = true;
    while (p < kend) {
      if (jumps && p % a.K == 0) {
        const long long c = p / a.K;
        const long long chi = kend >= a.T ? a.nchunks : kend / a.K;
        if (chi > c) {
          const long long c2 = jump(c, chi, E, target, row, v);
          if (c2 == chi) {
            p = chi * a.K < a.T ? chi * a.K : a.T;
            continue;
          }
          p = c2 * a.K;
          jumps = false;
        }
      }
      long long end = (p / a.K + 1) * a.K;
      end = end < a.T ? end : a.T;
      end = end < kend ? end : kend;
      long long k;
      if (exact(p, (int)(end - p), E, target, v, k, Ek, Ek1)) return k;
      p = end;
      jumps = true;
    }
    Ek = Ek1 = E;
    return kend;
  }

  // The C++ walk's exact rule in boundary b's window: from sample jj0
  // (E0 = E(jj0)) while jj < jend and E(jj) < hi, a sample whose read
  // index is b triggers the splice unless an envelope still runs
  // (jj < last_end).  kTabThreads samples a round; the hits in order.
  __device__ void window(long long jj0, long long E0, long long jend,
                         long long hi, long long b, long long w, long long f,
                         long long s0, long long e0, int rv, float v,
                         int* trig, unsigned* hits, int& nt,
                         long long& last_end, bool& overflow) const {
    while (jj0 < jend) {
      const long long jj = jj0 + threadIdx.x;
      const bool valid = jj < jend;
      int inc = 0;
      if (valid) {
        inc = increment(v, mod_value(residue(jj, a.mc.wn, a.mc.wm),
                                     residue(jj, a.mc.fn, a.mc.fm), a.mc));
        flags[jj / a.K] = 1;
      }
      long long total;
      const long long excl = E0 + blk.scan(inc, total) - inc;
      const bool inside = valid && excl < hi;
      const long long fv = f + excl;
      const long long carry = fv >> kFracBits;
      const long long lw = w + carry - s0;
      const long long fj = fv - (carry << kFracBits);
      long long idx0;
      if (rv) {
        const long long x = e0 - 1 - lw;
        idx0 = fj > 0 ? (x == 0 ? 0 : x - 1) : x;
      } else {
        idx0 = s0 + lw;
      }
      idx0 = idx0 < 0 ? 0 : (idx0 > a.n - 1 ? a.n - 1 : idx0);
      const unsigned h = __ballot_sync(kFull, inside && idx0 == b);
      if (blk.lane == 0) hits[blk.warp] = h;
      const bool all_in = __syncthreads_and(inside);
      for (int q = 0; q < kWalkWarps; ++q) {
        for (unsigned mk = hits[q]; mk; mk &= mk - 1) {
          const long long t = jj0 + 32 * q + (__ffs(mk) - 1);
          if (t >= last_end) {
            if (nt < a.cap) {
              if (threadIdx.x == 0) trig[nt] = (int)t;
            } else {
              overflow = true;
            }
            ++nt;
            last_end = t + a.E;
          }
        }
      }
      __syncthreads();
      if (!all_in) return;
      jj0 += kTabThreads;
      E0 += total;
    }
  }
};

// One block walks the visits in order, every thread holding the same
// state (thread 0 writes the records): a visit's section and its crossing
// (seek to the section's end), then, with the splice on, each boundary
// the visit can reach in time order (reversed sections in decreasing b),
// its window found by seek and applied by window(); the records capped at
// cap and counted past it, then packed after the header.
__global__ void __launch_bounds__(kTabThreads)
    tables_walk_kernel(TabArgs a, const int* __restrict__ in_g,
                       const long long* __restrict__ tab,
                       int* __restrict__ scratch, int* __restrict__ out) {
  __shared__ long long sh_ll[kWalkWarps];
  __shared__ int sh_ii[kWalkWarps];
  __shared__ long long sh_e[2];
  __shared__ unsigned sh_hits[kWalkWarps];
  const TabIn in = tab_in(in_g, a.S, a.B, a.R);
  const int cap = a.cap;
  int* stage = scratch;
  int* flags = scratch + 8LL * cap;
  for (long long c = threadIdx.x; c < a.nchunks; c += kTabThreads)
    flags[c] = 0;
  __syncthreads();
  const TabWalk wk{a, in, tab, flags,
                   Blk{sh_ll, sh_ii, sh_e, (int)(threadIdx.x & 31),
                       (int)(threadIdx.x >> 5)}};
  const bool lead = threadIdx.x == 0;
  long long i = 0, w = 0, f = 0, s_int = a.s_init, last_end = -1;
  int nv = 0, nr = 0, nt = 0, last_s0 = 0;
  bool overflow = false;
  while (i < a.T) {
    w = ((w % a.n) + a.n) % a.n;
    int lo = 0, hi = a.S;
    while (lo < hi) {             // upper bound of w in the starts
      const int mid = (lo + hi) >> 1;
      if (__ldg(in.starts + mid) <= w) lo = mid + 1; else hi = mid;
    }
    const int sec = clampi(lo - 1, 0, a.S - 1);
    const long long s0 = __ldg(in.starts + sec);
    long long e0 = __ldg(in.ends + sec);
    if (e0 <= s0) e0 = s0 + 1;
    const int row = __ldg(in.row + sec);
    const float v = __ldg(in.rowspd + row);
    const int t_int = __ldg(in.rowt + row);
    if (nv < cap) {
      if (lead) {
        stage[nv] = (int)i;
        stage[cap + nv] = (int)w;
        stage[2 * cap + nv] = (int)f;
        stage[3 * cap + nv] = sec;
      }
    } else {
      overflow = true;
    }
    ++nv;
    // one constant run a visit, merged where it continues the last
    if (!(nr > 0 && nr <= cap && last_s0 == t_int)) {
      if (nr < cap) {
        if (lead) {
          stage[4 * cap + nr] = (int)i;
          stage[5 * cap + nr] = t_int;
          stage[6 * cap + nr] = 0;
        }
        last_s0 = t_int;
      } else {
        overflow = true;
      }
      ++nr;
    }
    long long Ek, Ek1;
    const long long k = wk.seek(i, 0, (e0 - w) * kPosOne - f, a.T, row, v,
                                Ek, Ek1);
    const long long jend = k < a.T ? k + 1 : a.T;
    const long long total = k < a.T ? Ek1 : Ek;
    if (a.splice) {
      int b0 = 0, b1 = 0;         // lower bounds of s0 and e0
      for (int x = a.B; x > 0;) {
        const int h = x >> 1;
        if (__ldg(in.bnd + b0 + h) < s0) { b0 += h + 1; x -= h + 1; }
        else x = h;
      }
      for (int x = a.B; x > 0;) {
        const int h = x >> 1;
        if (__ldg(in.bnd + b1 + h) < e0) { b1 += h + 1; x -= h + 1; }
        else x = h;
      }
      const int rv = __ldg(in.rev + sec);
      long long ck = i, cE = 0;   // the windows' search resumes here
      for (int st = 0; st < b1 - b0; ++st) {
        const long long b = __ldg(in.bnd + (rv ? b1 - 1 - st : b0 + st));
        long long Wlo, Wn;        // the whole positions where idx0 can be b
        if (rv) {
          Wlo = s0 + (e0 - 2 - b);
          Wn = 2;
          if (Wlo < w) {
            Wn -= w - Wlo;
            Wlo = w;
          }
          if (Wn <= 0) continue;
        } else {
          if (b < w) continue;
          Wlo = b;
          Wn = 1;
        }
        long long lo_e = (Wlo - w) * kPosOne - f;
        const long long hi_e = lo_e + Wn * kPosOne;
        if (lo_e < 0) lo_e = 0;
        long long ja = i, Eja = 0;
        if (lo_e > 0) {
          long long yk, yk1;
          const long long y = wk.seek(ck, cE, lo_e, jend - 1, row, v, yk,
                                      yk1);
          ck = y;
          cE = yk;
          ja = y < jend - 1 ? y + 1 : jend;
          Eja = yk1;
        }
        wk.window(ja, Eja, jend, hi_e, b, w, f, s0, e0, rv, v, stage + 7 * cap,
                  sh_hits, nt, last_end, overflow);
      }
    }
    const long long fv = f + total;
    const long long carry = fv >> kFracBits;
    w += carry;
    f = fv - (carry << kFracBits);
    s_int = t_int;
    i = jend;
  }
  __syncthreads();
  long long mine = 0, walked;
  for (long long c = threadIdx.x; c < a.nchunks; c += kTabThreads)
    mine += flags[c];
  wk.blk.scan(mine, walked);
  if (lead) {
    out[0] = nv;
    out[1] = nr;
    out[2] = nt;
    out[3] = overflow;
    long long* h = reinterpret_cast<long long*>(out + 4);
    h[0] = w;
    h[1] = f;
    h[2] = s_int;
    h[3] = last_end > a.T ? last_end - a.T : 0;
    h[4] = last_end > a.T ? a.E - (last_end - a.T) : 0;
    out[14] = (int)walked;
    out[15] = (int)(a.nchunks - walked);
  }
  const int cv = min(nv, cap), cr = min(nr, cap), ct = min(nt, cap);
  int* o = out + kTabHead;
  for (int x = threadIdx.x; x < cv; x += kTabThreads)
    for (int q = 0; q < 4; ++q) o[q * cv + x] = stage[q * cap + x];
  o += 4 * cv;
  for (int x = threadIdx.x; x < cr; x += kTabThreads)
    for (int q = 0; q < 3; ++q) o[q * cr + x] = stage[(4 + q) * cap + x];
  o += 3 * cr;
  for (int x = threadIdx.x; x < ct; x += kTabThreads) o[x] = stage[7 * cap + x];
}

}  // namespace

// The int32 words of scratch ts_launch needs for T steps, S sections and
// chunks of K: the chunks' records first (kRecWords each), then the walked
// chunks' count and the sums' table.
extern "C" long long ts_scratch_words(long long T, int S, int K) {
  const long long nchunks = K > 0 ? (T + K - 1) / K : 0;
  const int R = S < kTableRows ? S : kTableRows;
  return table_offset(nchunks) + 4LL * R * nchunks;
}

// The scan engine on `stream`: out f32[T] and the final state from
// state_in (5 int32: whole, frac, speed's f32 bits, rem, sidx) into
// state_out (5 int32), in chunks of K steps, through `scratch`
// (ts_scratch_words int32).  audio f32[n], mod_q f32[T], starts/ends
// i32[S], speeds_q f32[S], reverse u8[S], boundaries i32[B] and env f32[E]
// are device pointers; inv_smooth is the f32 1 / max(1, smooth_len).
// mark_sums, mark_walk: CUDA events (or null) recorded on the stream after
// the sums and after the walk, to time the passes.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for n < 1, S < 1, negative sizes, tables past
// kMaxTableWords or a K that is no power of two in [kMinChunk, kMaxChunk].
extern "C" int ts_launch(const float* audio, int n, const float* mod_q,
                         long long T, const int* starts, const int* ends,
                         const float* speeds_q, const unsigned char* reverse,
                         int S, const int* boundaries, int B,
                         const float* env, int E, int anticlick_on,
                         int smooth_len, float strength, float inv_smooth,
                         int splice_on, int inertia_on, float alpha_q,
                         const int* state_in, int K, int* scratch,
                         float* out, int* state_out, void* stream,
                         void* mark_sums, void* mark_walk) {
  if (n < 1 || S < 1 || B < 0 || E < 0 || T < 0 ||
      4LL * S + B > kMaxTableWords || K < kMinChunk || K > kMaxChunk ||
      (K & (K - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Consts c{n, S, B, E, anticlick_on != 0, smooth_len,
           splice_on != 0 && B > 0, inertia_on != 0, strength, inv_smooth,
           alpha_q};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaEvent_t marks[2] = {(cudaEvent_t)mark_sums,
                                (cudaEvent_t)mark_walk};
  cudaError_t err;
  if (c.splice)
    err = c.inertia ? launch<true, true>(audio, mod_q, T, K, starts, ends,
                                         speeds_q, reverse, boundaries, env,
                                         c, state_in, scratch, out,
                                         state_out, s, marks)
                    : launch<true, false>(audio, mod_q, T, K, starts, ends,
                                          speeds_q, reverse, boundaries, env,
                                          c, state_in, scratch, out,
                                          state_out, s, marks);
  else
    err = c.inertia ? launch<false, true>(audio, mod_q, T, K, starts, ends,
                                          speeds_q, reverse, boundaries, env,
                                          c, state_in, scratch, out,
                                          state_out, s, marks)
                    : launch<false, false>(audio, mod_q, T, K, starts, ends,
                                           speeds_q, reverse, boundaries,
                                           env, c, state_in, scratch, out,
                                           state_out, s, marks);
  return (int)err;
}

// The int32 words of scratch ts_tables_launch needs for T samples, R
// distinct speeds, chunks of K and `cap` records a table.
extern "C" long long ts_tables_scratch_words(long long T, int R, int K,
                                             int cap) {
  const long long nchunks = K > 0 ? (T + K - 1) / K : 0;
  const int Rt = R < kTableRows ? R : kTableRows;
  return tab_sums_offset(nchunks, cap) + 2LL * Rt * nchunks;
}

// The tape's control tables of a T-sample render of an n-sample tape from
// position 0 with the speed held in each visit (inertia off), on
// `stream`, the decisions of native/ast_runtime.cpp's ast_tape_tables.
// `in`: the packed input (device, int32 words: starts, ends, reverse,
// row of each of the S sections, the B boundaries, the R rows' f32 speeds
// and fixed-point integers); E: the splice envelope's length; s_init: the
// initial speed's fixed-point integer; mod_ints (wn, wm, fn, fm), mod_flts
// (winv, finv, wd, fd, p0w, p0f) and coeffs (detmath's 5 sine then 5
// cosine coefficients) are host arrays.  out (kTabHead + 8 cap int32):
// the visit, run and trigger counts, whether one passed cap, the final
// whole, frac, speed integer, splice rem and index (int64 each from word
// 4), the walked and jumped chunks, then the records packed, each table
// capped at cap: visit start, whole, frac, section; run start, speed,
// slope; triggers.  scratch: ts_tables_scratch_words int32.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for n < 1,
// S < 1, R < 1, T past 2^31, cap < 1, a period of 0 or a K that is no
// power of two in [kMinChunk, kMaxChunk].
extern "C" int ts_tables_launch(const int* in, int S, int B, int R,
                                long long T, int n, int E, int splice_on,
                                long long s_init, const unsigned* mod_ints,
                                const float* mod_flts, const float* coeffs,
                                int K, int cap, int* scratch, int* out,
                                void* stream) {
  if (n < 1 || S < 1 || B < 0 || R < 1 || R > S || E < 0 || T < 0 ||
      T >= (1LL << 31) || cap < 1 || mod_ints[1] == 0 || mod_ints[3] == 0 ||
      K < kMinChunk || K > kMaxChunk || (K & (K - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  ModConsts mc;
  mc.wn = mod_ints[0];
  mc.wm = mod_ints[1];
  mc.fn = mod_ints[2];
  mc.fm = mod_ints[3];
  mc.ws1 = mc.wn % mc.wm;
  mc.fs1 = mc.fn % mc.fm;
  mc.ws32 = (unsigned)((32ULL * mc.wn) % mc.wm);
  mc.fs32 = (unsigned)((32ULL * mc.fn) % mc.fm);
  mc.winv = mod_flts[0];
  mc.finv = mod_flts[1];
  mc.wd = mod_flts[2];
  mc.fd = mod_flts[3];
  mc.p0w = mod_flts[4];
  mc.p0f = mod_flts[5];
  for (int k = 0; k < 5; ++k) {
    mc.sc[k] = coeffs[k];
    mc.cc[k] = coeffs[5 + k];
  }
  const long long nchunks = (T + K - 1) / K;
  const int Rt = R < kTableRows ? R : kTableRows;
  TabArgs a{mc, T, nchunks, s_init, n, S, B, R, Rt, E, K, cap,
            splice_on != 0 && B > 0};
  long long* tab = reinterpret_cast<long long*>(
      scratch + tab_sums_offset(nchunks, cap));
  cudaStream_t s = (cudaStream_t)stream;
  if (nchunks > 0) {
    const unsigned grid = (unsigned)((nchunks + kReplayWarps - 1) /
                                     kReplayWarps);
    tables_sums_kernel<<<grid, kReplayWarps * 32, 0, s>>>(
        mc, tab_in(in, S, B, R).rowspd, Rt, T, K, nchunks, tab);
  }
  tables_walk_kernel<<<1, kTabThreads, 0, s>>>(a, in, tab, scratch, out);
  return (int)cudaGetLastError();
}

extern "C" const char* ts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
