"""The chunked algorithm of ``kernels/tape_scan.cu``, held bit for bit on
the CPU.

``ChunkedScan`` is a pure-Python model of the kernel's walk and replay:
the chain with its section and boundary caches (``Chain.step`` is the
kernel's ``step()``), the walk in decisions on up to 128 chunks of K
steps (four a lane of the kernel's warp; a chunk is jumped when its first
step is the common one at a steady speed, every increment lies in [0,
INC_MAX] and its first and last read positions are both common; the
splice envelope then advances in closed form), the walked chunks in runs
of 32 steps and rounds of up to 32 (the first step that is not the
common one runs ``step()``), and the replay: jumped chunks by prefix sums
from their start state, walked chunks walked again from theirs.
Integers are Python ints; each f32 operation is one NumPy f32 operation,
rounded once, in the kernel's order.

Each case is held bit-equal to ``varispeed.tape_scan_render_plain`` (the
samples and the five state words: whole, frac, the speed's bits, rem,
sidx) at chunk lengths 1, 3, 32, 1 024 and one longer than the render:
section crossings on a chunk's first and last step, the wrap, a boundary
hit on a chunk's first step, a splice envelope across three chunks, a
carried envelope that stops on its index with rem left, a carried state
past 2n with frac 2**22 - 1, inertia before and after its
freeze (frozen off its target), speed 0, T of 0, 1, K - 1 and K + 1, a
reversed read in (-1, 0), and a negative ``speeds_q``, which must take
the walked path.  Imports no jax: ``tests/test_torch_kernels.py`` holds
the kernel's chunk records to this model on the card.
"""
import functools

import numpy as np
import pytest
import torch

from audio_suite_torch.models import tape
from audio_suite_torch.ops import varispeed

torch.set_num_threads(1)

FRAC_BITS = 22
POS_ONE = 1 << FRAC_BITS
FRAC_MASK = POS_ONE - 1
INC_MAX = 2 ** 31 - 1 - FRAC_MASK   # no int32 overflow in frac + inc
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
F32 = np.float32
ONE_F, INV_F = F32(POS_ONE), F32(1.0 / POS_ONE)
GROUP = 32                           # runs a test; steps a run and a round
LANE_CHUNKS = 4                      # chunks a lane in a walk decision


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


def _inc(speed, mq) -> int:
    """rint(speed * mq * 2**22), half to even, as __float2int_rn."""
    return int(np.rint(F32(F32(speed) * F32(mq)) * ONE_F))


def _quantize(x):
    return F32(F32(np.rint(F32(x) * ONE_F)) * INV_F)


def _applications(rem, sidx, E, steps) -> int:
    return max(0, min(rem, E - sidx, steps))


def _read_index(s0, e0, rv, n, local, frac):
    a = e0 - 1 - local
    idx_r, num_r = (a - 1, POS_ONE - frac) if frac > 0 else (a, 0)
    if a == 0 and frac > 0:               # read position in (-1, 0)
        idx_r, num_r = 0, -frac
    idx0 = idx_r if rv else s0 + local
    fr = F32(F32(num_r if rv else frac) * INV_F)
    return min(max(idx0, 0), n - 1), fr


class Chain:
    """The kernel's Chain: the carried state and its caches."""

    def __init__(self, tabs, state):
        (self.starts, self.ends, self.speeds, self.rev, self.bnd, self.n,
         self.E, self.splice, self.inertia, self.alpha) = tabs
        self.whole, self.frac, self.speed, self.rem, self.sidx = state
        self.speed = F32(self.speed)
        self.lo, self.hi = 1, 0              # empty caches
        self.blo = self.bhi = 0
        self.sec = self.s0 = self.e0 = self.len = self.rv = 0
        self.target = F32(0.0)

    def state(self):
        return (self.whole, self.frac, self.speed, self.rem, self.sidx)

    def find_section(self, w):
        cnt, self.lo, self.hi = 0, INT_MIN, INT_MAX
        for s in self.starts:
            if w >= s:
                cnt += 1
                self.lo = max(self.lo, s)
            else:
                self.hi = min(self.hi, s)
        self.sec = min(max(cnt - 1, 0), len(self.starts) - 1)
        self.s0 = self.starts[self.sec]
        e = self.ends[self.sec]
        self.e0 = self.s0 + 1 if e <= self.s0 else e
        self.len = self.e0 - self.s0
        self.rv = self.rev[self.sec]
        self.target = self.speeds[self.sec]

    def find_boundary(self, idx0):
        hit, self.blo, self.bhi = False, INT_MIN, INT_MAX
        for b in self.bnd:
            if b == idx0:
                hit = True
            elif b < idx0:
                self.blo = max(self.blo, b)
            else:
                self.bhi = min(self.bhi, b)
        if hit:
            self.blo = self.bhi = idx0
        return hit

    def next_speed(self, s):
        if not self.inertia:
            return self.target
        return F32(F32(s) + _quantize(F32(F32(self.target - F32(s))
                                          * self.alpha)))

    def common_at(self, p):
        """(common, idx0, fr) of the position p = w * 2**22 + frac."""
        w = p >> FRAC_BITS
        inside = 0 <= w < self.n and self.lo <= w < self.hi
        x = (w if inside else self.s0) - self.s0
        idx0, fr = _read_index(self.s0, self.e0, self.rv, self.n, x,
                               p & FRAC_MASK)
        ok = inside and 0 <= x < self.len and (
            not self.splice or self.blo < idx0 < self.bhi)
        return ok, idx0, fr

    def start(self):
        if not 0 <= self.whole < self.n:
            self.whole %= self.n
        p = (self.whole << FRAC_BITS) + self.frac
        return 0 <= self.frac < POS_ONE and self.common_at(p)[0], p

    def steady_start(self):
        go, p = self.start()
        if not go:
            return False, p, None
        v = self.speed if self.inertia else self.target
        return (not self.inertia or _bits(self.next_speed(v)) == _bits(v),
                p, v)

    def advance(self, pf, v, steps):
        if self.splice:
            a = _applications(self.rem, self.sidx, self.E, steps)
            self.rem, self.sidx = self.rem - a, self.sidx + a
        self.whole, self.frac, self.speed = pf >> FRAC_BITS, pf & FRAC_MASK, v

    def step(self, mq):
        """The kernel's step(): (idx0, fr, gi) and the state advanced."""
        n = self.n
        w = self.whole - n if self.whole >= n else self.whole
        x = w - self.s0
        idx0, fr = _read_index(self.s0, self.e0, self.rv, n, x, self.frac)
        hit = False
        if (0 <= self.whole < 2 * n and self.lo <= w < self.hi
                and 0 <= x < self.len
                and (not self.splice or self.blo < idx0 < self.bhi)):
            self.whole = w
        else:
            w = self.whole % n
            if not self.lo <= w < self.hi:
                self.find_section(w)
            self.whole = w
            x = w - self.s0
            idx0, fr = _read_index(self.s0, self.e0, self.rv, n,
                                   x % self.len, self.frac)
            hit = self.splice and not self.blo < idx0 < self.bhi \
                and self.find_boundary(idx0)
        gi = -1
        if self.splice:
            if hit and self.rem <= 0:
                self.rem, self.sidx = self.E, 0
            if self.rem > 0 and self.sidx < self.E:
                gi = min(max(self.sidx, 0), self.E - 1)
                self.rem, self.sidx = self.rem - 1, self.sidx + 1
        self.speed = self.next_speed(self.speed)
        f = self.frac + _inc(self.speed, mq)
        carry = f >> FRAC_BITS
        self.whole, self.frac = self.whole + carry, f - (carry << FRAC_BITS)
        return idx0, fr, gi


def _run_sums(incs):
    """A run's (sum, last increment, every increment in [0, INC_MAX])."""
    return (sum(incs), incs[-1], all(0 <= x <= INC_MAX for x in incs))


def _jumpable(ch, p, runs):
    """How many of ``runs`` (their _run_sums, in order) jump from p: each
    run's first and last read positions common and its flag set."""
    f = 0
    for s, last, ok in runs:
        if not (ok and ch.common_at(p)[0] and ch.common_at(p + s - last)[0]):
            break
        p += s
        f += 1
    return f, p


def walk_chunk(ch, mq, emit=None):
    """The kernel's walk_chunk over the mod values ``mq`` of one chunk;
    with ``emit`` (three lists), each step's idx0, fr and gi."""
    L, i = len(mq), 0
    while i < L:
        go, p, v = ch.steady_start()
        if go:
            runs = [_run_sums([_inc(v, m) for m in mq[r:r + GROUP]])
                    for r in range(i, min(L, i + GROUP * GROUP), GROUP)]
            f, pf = _jumpable(ch, p, runs[:GROUP])
            if f:
                steps = min(L - i, GROUP * f)
                if emit is not None:
                    a = _applications(ch.rem, ch.sidx, ch.E, steps) \
                        if ch.splice else 0
                    q = p
                    for j in range(steps):
                        _, idx0, fr = ch.common_at(q)
                        emit[0].append(idx0)
                        emit[1].append(fr)
                        emit[2].append(min(max(ch.sidx + j, 0), ch.E - 1)
                                       if j < a else -1)
                        q += _inc(v, mq[i + j])
                ch.advance(pf, v, steps)
                i += steps
                continue
        m = min(GROUP, L - i)
        go, p = ch.start()
        f, out = 0, []
        if go:
            v = ch.speed if ch.inertia else ch.target
            vs = [v] * m
            if ch.inertia and _bits(ch.next_speed(v)) != _bits(v):
                for k in range(m):
                    v = ch.next_speed(v)
                    vs[k] = v
            a_sidx, q = ch.sidx, p
            for j in range(m):
                inc = _inc(vs[j], mq[i + j])
                ok, idx0, fr = ch.common_at(q)
                if not (inc <= INC_MAX and ok):
                    break
                out.append((idx0, fr))
                q += inc
                f += 1
            if f:
                a = _applications(ch.rem, ch.sidx, ch.E, f) \
                    if ch.splice else 0
                out = [(idx0, fr, min(max(a_sidx + j, 0), ch.E - 1)
                        if j < a else -1) for j, (idx0, fr) in enumerate(out)]
                ch.advance(q, vs[f - 1], f)
        if f < m:
            out.append(ch.step(mq[i + f]))
        if emit is not None:
            for idx0, fr, gi in out:
                emit[0].append(idx0)
                emit[1].append(fr)
                emit[2].append(gi)
        i += len(out)


class ChunkedScan:
    """The walk (decisions on GROUP * LANE_CHUNKS chunks of K steps) and
    the replay."""

    def __init__(self, ins, consts, K, state=None):
        audio, mod_q, starts, ends, speeds_q, reverse, bnd, env = ins
        self.n, self.E = int(audio.shape[0]), int(env.shape[0])
        bnd = [int(b) for b in bnd.tolist()]
        self.tabs = ([int(s) for s in starts.tolist()],
                     [int(e) for e in ends.tolist()],
                     [F32(s) for s in speeds_q.cpu().numpy()],
                     [bool(r) for r in reverse.tolist()], bnd, self.n,
                     self.E, bool(consts.splice_on and bnd),
                     bool(consts.inertia_on), F32(consts.alpha_q))
        self.mq = [F32(m) for m in mod_q.cpu().numpy()]
        self.K = K
        if state is None:
            state = (0, 0, F32(consts.initial_speed_q), 0, 0)
        self.state = state

    def walk(self):
        """Each chunk's record: ("jumped", (p, v, rem, sidx, rv, s0, e0))
        or ("walked", the chain's state); and the final state."""
        ch = Chain(self.tabs, self.state)
        T, K = len(self.mq), self.K
        nch = -(-T // K)
        recs, ck = [], 0
        while ck < nch:
            go, p, v = ch.steady_start()
            f = 0
            nvalid = min(GROUP * LANE_CHUNKS, nch - ck)
            if go:
                runs = [_run_sums([_inc(v, m) for m in
                                   self.mq[c * K:min(T, c * K + K)]])
                        for c in range(ck, ck + nvalid)]
                f, pf = _jumpable(ch, p, runs)
                for k in range(f):
                    a = _applications(ch.rem, ch.sidx, ch.E, k * K) \
                        if ch.splice else 0
                    recs.append(("jumped", (p, v, ch.rem - a, ch.sidx + a,
                                            ch.rv, ch.s0, ch.e0)))
                    p += runs[k][0]
                if f:
                    ch.advance(pf, v, min(f * K, T - ck * K))
                    ck += f
            if f < nvalid:
                recs.append(("walked", ch.state()))
                walk_chunk(ch, self.mq[ck * K:min(T, ck * K + K)])
                ck += 1
        return recs, ch.state()

    def replay(self, recs):
        """Each step's idx0, fr and gi from the chunks' records."""
        T, K, n, E = len(self.mq), self.K, self.n, self.E
        emit = ([], [], [])
        for ck, (kind, rec) in enumerate(recs):
            mq = self.mq[ck * K:min(T, ck * K + K)]
            if kind == "walked":
                walk_chunk(Chain(self.tabs, rec), mq, emit)
                continue
            p, v, rem, sidx, rv, s0, e0 = rec
            a = _applications(rem, sidx, E, len(mq)) if self.tabs[7] else 0
            for j, m in enumerate(mq):
                idx0, fr = _read_index(s0, e0, rv, n,
                                       (p >> FRAC_BITS) - s0, p & FRAC_MASK)
                emit[0].append(idx0)
                emit[1].append(fr)
                emit[2].append(min(max(sidx + j, 0), E - 1) if j < a else -1)
                p += _inc(v, m)
        return emit


def render_chunked(ins, consts, K, state=None):
    """(out f32 [T], the five state words, the chunk records) of the
    model: the walk, the replay, then the plain version's read, gains
    and clip on each step's idx0, fr and gi."""
    model = ChunkedScan(ins, consts, K, state)
    recs, fin = model.walk()
    idx0, fr, gi = model.replay(recs)
    audio, bnd, env = ins[0], ins[6], ins[7]
    idx0_t = torch.tensor(idx0, dtype=torch.int32)
    s = varispeed.lerp_read_plain(audio, idx0_t,
                                  torch.tensor(fr, dtype=torch.float32))
    dip = varispeed._anticlick_gain(consts, [int(b) for b in bnd.tolist()],
                                    idx0_t)
    if dip is not None:
        s = torch.where(dip[0], s * dip[1], s)
    gi_t = torch.tensor(gi, dtype=torch.int64)
    if env.shape[0] > 0:
        s = torch.where(gi_t >= 0, s * env[gi_t.clamp_min(0)], s)
    s = torch.clamp(s, -1.0, 1.0)
    whole, frac, speed, rem, sidx = fin
    return s, (whole, frac, _bits(speed), rem, sidx), recs


def record_words(recs) -> np.ndarray:
    """The model's chunk records in the kernel's layout (int32 [chunks,
    8]): whole, frac, the speed's bits, rem, sidx, kind (bit 0 jumped, bit
    1 reversed), s0, e0 (0, 0 for a walked chunk)."""
    rows = []
    for kind, rec in recs:
        if kind == "jumped":
            p, v, rem, sidx, rv, s0, e0 = rec
            rows.append((p >> FRAC_BITS, p & FRAC_MASK, _bits(v), rem, sidx,
                         1 | (int(rv) << 1), s0, e0))
        else:
            whole, frac, speed, rem, sidx = rec
            rows.append((whole, frac, _bits(speed), rem, sidx, 0, 0, 0))
    return np.asarray(rows, np.int64).reshape(-1, 8).astype(np.int32)


def _words(st) -> tuple:
    return (int(st.whole), int(st.frac), _bits(st.speed.numpy()),
            int(st.splice_rem), int(st.splice_idx))


def scan_state(words):
    """A TapeState (CPU tensors) of five host words."""
    whole, frac, speed, rem, sidx = words
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    return varispeed.TapeState(i32(whole), i32(frac),
                               torch.tensor(speed, dtype=torch.float32),
                               i32(rem), i32(sidx))


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _consts(splice=True, anticlick=True, inertia=False, alpha=0.0,
            speed0=1.0, smooth=40):
    return varispeed.TapeConsts(
        anticlick_on=anticlick, smooth_len=smooth,
        anticlick_strength=float(F32(0.55)), splice_on=splice,
        inertia_on=inertia, alpha_q=float(F32(alpha)),
        initial_speed_q=float(F32(speed0)))


def _audio(n, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return torch.tensor(0.6 * np.sin(2 * np.pi * t / 37.0)
                        + 0.2 * rng.standard_normal(n), dtype=torch.float32)


def _ins(n, T, starts, ends, speeds, rev, bnd, E, mod=None, seed=5):
    """Scan inputs on the CPU: an n-sample tape, mod_q (1.0, or ``mod``),
    the tables and a Hann splice envelope of E."""
    mq = np.ones(T, np.float32) if mod is None else np.asarray(mod[:T],
                                                               np.float32)
    env = np.hanning(E + 2)[1:-1] if E else np.zeros(0)
    return (_audio(n, seed), torch.tensor(mq),
            torch.tensor(starts, dtype=torch.int32),
            torch.tensor(ends, dtype=torch.int32),
            torch.tensor(np.asarray(speeds, np.float32)),
            torch.tensor(rev, dtype=torch.bool),
            torch.tensor(bnd, dtype=torch.int32),
            torch.tensor(env, dtype=torch.float32))


def _edge(K, T, last):
    """The step that is a chunk's first (``last`` False: step K, or 0 for
    a chunk longer than T) or last (K - 1, or T - 1)."""
    if K < T:
        return K - 1 if last else K
    return T - 1 if last else 0


def _crossing(K, last):
    """Speed 1, mod 1: step t reads sample w0 + t, and the step that
    enters section 1 (speed 0.5, a boundary at its start) is a chunk's
    first or last; the splice envelope starts there."""
    T, X = 2000, 2500
    t = _edge(K, T, last)
    return (_ins(4000, T, [0, X], [X, 4000], [1.0, 0.5], [False, False],
                 [X], 24), _consts(), (X - t, 0, F32(1.0), 0, 0))


def _boundary_first(K):
    """A boundary inside section 0 (no section change) hit on a chunk's
    first step, in a reversed section read backwards at speed 1."""
    T = 2000
    t = _edge(K, T, False)
    b = 1800
    # reversed [0, 3000): step t reads 2999 - (w0 + t) - 0 = b
    return (_ins(3000, T, [0], [3000], [1.0], [True], [b], 16),
            _consts(), (2999 - b - t, 0, F32(1.0), 0, 0))


def _wrap():
    """A short tape read at ~2.6 samples a step: it wraps many times."""
    mod = tape.wow_flutter_mod(3000, 48000, 100)
    return (_ins(701, 3000, [0, 233], [233, 701], [2.7, 1.9], [True, False],
                 [233], 32, mod), _consts(inertia=True, alpha=0.02,
                                          speed0=0.5), None)


def _envelope(K):
    """A splice envelope of 2 K + 5 samples from a trigger on step 0:
    across three chunks (one chunk where K is longer than the render)."""
    T = 4000 if K > 3 else 400
    E = min(2 * K + 5, 3000)
    return (_ins(8000, T, [0, 100], [100, 8000], [0.75, 1.0],
                 [False, False], [100, 5000], E),
            _consts(), (100, 0, F32(1.0), 0, 0))


def _envelope_tail(K):
    """A carried envelope whose index reaches E with rem left over (rem
    E + 40, sidx E - K - 3): it stops on sidx, a chunk or so in, and rem
    stays above 0, so the later boundary hit triggers nothing."""
    ins, consts, _ = _envelope(K)
    E = ins[7].shape[0]
    return ins, consts, (100, 0, F32(1.0), E + 40, E - min(K, 500) - 3)


def _smoke(kind):
    """Bench config 1 (bench.py:157-265) on a 0.5 s tape, 4 000 frames with
    its wow/flutter (section 0, then the reversed section 1 at twice the
    speed); "carried": a state past 2n with frac 2**22 - 1 inside an
    envelope."""
    sr, seconds = 48000, 0.5
    rng = np.random.default_rng(7)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    audio = (x / np.max(np.abs(x))).astype(np.float32)
    n = len(audio)
    p = tape.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.12, 0.3, 0.45,
                                                      0.6, 0.8)],
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    p.section_speeds = tape.fit_to_target_time(p, n, seconds)
    prog = tape.build_tape_program(audio, p, 4000, device="cpu")
    ins = tape.scan_inputs(prog, tape.wow_flutter_mod(4000, sr, p.tape_age))
    state = None
    if kind == "carried":
        state = (n * 2 + 5, POS_ONE - 1, F32(1.25), 17, 3)
    return ins, prog["consts"], state


def _inertia():
    """Inertia from speed 0.2 toward 1.6 and back to 0.4: before and after
    its freeze, which leaves it off its target."""
    mod = tape.wow_flutter_mod(4000, 48000, 30)
    return (_ins(6000, 4000, [0, 3000], [3000, 6000], [1.6, 0.4],
                 [False, True], [3000], 20, mod),
            _consts(inertia=True, alpha=0.011, speed0=0.2), None)


def _speed0():
    return (_ins(500, 3000, [0], [500], [0.0], [False], [250], 8),
            _consts(), (249, 123, F32(0.0), 0, 0))


def _reverse_edge():
    """A reversed section at 0 read at 0.3 a step: its reads reach
    (-1, 0) before the wrap to section 1."""
    return (_ins(400, 1500, [0, 100], [100, 400], [0.3, 1.0], [True, False],
                 [100], 12), _consts(), (92, 0, F32(0.3), 0, 0))


def _negative():
    """A negative speed passed straight in: the position falls and wraps
    below 0; no chunk may jump."""
    mod = tape.wow_flutter_mod(3000, 48000, 60)
    return (_ins(900, 3000, [0, 450], [450, 900], [-0.5, -1.5],
                 [False, True], [450], 16, mod), _consts(), None)


CHUNKS = [1, 3, 32, 1024, 8192]     # 8 192: longer than every render
CASES = ["crossing on a chunk's first step", "crossing on a chunk's last step",
         "boundary hit on a chunk's first step", "wrap",
         "envelope across three chunks", "envelope ending on its index",
         "smoke", "carried",
         "inertia", "speed 0", "reversed read in (-1, 0)", "negative speed"]


@functools.lru_cache(maxsize=None)
def _case(name, K):
    if name.startswith("crossing"):
        return _crossing(K, "last" in name)
    if name.startswith("boundary"):
        return _boundary_first(K)
    if name == "envelope ending on its index":
        return _envelope_tail(K)
    if name.startswith("envelope"):
        return _envelope(K)
    if name in ("smoke", "carried"):
        return _smoke(name)
    return {"wrap": _wrap, "inertia": _inertia, "speed 0": _speed0,
            "reversed read in (-1, 0)": _reverse_edge,
            "negative speed": _negative}[name]()


@functools.lru_cache(maxsize=None)
def _plain(name, K):
    ins, consts, state = _case(name, K)
    out, st = varispeed.tape_scan_render_plain(
        *ins, consts, None if state is None else scan_state(state))
    return out, _words(st)


def _check(name, K):
    ins, consts, state = _case(name, K)
    want, st_w = _plain(name, K)
    got, st_g, recs = render_chunked(ins, consts, K, state)
    assert torch.equal(got, want), name
    assert st_g == st_w, name
    assert len(recs) == -(-ins[1].shape[0] // K)
    return ins, consts, recs


@pytest.mark.parametrize("K", CHUNKS)
@pytest.mark.parametrize("name", CASES)
def test_chunked_model_bit_equal_to_plain(name, K):
    ins, consts, recs = _check(name, K)
    kinds = [k for k, _ in recs]
    if name == "negative speed":
        assert "jumped" not in kinds
    if name in ("speed 0", "smoke") and K == 32:
        assert kinds.count("jumped") >= 0.9 * len(kinds)


@pytest.mark.parametrize("K", CHUNKS)
@pytest.mark.parametrize("extra", [0, 1, -1, 2], ids=["0", "1", "K-1", "K+1"])
def test_chunked_model_render_lengths(K, extra):
    """T of 0, 1, K - 1 and K + 1 (at most the case's 4 000) from the
    smoke tape's carried state."""
    T = min({0: 0, 1: 1, -1: K - 1, 2: K + 1}[extra], 4000)
    ins, consts, state = _case("carried", 32)
    part = (ins[0], ins[1][:T].contiguous()) + ins[2:]
    want, st_w = varispeed.tape_scan_render_plain(*part, consts,
                                                   scan_state(state))
    got, st_g, recs = render_chunked(part, consts, K, state)
    assert got.shape == (T,) and torch.equal(got, want)
    assert st_g == _words(st_w)


def test_chunked_cases_reach_what_they_name():
    """The cases' trajectories hold what their names say (from the plain
    loop's view of the state): the crossing and boundary steps fall on
    the named chunk edges, the wrap wraps, the inertia freezes off its
    target, the reversed read reaches (-1, 0)."""
    for K in (32, 1024):
        for last in (False, True):
            ins, consts, state = _crossing(K, last)
            t = _edge(K, 2000, last)
            part = (ins[0], ins[1][:t].contiguous()) + ins[2:]
            _, st = varispeed.tape_scan_render_plain(*part, consts,
                                                     scan_state(state))
            assert int(st.whole) == 2500 and int(st.frac) == 0
            assert t % K == (K - 1 if last else 0)
    ins, consts, _ = _inertia()
    _, st = varispeed.tape_scan_render_plain(*ins, consts)
    speed = float(st.speed)
    assert speed != float(F32(0.4)) and abs(speed - 0.4) < 0.05
    ins, consts, state = _reverse_edge()
    model = ChunkedScan(ins, consts, 32, state)
    recs, _ = model.walk()
    idx0, fr, _ = model.replay(recs)
    assert any(f < 0 for f in fr)
    ins, consts, _ = _wrap()
    ch = Chain(ChunkedScan(ins, consts, 32).tabs,
               (0, 0, F32(consts.initial_speed_q), 0, 0))
    wraps = 0
    for m in ins[1].numpy():
        wraps += ch.whole >= ch.n
        ch.step(m)
    assert wraps >= 5
