"""Forest Fire CA engine — port of audio_suite_tpu/models/forestfire.py.

The reference's fuel / moisture / wind / terrain / ember cellular automaton
(forest_fire_OSC_0.1/model.py), bit-exact with the JAX package's jitted
``simulate`` in both noise modes and with its NumPy oracle
(``oracles/forestfire_ref.py``; in ``fast_noise``, with the fused draws put
in at the oracle's draw sites, as its own fast branch is never read):

- initialization stays host NumPy and reference-exact (the same
  ``np.random.default_rng(seed)`` draw order as model.py:74-96);
- the per-step randomness is the counter-hash noise of ``ops/noise.py``,
  keyed by (seed, cell, step * 16 + site).  The per-cell part of the hash
  (``noise.cell_key``) does not change over a ``simulate`` call, so the
  step loop computes it once and each draw hashes only its stream;
- the rain draw's inputs (seed, cell 0, the step's stream) are all host
  ints, so the rain decision is made on the host with the NumPy twin: no
  launch and no host sync, and the step branches on a Python bool;
- every multiply that feeds an add takes 12-bit-significand operands
  (``fixq.round_sig12``), so its product is exact in f32, and every op is
  its own PyTorch call, rounded once: nothing can contract into an FMA,
  so the card, the CPU and NumPy give the same bits;
- ``simulate`` runs its steps eagerly, one after another, and keeps each
  step's stats row on the device; the rows are stacked and pulled once at
  the end, so there is no host sync inside the loop.

Interactive brush edits (ignite / set-tree / clear, model.py:224-258) and
``render_rgb`` operate on the host-side NumPy mirror of the state, as in
the JAX package.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import noise
from ..ops.fixq import round_sig12, round_sig12_np

EMPTY, TREE, FIRE, ASH = 0, 1, 2, 3

# per-step noise stream sites (uniform sites; normals get _NRM_OFFSET)
_SITES = 16
_S_RAIN, _S_SPREAD, _S_LIGHT, _S_EMIT, _S_DIST, _S_IGNITE, _S_GROW_E, \
    _S_GROW_A, _S_FUEL_E, _S_FUEL_A = range(10)
_S_JX, _S_JY = 10, 11
_NRM_OFFSET = 1 << 20
EMBER_CAP = 1024    # max emitting cells whose embers land per step
_MASK32 = 0xFFFFFFFF

# the carry's planes and their dtypes
_PLANES = {"state": torch.int32, "fuel": torch.float32,
           "moisture": torch.float32, "elev": torch.float32,
           "age": torch.int32}


@dataclass(unsafe_hash=True)
class ModelParams:
    """(model.py:12-46).  unsafe_hash: instances key the cache of the
    quantized constants; treat them as immutable after first use."""
    w: int = 220
    h: int = 160
    p_tree_init: float = 0.62
    lightning_rate: float = 3e-6
    base_spread: float = 0.37
    fuel_burn_rate: float = 0.18
    burnout_fuel: float = 0.05
    ember_rate: float = 0.035
    ember_max_dist: int = 18
    spotting_strength: float = 0.9
    regrow_rate: float = 0.006
    ash_regrow_rate: float = 0.003
    moisture_relax: float = 0.01
    rain_chance: float = 0.015
    rain_strength: float = 0.25
    wind_dir_deg: float = 25.0
    wind_strength: float = 0.75
    slope_strength: float = 0.35
    show_moisture_overlay: bool = False
    # fast_noise=True fuses the per-cell draw sites (16-bit uniform pairs
    # + byte-sliced Irwin-Hall(4) ember jitter, ops/noise.py): its own
    # documented stream family, bit-exact with the JAX package's
    fast_noise: bool = False

    def wind_vec(self):
        ang = np.deg2rad(self.wind_dir_deg)
        return float(np.float32(np.cos(ang))), float(np.float32(np.sin(ang)))

    def static_key(self) -> tuple:
        return (self.w, self.h, self.lightning_rate, self.base_spread,
                self.fuel_burn_rate, self.burnout_fuel, self.ember_rate,
                self.ember_max_dist, self.spotting_strength,
                self.regrow_rate, self.ash_regrow_rate, self.moisture_relax,
                self.rain_chance, self.rain_strength, self.wind_dir_deg,
                self.wind_strength, self.slope_strength, self.fast_noise)


def _f32(v) -> float:
    """v rounded to f32, as a Python float: the value the f32 op it feeds
    takes, as ``jnp.float32(v)`` in the JAX package."""
    return float(np.float32(v))


def quantized_consts(params: ModelParams) -> dict:
    """Rate/boost constants rounded to 12-bit significands (shared by the
    device step and the NumPy oracle)."""
    q = lambda v: float(round_sig12_np(np.float32(v)))
    wx, wy = params.wind_vec()
    return {
        "relax": q(params.moisture_relax),
        "c020": q(0.20),
        "slope": q(params.slope_strength),
        "wind": q(params.wind_strength),
        "c06": q(0.6),
        "c065": q(0.65),
        "c075": q(0.75),
        "c08": q(0.8),
        "c03": q(0.3),
        "c035n": q(0.35),
        "c0005": q(0.005),
        "wx": q(wx),
        "wy": q(wy),
        "sig": q(1.25 + 1.4 * params.wind_strength),
    }


@lru_cache(maxsize=16)
def _consts(params: ModelParams) -> dict:
    """quantized_consts, once per params (host NumPy: the step loop would
    otherwise pay it every step).  Read-only."""
    return quantized_consts(params)


def init_state(params: ModelParams, seed: int = 1) -> dict:
    """Reference-exact initialization (model.py:74-96, same rng stream)."""
    p = params
    rng = np.random.default_rng(seed)
    shape = (p.h, p.w)

    state = np.zeros(shape, np.int8)
    trees = rng.random(shape) < p.p_tree_init
    state[trees] = TREE

    fuel = np.zeros(shape, np.float32)
    fuel[trees] = rng.uniform(0.75, 1.0, size=int(trees.sum())) \
        .astype(np.float32)

    base = _smooth_noise(rng, shape, 3)
    base = 0.15 + 0.55 * base
    jitter = rng.normal(0.0, 0.06, size=shape).astype(np.float32)
    moisture = np.clip(base + jitter, 0.0, 1.0).astype(np.float32)

    hills = _smooth_noise(rng, shape, 4)
    # 12-bit significand so terrain-gradient products are exact
    elev = round_sig12_np((hills ** 1.7).astype(np.float32))

    return {
        "state": state.astype(np.int32),
        "fuel": fuel,
        "moisture": moisture,
        "elev": elev,
        "age": np.zeros(shape, np.int32),
        "t": np.int32(0),
    }


def _smooth_noise(rng, shape, blur_iters: int) -> np.ndarray:
    """9-point box blur noise (model.py:101-115)."""
    x = rng.random(shape).astype(np.float32)
    for _ in range(int(blur_iters)):
        x = (x
             + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)
             + np.roll(np.roll(x, 1, 0), 1, 1)
             + np.roll(np.roll(x, 1, 0), -1, 1)
             + np.roll(np.roll(x, -1, 0), 1, 1)
             + np.roll(np.roll(x, -1, 0), -1, 1)
             ) / 9.0
    mn, mx = float(x.min()), float(x.max())
    if mx - mn < 1e-6:
        return np.zeros(shape, np.float32)
    return (x - mn) / (mx - mn)


def _roll_or8(m: torch.Tensor) -> torch.Tensor:
    """8-neighbour OR stencil (model.py:146-153) in four rolls: the north
    and south neighbours, then that pair and the cell itself shifted east
    and west.  The same eight wrapped shifts as the JAX package's eight
    rolls, so the same mask."""
    ns = torch.roll(m, 1, 0) | torch.roll(m, -1, 0)
    col = ns | m
    return ns | torch.roll(col, 1, 1) | torch.roll(col, -1, 1)


def terrain_static(params: ModelParams, elev: torch.Tensor) -> dict:
    """Step-invariant terrain fields (elev never changes): the gradient /
    wind dot product, uphill slope boost, wind boost and moisture
    baseline, computed once per ``simulate`` call.  ``torch.gradient``
    gives ``np.gradient``'s f32 values (central differences halved, one-
    sided at the edges)."""
    qc = _consts(params)
    q12 = round_sig12
    gy, gx = torch.gradient(elev)
    dot = q12(gx) * qc["wx"] + q12(gy) * qc["wy"]
    uphill = torch.clamp(-dot, 0.0, 1.0)
    slope_boost = 1.0 + qc["slope"] * q12(uphill)
    wind_clip = torch.clamp(dot + 0.5, 0.0, 1.0)
    wind_boost = 1.0 + q12(qc["wind"] * wind_clip) * qc["c06"]
    baseline = torch.clamp(_f32(0.45) - qc["c020"] * elev, _f32(0.05),
                           _f32(0.7))
    return {"slope_boost": slope_boost, "wind_boost": wind_boost,
            "baseline": baseline}


class DenseSpatial:
    """Spatial coupling of the CA step on one device (the default).

    step_device routes everything that reaches OUTSIDE a cell's own row
    block through this adapter — the global cell-index grid that keys the
    counter-based RNG, the 8-neighbour stencil, the ember candidate
    selection + arrival scatter, and the stat reductions — so a
    row-sharded adapter can subclass it while every per-cell arithmetic
    op stays the same code."""

    def cells(self, H: int, W: int, device) -> torch.Tensor:
        """Global cell-index grid [H, W] (int64) for the RNG streams."""
        return torch.arange(H * W, dtype=torch.int64,
                            device=device).reshape(H, W)

    def rows(self, H: int, device) -> torch.Tensor:
        """Global row-index column [H, 1] (int32) for ember landings."""
        return torch.arange(H, dtype=torch.int32, device=device)[:, None]

    def roll_or8(self, m: torch.Tensor) -> torch.Tensor:
        return _roll_or8(m)

    def ember_arrivals(self, emit: torch.Tensor, lin: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
        """Ember arrival mask from the emit mask and per-cell landing
        indices (global linear).  Returns bool [H, W].

        Emitters are compacted to the EMBER_CAP largest linear indices
        (``topk`` over ``where(emit, iota, -1)``, as the JAX package's
        ``lax.top_k``; the set is unique, so its order does not matter) and
        only those land, through an int32 ``index_add_``: integer adds
        are order-free, so the mask is deterministic on the card.  The cap
        binds only if more than EMBER_CAP cells emit in one step."""
        n = H * W
        iota = torch.arange(n, dtype=torch.int32, device=emit.device)
        cand = torch.where(emit.reshape(-1), iota, -1)
        sel = torch.topk(cand, min(EMBER_CAP, n), sorted=False).values
        land = lin.reshape(-1).index_select(0, sel.clamp(0, n - 1))
        arrivals = torch.zeros(n, dtype=torch.int32, device=emit.device)
        arrivals.index_add_(0, land, (sel >= 0).to(torch.int32))
        return (arrivals > 0).reshape(H, W)

    def rsum(self, x: torch.Tensor) -> torch.Tensor:
        """Grid-wide int32 sum (0-d)."""
        return x.sum(dtype=torch.int32)


_DENSE_SPATIAL = DenseSpatial()


def _rain(step_idx: int, params: ModelParams, seed: int) -> bool:
    """The step's scalar rain draw, on the host (all its inputs are host
    ints): ``uniform(seed, 0, step * 16 + _S_RAIN) < rain_chance``."""
    stream = (int(step_idx) * _SITES + _S_RAIN) & _MASK32
    return bool(noise.uniform_np(int(seed) & _MASK32, 0, stream)
                < np.float32(params.rain_chance))


def step_device(carry: dict, step_idx: int, params: ModelParams, seed: int,
                terrain: dict | None = None,
                spatial: DenseSpatial | None = None,
                cell_keys: torch.Tensor | None = None):
    """One CA step (model.py:121-222) on the carry's device.  Returns
    (carry', stats): stats is an int32 [8] tensor on that device, in
    STAT_KEYS order.

    ``step_idx`` is a host int (the streams are Python scalars);
    ``terrain`` (``terrain_static``) and ``cell_keys``
    (``noise.cell_key(seed, cells)``) are computed here when not given;
    ``spatial`` (default DenseSpatial) supplies every spatially-coupled
    piece."""
    p = params
    H, W = p.h, p.w
    sp = spatial if spatial is not None else _DENSE_SPATIAL
    state, fuel, moisture, elev, age = (carry["state"], carry["fuel"],
                                        carry["moisture"], carry["elev"],
                                        carry["age"])
    dev = state.device
    if cell_keys is None:
        cell_keys = noise.cell_key(seed, sp.cells(H, W, dev))
    base_stream = int(step_idx) * _SITES

    def stream(site):       # uint32 arithmetic, as the JAX package's
        return (base_stream + site) & _MASK32

    def u(site):
        return noise.uniform_key(cell_keys, stream(site))

    def nrm(site):
        return noise.normal_key(cell_keys, stream(_NRM_OFFSET + site))

    qc = _consts(p)
    q12 = round_sig12
    wx, wy = qc["wx"], qc["wy"]

    # per-cell randomness, hoisted: 10 draw sites + 2 jitter normals, or
    # with fast_noise 16-bit uniform pairs (two sites per hash) and
    # Irwin-Hall(4) jitter.  Lightning keeps its own 24-bit draw in both.
    if p.fast_noise:
        d_spread, d_emit = noise.uniform_pair_key(cell_keys,
                                                  stream(_S_SPREAD))
        d_ignite, d_dist = noise.uniform_pair_key(cell_keys,
                                                  stream(_S_IGNITE))
        d_grow_e, d_grow_a = noise.uniform_pair_key(cell_keys,
                                                    stream(_S_GROW_E))
        d_fuel_e, d_fuel_a = noise.uniform_pair_key(cell_keys,
                                                    stream(_S_FUEL_E))
        jx_raw = noise.normal_ih4_key(cell_keys, stream(_NRM_OFFSET + _S_JX))
        jy_raw = noise.normal_ih4_key(cell_keys, stream(_NRM_OFFSET + _S_JY))
    else:
        d_spread, d_emit = u(_S_SPREAD), u(_S_EMIT)
        d_ignite, d_dist = u(_S_IGNITE), u(_S_DIST)
        d_grow_e, d_grow_a = u(_S_GROW_E), u(_S_GROW_A)
        d_fuel_e, d_fuel_a = u(_S_FUEL_E), u(_S_FUEL_A)
        jx_raw, jy_raw = nrm(_S_JX), nrm(_S_JY)
    d_light = u(_S_LIGHT)

    # rain (scalar per step, decided on the host)
    rain = _rain(step_idx, p, seed)
    if rain:
        moisture = torch.clamp(moisture + _f32(p.rain_strength), 0.0, 1.0)

    if terrain is None:
        terrain = terrain_static(p, elev)

    # moisture relax toward elevation baseline (the multiply is exact:
    # 12-bit x 12-bit significands)
    moisture = moisture + qc["relax"] * q12(terrain["baseline"] - moisture)
    moisture = torch.clamp(moisture, 0.0, 1.0)

    # burning consumes fuel -> ash
    burning = state == FIRE
    fuel = torch.where(burning,
                       torch.clamp(fuel - _f32(p.fuel_burn_rate), 0.0, 1.0),
                       fuel)
    state = torch.where(burning & (fuel <= _f32(p.burnout_fuel)), ASH, state)

    # neighbourhood fire mask
    fire = state == FIRE
    fire_n = sp.roll_or8(fire)
    trees = state == TREE

    fuel_term = torch.clamp(fuel, 0.0, 1.0)
    moist_term = 1.0 - torch.clamp(moisture, 0.0, 1.0)
    spread_p = (_f32(p.base_spread) * moist_term
                * (_f32(0.35) + qc["c065"] * q12(fuel_term))
                * terrain["slope_boost"] * terrain["wind_boost"])
    spread_p = torch.clamp(spread_p, 0.0, _f32(0.99))

    will_spread = trees & fire_n & (d_spread < spread_p)
    lightning = trees & (d_light < _f32(p.lightning_rate) * moist_term)
    ignitions = will_spread | lightning

    # ember spotting: every cell computes its landing; non-emitters are
    # masked; ignition is evaluated at the landing cell from its own fields
    # and its own draw (the JAX package's destination-draw semantics)
    emit = fire & (d_emit < _f32(p.ember_rate))
    d = 3.0 + torch.floor(d_dist * _f32(p.ember_max_dist + 1 - 3))
    sig = qc["sig"]
    jx = q12(jx_raw) * sig     # exact: 12x12-bit significands
    jy = q12(jy_raw) * sig
    dx = (wx * d + jx).to(torch.int32)   # wx*d exact: 12-bit x small int
    dy = (wy * d + jy).to(torch.int32)
    yi = sp.rows(H, dev)
    xi = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    yy = torch.remainder(yi + dy, H)
    xx = torch.remainder(xi + dx, W)
    lin = yy * W + xx
    arrived = sp.ember_arrivals(emit, lin, H, W)
    p_ember = torch.clamp(
        _f32(p.spotting_strength) * (1.0 - moisture)
        * (_f32(0.25) + qc["c075"] * q12(fuel)),
        0.0, _f32(0.95))
    ember_ignitions = arrived & trees & (d_ignite < p_ember)

    ignitions = ignitions | ember_ignitions
    n_ignitions = sp.rsum(ignitions)
    n_embers = sp.rsum(emit)
    state = torch.where(ignitions, FIRE, state)

    # regrowth
    empty = state == EMPTY
    ash = state == ASH
    grow_mod = torch.clamp(_f32(0.6) + qc["c08"] * q12(moisture), 0.0,
                           _f32(1.6))
    regrow_empty = empty & (d_grow_e < _f32(p.regrow_rate) * grow_mod)
    regrow_ash = ash & (d_grow_a < _f32(p.ash_regrow_rate) * grow_mod)

    fuel_new_e = 0.5 + qc["c03"] * q12(d_fuel_e)
    fuel_new_a = _f32(0.55) + qc["c035n"] * q12(d_fuel_a)
    regrow = regrow_empty | regrow_ash
    state = torch.where(regrow, TREE, state)
    fuel = torch.where(regrow_empty, fuel_new_e, fuel)
    fuel = torch.where(regrow_ash, fuel_new_a, fuel)
    age = torch.where(regrow, 0, age)

    trees2 = state == TREE
    age = torch.where(trees2, torch.clamp(age + 1, 0, 65535), age)
    fuel = torch.where(trees2,
                       torch.clamp(fuel + (_f32(0.003)
                                           + qc["c0005"] * q12(moisture)),
                                   0.0, 1.0),
                       fuel)

    t = int(carry["t"]) + 1
    carry = {"state": state, "fuel": fuel, "moisture": moisture,
             "elev": elev, "age": age, "t": t}
    # t and rain are host values: fills, not copies (a copy of a host
    # scalar would synchronize with the card)
    stats = torch.stack([
        torch.full((), t, dtype=torch.int32, device=dev),
        sp.rsum(state == TREE),
        sp.rsum(state == FIRE),
        sp.rsum(state == ASH),
        sp.rsum(state == EMPTY),
        n_ignitions,
        n_embers,
        torch.full((), int(rain), dtype=torch.int32, device=dev),
    ])
    return carry, stats


STAT_KEYS = ("t", "trees", "burning", "ash", "empty", "ignitions",
             "embers", "rain")


def _sim(carry: dict, n_steps: int, params: ModelParams, seed: int,
         spatial: DenseSpatial | None = None, terrain: dict | None = None):
    """The step loop (the JAX package's ``_sim_fn`` scan): ``n_steps``
    eager steps from ``carry`` (tensors on one device, ``t`` a host int),
    with the terrain fields and the per-cell hash keys computed once.
    ``terrain`` is computed from the carry's elevation when not given (a
    row shard passes its block of the whole grid's: the gradient reads
    across shard edges).  Returns (carry', stats int32 [n_steps, 8] on the
    device): nothing inside waits for the card."""
    sp = spatial if spatial is not None else _DENSE_SPATIAL
    dev = carry["state"].device
    t0 = int(carry["t"])
    if terrain is None:
        terrain = terrain_static(params, carry["elev"])
    keys = noise.cell_key(seed, sp.cells(params.h, params.w, dev))
    rows = []
    for k in range(int(n_steps)):
        carry, row = step_device(carry, t0 + k, params, seed, terrain, sp,
                                 keys)
        rows.append(row)
    if not rows:
        return carry, torch.zeros((0, len(STAT_KEYS)), dtype=torch.int32,
                                  device=dev)
    return carry, torch.stack(rows)


def carry_from_state(state: dict, device="cuda") -> dict:
    """The device carry from a state dict: NumPy arrays (``init_state``, a
    model's ``_np``, or the JAX package's, brush edits included) are copied
    to ``device``, tensors moved there; ``t`` becomes a host int."""
    dev = torch.device(device)
    carry = {k: (state[k].to(device=dev, dtype=dt)
                 if isinstance(state[k], torch.Tensor)
                 else torch.tensor(np.asarray(state[k]), dtype=dt,
                                   device=dev))
             for k, dt in _PLANES.items()}
    carry["t"] = int(state["t"])
    return carry


class ForestFireModel:
    """Host wrapper mirroring the reference API (model.py:49-271): step(),
    get_stats(), brush edits, render_rgb; steps run on ``device`` (singly
    or batched via simulate())."""

    def __init__(self, params: ModelParams, seed: int = 1, device="cuda"):
        if params.w < 2 or params.h < 2:
            # terrain slope/wind boosts need a gradient (model.py:79-83)
            raise ValueError("forest-fire grid must be at least 2x2, got "
                             f"{params.w}x{params.h}")
        self.params = params
        self.seed = int(seed)
        self.device = torch.device(device)
        self._state = init_state(params, seed)  # NumPy arrays OR the carry
        self._last = np.zeros(8, np.int64)

    # -- simulation --------------------------------------------------------

    @property
    def _np(self):
        """Writable host copy of the state (brush edits, rgb, stats).  After
        simulate() the state lives on the device; it is pulled lazily, on
        the first host access."""
        if any(isinstance(v, torch.Tensor) for v in self._state.values()):
            self._state = {k: (v.cpu().numpy().copy()
                               if isinstance(v, torch.Tensor) else v)
                           for k, v in self._state.items()}
            self._state["t"] = np.int32(self._state["t"])
        return self._state

    def _carry(self) -> dict:
        # the device carry passes straight back into the next simulate call;
        # a host mirror is copied to the device once
        return carry_from_state(self._state, self.device)

    def simulate(self, n_steps: int) -> np.ndarray:
        """Run n_steps on the device; returns stats [n_steps, 8] int32
        (columns = STAT_KEYS), pulled once.  The carry stays on the device
        between calls; host access (stats/edits/rgb) materializes it
        lazily."""
        self._state, stats = _sim(self._carry(), int(n_steps), self.params,
                                  self.seed)
        stats = stats.cpu().numpy()
        if len(stats):
            self._last = stats[-1].astype(np.int64)
            # make cap-binding runs visible: the ember scatter compacts
            # emitters to EMBER_CAP slots per step (the largest linear
            # indices); if more cells emitted, low-index emitters were
            # dropped that step
            max_embers = int(stats[:, 6].max())
            if max_embers > EMBER_CAP:
                warnings.warn(
                    f"forestfire: {max_embers} emitting cells in one step "
                    f"exceeds EMBER_CAP={EMBER_CAP}; lowest-index emitters "
                    "were dropped for that step", RuntimeWarning)
        return stats

    def step(self):
        self.simulate(1)

    def reset(self):
        self._state = init_state(self.params, self.seed)
        self._last = np.zeros(8, np.int64)

    randomize = reset

    def get_stats(self) -> dict:
        s = self._np["state"]
        return {
            "t": int(self._np["t"]),
            "trees": int((s == TREE).sum()),
            "burning": int((s == FIRE).sum()),
            "ash": int((s == ASH).sum()),
            "empty": int((s == EMPTY).sum()),
            "ignitions": int(self._last[5]),
            "embers": int(self._last[6]),
            "rain": int(self._last[7]),
        }

    # -- interactive edits (model.py:224-258) -------------------------------

    def _brush(self, x, y, radius):
        H, W = self._np["state"].shape
        rr = max(0, int(radius))
        ys = np.arange(y - rr, y + rr + 1) % H
        xs = np.arange(x - rr, x + rr + 1) % W
        Y, X = np.meshgrid(ys, xs, indexing="ij")
        mask = (X - x) ** 2 + (Y - y) ** 2 <= rr * rr
        return Y[mask], X[mask]

    def ignite_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        can = self._np["state"][yy, xx] == TREE
        self._np["state"][yy[can], xx[can]] = FIRE

    def set_tree_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        self._np["state"][yy, xx] = TREE
        self._np["fuel"][yy, xx] = np.clip(
            self._np["fuel"][yy, xx] + 0.5, 0.0, 1.0)

    def clear_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        self._np["state"][yy, xx] = EMPTY
        self._np["fuel"][yy, xx] = 0.0

    # -- rendering (model.py:273-309) ---------------------------------------

    def render_rgb(self) -> np.ndarray:
        s = self._np["state"]
        m = self._np["moisture"]
        f = self._np["fuel"]
        e = self._np["elev"]
        H, W = s.shape
        rgb = np.zeros((H, W, 3), np.uint8)

        empty = s == EMPTY
        tree = s == TREE
        fire = s == FIRE
        ash = s == ASH

        rgb[empty] = (18, 16, 16)
        g = (70 + 120 * (0.6 * f + 0.4 * m)).astype(np.uint8)
        r = (20 + 40 * (0.6 * m)).astype(np.uint8)
        b = (18 + 30 * (0.35 * m)).astype(np.uint8)
        rgb[tree, 0] = r[tree]
        rgb[tree, 1] = g[tree]
        rgb[tree, 2] = b[tree]

        inten = np.clip(0.3 + 0.7 * f, 0.0, 1.0)
        rr = (180 + 75 * inten).astype(np.uint8)
        gg = (70 + 120 * inten).astype(np.uint8)
        bb = (15 + 30 * inten).astype(np.uint8)
        rgb[fire, 0] = rr[fire]
        rgb[fire, 1] = gg[fire]
        rgb[fire, 2] = bb[fire]

        a = (70 + 80 * e).astype(np.uint8)
        rgb[ash] = np.stack([a, a, a], axis=-1)[ash]

        if self.params.show_moisture_overlay:
            overlay = (m * 255).astype(np.uint8)
            rgb[..., 2] = np.maximum(rgb[..., 2], overlay // 2)
        return rgb


def stats_rows_to_dicts(stats: np.ndarray) -> list[dict]:
    """[n, 8] stats -> list of reference-style stats dicts."""
    return [dict(zip(STAT_KEYS, (int(v) for v in row))) for row in stats]
