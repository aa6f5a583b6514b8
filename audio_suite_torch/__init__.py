"""audio_suite_torch — the PyTorch / CUDA port of audio_suite_tpu.

The JAX package (``audio_suite_tpu``) is the reference; this package mirrors
its module layout (``ops/noise.py``, ``ops/spectral.py``,
``models/microsound.py``, ...) so each function has an obvious counterpart,
and is held against it by ``tests/test_torch_*.py``.

It ports every path of the JAX package, the ``bench`` harness aside:

- Microsound, every render path (the bench's high-rate transient-field
  configuration and the reference app's factory settings): host event
  program with per-event aux draws -> one of eleven grain generators (the
  stick-slip, micro-chaos and waveguide recurrences in
  ``kernels/grain_scan.cu``) -> the spectral chain (fused lowpass +
  stretch, or warps, cepstral warp, partial lock), resonator, waveguide,
  multi-band unfold -> feedback / imprint across events -> ordered
  overlap-add -> ADSR, ER/IR convolution, stereo diffusion, soft clip,
  normalize, PCM16; its transforms and transcendentals evaluate in f64
  and round once, so the card's grains are the CPU's;
- the tape engine (the bench's chopped varispeed configuration): the
  device render (host control tables from the shared C++ runtime ->
  wow/flutter synthesis, speed runs, segmented fixed-point positions,
  section read index, anti-click and splice gains -> the linear read or
  the 16-tap sinc read -> clip, PCM16), the segment engine (the C++
  per-sample trajectory -> the linear read), the scan engine (the
  per-sample recurrence in ``kernels/tape_scan.cu``) and the performance
  renderer (a ``TapeTrace`` of timed edits -> segment programs with their
  state carried across them -> one device render a segment);
- the scrub engine (the bench's multi-head gestural scrub): host gesture
  trace and program -> per-sample increments (detmath LFOs, counter-noise
  jitter) -> segmented fixed-point positions -> the wrap-around read of
  one to three heads (linear, the kernel's multi-head form; or sinc),
  per control segment -> dropout envelope, PCM16;
- the Pattern Lab render (the bench's four-generator configuration):
  host pattern generators -> note batch -> length buckets -> FM and PSG
  voice bank, a batch of notes per bucket -> ordered overlap-add ->
  tanh master bus -> PCM16;
- the Grid Audio mixdown (the grid half of the bench's config 5): host
  project model, user cells through ``plugins/host.py``, restart events
  and patterns -> per track, the mod-speed chain of ``ops/envdet.py``,
  segmented fixed-point positions and a gather from the gain-premultiplied
  pattern bank -> mix, clip, PCM16; and the host engine over the shared
  C++ phase accumulator;
- the Forest Fire CA and its threshold rules (the second half of config
  5): host NumPy init and brush edits -> per step, counter-noise draws from
  per-cell hash keys computed once per ``simulate``, the spread stencil,
  ember landings, regrowth and the stats row, all on the device -> the
  stats pulled once -> ``events/rules.py`` thresholds -> OSC packets;
- the parallel layer (``parallel/``): device meshes of the host's cards
  or of a given device list, sharded batch renders with ordered
  collectives, Microsound's batch render with a resumable manifest, the
  time-sharded FIR convolution, the row-sharded CA (the dense step under
  a sharding adapter), multi-process dispatch on ``torch.distributed``
  and a multi-device dry run of every engine;
- the surfaces: the seven-subcommand CLI (``python -m
  audio_suite_torch.cli --device cuda|cpu ...``, its renders traced on
  ``torch.profiler`` with ``--trace DIR``; ``bench`` has no harness in
  the port yet and exits non-zero), ``utils/profiling.py`` and
  ``utils/metrics.py``, Microsound's ``load_image_gray``, Pattern Lab's
  "Python Script" generator, and ``plugins/torch_cells.py``, the device
  grid cells (JAX's threefry draws ported bit-exact in ``ops/threefry.py``).

Conventions:

- plain functions on tensors; every entry point takes a ``device``,
  ``"cuda"`` unless the caller passes another (without CUDA that default
  raises: nothing falls back to the CPU), and nothing here probes
  devices at import time;
- randomness is the counter-hash noise of ``ops/noise.py`` (bit-exact with
  the JAX package), so no ``torch.Generator`` is involved;
- hand-written CUDA kernels live in ``kernels/`` and are built with ``nvcc``
  on first use.  A wrapper launches its kernel for CUDA tensors (raising if
  the build or launch fails) and runs its plain PyTorch version only for
  CPU tensors.
- the package imports nothing of the JAX package and no ``jax``.  It keeps
  its own copies of the host modules it needs, each where the JAX package
  has the original (``events/schedulers.py``, ``events/notes.py``,
  ``utils/breakpoints.py``, ``utils/music.py``, ``utils/io.py`` with
  ``utils/wavcodec.py``, ``plugins/host.py``, ``events/rules.py``), and
  its own loader of the C++ host runtime ``native/ast_runtime.cpp``
  (``utils/native_rt.py``), the one source it shares.
"""

__version__ = "0.1.0"
