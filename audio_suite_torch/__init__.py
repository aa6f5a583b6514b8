"""audio_suite_torch — the PyTorch / CUDA port of audio_suite_tpu.

The JAX package (``audio_suite_tpu``) is the reference; this package mirrors
its module layout (``ops/noise.py``, ``ops/spectral.py``,
``models/microsound.py``, ...) so each function has an obvious counterpart,
and is held against it by ``tests/test_torch_*.py``.

Ported so far:

- the Microsound render of the "Noise burst" generator with a shared
  stretch factor (the bench's high-rate transient-field configuration),
  end to end: host event program -> grain spectrum draw -> lowpass +
  spectral stretch -> ordered overlap-add -> ADSR, ER/IR convolution,
  stereo diffusion, soft clip, normalize, PCM16;
- the tape engine's default render (the bench's chopped varispeed
  configuration): host control tables from the shared C++ runtime ->
  wow/flutter synthesis, speed runs, segmented fixed-point positions,
  section read index, anti-click and splice gains -> the linear read ->
  clip, PCM16.

Paths outside those slices raise ``NotImplementedError``.

Conventions:

- plain functions on tensors; every entry point takes an explicit
  ``device`` and nothing here probes devices at import time;
- randomness is the counter-hash noise of ``ops/noise.py`` (bit-exact with
  the JAX package), so no ``torch.Generator`` is involved;
- hand-written CUDA kernels live in ``kernels/`` and are built with ``nvcc``
  on first use.  A wrapper launches its kernel for CUDA tensors (raising if
  the build or launch fails) and runs its plain PyTorch version only for
  CPU tensors.
- the package imports nothing of the JAX package and no ``jax``.  It keeps
  its own copies of the host modules it needs, each where the JAX package
  has the original (``events/schedulers.py``, ``utils/breakpoints.py``,
  ``utils/io.py`` with ``utils/wavcodec.py``), and its own loader of the
  C++ host runtime ``native/ast_runtime.cpp`` (``utils/native_rt.py``),
  the one source it shares.
"""

__version__ = "0.1.0"
