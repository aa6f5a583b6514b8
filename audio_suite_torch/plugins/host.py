"""Host-side user-script plugin API — the port's copy of
audio_suite_tpu/plugins/host.py, with its own module caches.

Two plugin contracts from the reference, kept wire-compatible so the
reference's example scripts run unchanged:

- Grid Audio cell modules (grid_audio_app_0.2/grid_audio_app.py:72-109):
  `generate(sr, duration[, context])` returning audio, and/or
  `event(context)` returning a restart-request dict.  Context keys per
  examples/README_CONTEXT.txt:8-19, event protocol per
  examples/README_RESTART_EVENTS.txt:3-17.
- Pattern Lab generator scripts (pattern lab 0.1/app/script_host.py):
  a callable (default name `generate`) taking (cfg, **kwargs) and returning
  a list of NoteEvent; cached by (path, mtime, entry).

User scripts are arbitrary host Python/NumPy; their outputs are shipped to
device as arrays (SURVEY.md §7 design decision 6).
"""
from __future__ import annotations

import importlib.util
import inspect
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple


# ----------------------------------------------------------------------------
# Grid Audio cell modules
# ----------------------------------------------------------------------------

class LoadedModule:
    """grid_audio_app.py:72-99 — validates generate/event arity."""

    def __init__(self, path: str):
        self.path = path
        self.mod = self._load_module(path)
        self.generate = getattr(self.mod, "generate", None)
        self.event = getattr(self.mod, "event", None)

        if self.generate is not None:
            sig = inspect.signature(self.generate)
            if len(sig.parameters) not in (2, 3):
                raise RuntimeError(
                    "generate() must take (sr, duration) or (sr, duration, context)")
        if self.event is not None:
            sig = inspect.signature(self.event)
            if len(sig.parameters) != 1:
                raise RuntimeError("event() must take (context)")
        if self.generate is None and self.event is None:
            raise RuntimeError(
                "Python cell scripts must define generate(...) and/or event(context).")

    @staticmethod
    def _load_module(path: str):
        spec = importlib.util.spec_from_file_location(
            f"cell_module_{abs(hash(path))}", path)
        if spec is None or spec.loader is None:
            raise RuntimeError(f"Could not load script: {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


_MODULE_CACHE: Dict[str, LoadedModule] = {}


def load_py_module(path: str) -> LoadedModule:
    """Path-keyed cache (grid_audio_app.py:101-109)."""
    m = _MODULE_CACHE.get(path)
    if m is None:
        m = LoadedModule(path)
        _MODULE_CACHE[path] = m
    return m


def clear_module_cache():
    _MODULE_CACHE.clear()


# ----------------------------------------------------------------------------
# Pattern Lab generator scripts (app/script_host.py:20-73)
# ----------------------------------------------------------------------------

_CACHE: Dict[Tuple[str, float, str], Callable[..., Any]] = {}


def invalidate_cache(path: Optional[Path] = None) -> None:
    global _CACHE
    if path is None:
        _CACHE.clear()
        return
    ap = str(Path(path).resolve())
    _CACHE = {k: v for k, v in _CACHE.items() if k[0] != ap}


def load_script_generator(path: Path, entry: str = "generate") -> Callable[..., Any]:
    path = Path(path).resolve()
    if not path.exists():
        raise FileNotFoundError(f"Script not found: {path}")

    mtime = path.stat().st_mtime
    key = (str(path), float(mtime), str(entry))
    if key in _CACHE:
        return _CACHE[key]

    mod_name = f"ast_user_script_{abs(hash((str(path), mtime))) & 0xFFFFFFFF:x}"
    spec = importlib.util.spec_from_file_location(mod_name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"Could not load spec for: {path}")
    module = importlib.util.module_from_spec(spec)
    module.__file__ = str(path)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)

    fn = getattr(module, entry, None)
    if not callable(fn):
        raise AttributeError(f"Script '{path.name}' has no callable '{entry}'")
    _CACHE[key] = fn
    return fn


# ----------------------------------------------------------------------------
# Pattern Lab reference-example compatibility
# ----------------------------------------------------------------------------

def ensure_pattern_lab_examples_importable():
    """The reference's Pattern Lab example scripts do
    ``from examples._common import NoteEvent, RenderConfig, SCALES, ...``
    but ``examples/_common.py`` is missing from the repo (SURVEY.md §2.3).
    This registers a synthetic ``examples._common`` module backed by this
    framework's event model and music math, so the reference examples run
    unchanged."""
    import types

    if "examples._common" in sys.modules:
        return sys.modules["examples._common"]

    from ..events.notes import NoteEvent, RenderConfig
    from ..models.patternlab import SCALES
    from ..utils import music

    common = types.ModuleType("examples._common")
    common.NoteEvent = NoteEvent
    common.RenderConfig = RenderConfig
    common.SCALES = dict(SCALES)
    common.beat_to_sec = lambda bpm, beats: float(beats) * 60.0 / float(bpm)
    common.primes_upto = music.primes_upto
    common.pythagorean_ratio = music.pythagorean_ratio

    pkg = sys.modules.get("examples")
    if pkg is None:
        pkg = types.ModuleType("examples")
        pkg.__path__ = []      # mark as package
        sys.modules["examples"] = pkg
    pkg._common = common
    sys.modules["examples._common"] = common
    return common
