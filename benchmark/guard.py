"""The check that the run loaded neither JAX nor the JAX package.

Modules are compared by their top-level name, the part before the first
dot, whole: ``audio_suite_torch`` passes although it begins with the JAX
package's name.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "audio_suite_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
