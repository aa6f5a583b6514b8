"""space_kernels_ms.microsound.p95: ``space_kernels_ms.microsound`` (the
``microsound.space_kernels`` span), read alike, in the cells whose
end-to-end metric it moves is ``render_ms_p95`` (``ms-c3-stickslip``)."""
from benchmark import spec

_base = spec.load_module("metrics", "space_kernels_ms.microsound")
read = _base.read
