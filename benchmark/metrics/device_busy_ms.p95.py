"""device_busy_ms.p95: ``device_busy_ms``, read alike, in the cells whose
end-to-end metric it moves is ``render_ms_p95`` rather than ``rtf``
(``ms-c3-stickslip``, where the host's drift spreads ``rtf`` wider than
any bound may be)."""
from benchmark import spec

_base = spec.load_module("metrics", "device_busy_ms")
read = _base.read
