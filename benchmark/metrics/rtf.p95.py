"""rtf.p95 (audio_s/s): ``rtf``, read alike, as a per-layer metric of the
cells that bound ``render_ms_p95`` and not ``rtf`` (``ms-c3-stickslip``,
where the host's drift spreads ``rtf`` wider than any bound may be); it
moves ``render_ms_p95`` there."""
from benchmark import spec

_base = spec.load_module("metrics", "rtf")
read = _base.read
