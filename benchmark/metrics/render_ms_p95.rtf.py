"""render_ms_p95.rtf (ms): ``render_ms_p95``, read alike, as a per-layer
metric of the cells that bound ``rtf`` and not ``render_ms_p95``
(``tape-c1-tweak``, where the host's pace between runs spreads the p95
wider than half its bound; ``rtf``, the steadier of the two there, is
its end-to-end metric); it moves ``rtf`` there."""
from benchmark import spec

_base = spec.load_module("metrics", "render_ms_p95")
read = _base.read
