"""device_idle_pct.card: ``device_idle_pct`` in the cells that report the card's time a row,
``card_us_per_read``, in place of ``reads_per_s``; read by ``device_idle_pct.py``."""
from harness import spec

_base = spec.module("metrics", "device_idle_pct")
LAYER, UNIT, SOURCE, read = _base.LAYER, _base.UNIT, _base.SOURCE, _base.read
KERNELS = getattr(_base, "KERNELS", ())
MOVES = "card_us_per_read"
