"""cap_flush_pct.card: ``cap_flush_pct`` in the cells that report the card's time a row,
``card_us_per_read``, in place of ``reads_per_s``; read by ``cap_flush_pct.py``."""
from harness import spec

_base = spec.module("metrics", "cap_flush_pct")
LAYER, UNIT, SOURCE, read = _base.LAYER, _base.UNIT, _base.SOURCE, _base.read
KERNELS = getattr(_base, "KERNELS", ())
MOVES = "card_us_per_read"
