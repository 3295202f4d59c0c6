"""mod_host_ms.card: ``mod_host_ms`` in the cells that report the card's time a row,
``card_us_per_read``, in place of ``reads_per_s``; read by ``mod_host_ms.py``."""
from harness import spec

_base = spec.module("metrics", "mod_host_ms")
LAYER, UNIT, SOURCE, read = _base.LAYER, _base.UNIT, _base.SOURCE, _base.read
KERNELS = getattr(_base, "KERNELS", ())
MOVES = "card_us_per_read"
