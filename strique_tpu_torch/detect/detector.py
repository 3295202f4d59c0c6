"""Multi-locus repeat detection orchestrator.

Equivalent of the reference ``repeatDetector`` (reference
scripts/STRique.py:624-705): decode SAM line, intersect configured loci,
fetch raw signal, run the counter per matching target.  The port's
counterpart of ``strique_tpu/detect/detector.py``: the counter is built
with ``device=`` (a device, or a list that a batch's rows shard
over) where the reference takes ``mesh=``, and the index may
be any object with ``get_raw``.  The reference's ``detect_batch*``
methods, which the dispatcher does not call, are not carried over.
"""
from __future__ import annotations

import threading
from collections import defaultdict

from ..io.fast5 import Fast5Index
from ..io.sam import decode_sam, intersect_targets
from ..utils.logging import LogLevel, log
from .counter import RepeatCounter


class RepeatDetector:
    def __init__(self, repeat_config: dict, model_file: str, fast5_index,
                 mod_model_file: str | None = None, align_config: dict | None = None,
                 hmm_config: dict | None = None, device="cuda"):
        """``fast5_index``: an index file's path, or any object with
        ``get_raw(read_id)`` (raising RuntimeError for an unknown read).
        ``mod_model_file``: the counter's base-modification model (mod
        calling), or None.  ``device``: the counter's ("cuda" by default;
        it raises without a card -- pass "cpu" for the plain PyTorch
        path), or its list of devices (``parallel.mesh.local_devices``)."""
        self.counter = RepeatCounter(model_file, mod_model_file=mod_model_file,
                                     align_config=align_config, hmm_config=hmm_config,
                                     device=device)
        self.repeat_loci = defaultdict(list)
        self.repeat_config = repeat_config
        self.is_init = False
        self._init_lock = threading.Lock()
        self.f5 = (fast5_index if hasattr(fast5_index, "get_raw")
                   else Fast5Index(fast5_index))

    def _init_targets(self) -> None:
        """Lazy HMM construction (reference :642-646); thread-safe — the
        per-read worker pool may race on the first reads."""
        with self._init_lock:
            if self.is_init:
                return
            for target_name, (chrom, begin, end, repeat, prefix, suffix) in self.repeat_config.items():
                self.counter.add_target(target_name, repeat, prefix, suffix)
                self.repeat_loci[chrom].append((target_name, begin, end))
            self.is_init = True

    def _decode_and_fetch(self, sam_line: str):
        """SAM line -> (record, matching targets, raw signal) or None."""
        sr = decode_sam(sam_line)
        if not sr.QNAME:
            log(f"Detector: Error parsing alignment \n{sam_line}", LogLevel.Error)
            return None
        target_names = intersect_targets(sr, self.repeat_loci)
        if not target_names:
            log(f"Detector: No target for {sr.QNAME}", LogLevel.Debug)
            return None
        try:
            raw = self.f5.get_raw(sr.QNAME)
        except RuntimeError:
            raw = None
        if raw is None:
            log(f"Detector: No fast5 for ID {sr.QNAME}", LogLevel.Warning)
            return None
        log(f"Detector: Test {sr.QNAME} for targets: {','.join(target_names)}.", LogLevel.Debug)
        return sr, target_names, raw

    def decode_line(self, sam_line: str):
        """Public decode+fetch for streaming schedulers: SAM line ->
        (record, matching targets, raw signal) or None; initializes the
        HMMs on first use like every other entry point."""
        if not self.is_init:
            self._init_targets()
        return self._decode_and_fetch(sam_line)

    def detect(self, sam_line: str = ""):
        """Process one SAM line -> {'target_counts': [...]} or None
        (reference :681-705)."""
        if not self.is_init:
            self._init_targets()
        job = self._decode_and_fetch(sam_line)
        if job is None:
            return None
        sr, target_names, raw = job
        target_counts = []
        for target_name in target_names:
            result = self.counter.detect(target_name, raw, sr.strand)
            target_counts.append((sr.QNAME, target_name, sr.strand, *result))
        return {"target_counts": target_counts}
