"""Per-target repeat counting on the split pipeline, in PyTorch.

Counterpart of ``strique_tpu/detect/counter.py``'s default "split"
path, in three phases a caller can overlap across batches:

  1. :meth:`RepeatCounter.detect_submit` -- host prep (the port's
     native library, or NumPy), upload of 1 byte per sample (u8 morph
     bins plus a 256-entry f32 level table per read), the u8 -> f32
     decode as a device gather, both flank alignments
     (``ops.align.align_fused_pair``), tracebacks, segment bounds and
     the QC gate, packed into a 40-byte row per read whose copy to a
     pinned host buffer is queued behind one CUDA event.
  2. :meth:`RepeatCounter.detect_middle` -- waits for that event,
     slices each gated-in read's repeat segment from the host flt
     channel, and queues the Viterbi decode (``ops.viterbi_cuda``) with
     its paths' copy to pinned memory behind a second event.
  3. :meth:`RepeatCounter.detect_finish` -- waits for the paths and
     decodes counts and the float64 log_p on the host.

Results are ``(n, score_prefix, score_suffix, log_p, offset, ticks,
mod)`` tuples, as the reference returns them.  Not ported yet, and
raising ``NotImplementedError``: the mod model and the fused single
dispatch (``STRIQUE_SPLIT=0``).

Ultra-long reads (a bucket whose width-8 pointer plane exceeds
``ops.align_cuda.ptr_budget_bytes``; ``STRIQUE_PTR_BUDGET_GB``
overrides it) reach the checkpointed two-pass alignment through the
same calls: ``align_fused_pair`` declines fusion past the budget and
``align_core`` routes the bucket to ``align_longread_sharded``.  The
reference needs an eager twin of its jitted bounds pipeline for that
route (its ``_bounds_eager``); the port runs eagerly throughout, so
it has none.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as native_lib
from ..hmm.models import build_flanked_repeat
from ..ops import signal as signal_ops
from ..ops import viterbi as viterbi_ops
from ..ops.align import align_fused_pair
from ..ops.align_cuda import CHUNK as ALIGN_CHUNK
from ..ops.bounds import segment_bounds
from ..ops.prep import model_const
from ..ops.reference import AlignParams
from ..ops.viterbi_cuda import CHUNK_T, PaddedHMM, viterbi_batch
from ..pore_model import PoreModel, mean_abs_dev
from .packed import pack_meta, path_itemsize, unpack_meta

DEFAULT_ALIGN_CONFIG = {
    # reference scripts/STRique.py:507-513
    "dist_offset": 16.0,
    "dist_min": 0.0,
    "gap_open_h": -1.0,
    "gap_open_v": -16.0,
    "gap_extension_h": -1.0,
    "gap_extension_v": -16.0,
    "samples": 6,
}

_COMPLEMENT = str.maketrans("ACGT", "TGCA")
_LUT_LEVELS = 256


def _morph_buf_bytes(npad: int) -> int:
    """Upload row size: [LUT f32 | morph u8] -- 1 byte per sample."""
    return 4 * _LUT_LEVELS + npad


def _unpack_morph_upload(buf: torch.Tensor) -> torch.Tensor:
    """Uploaded (B, _morph_buf_bytes(npad)) uint8 rows -> (B, npad) f32 morph."""
    lut = buf[:, : 4 * _LUT_LEVELS].contiguous().view(torch.float32)
    idx = buf[:, 4 * _LUT_LEVELS :].to(torch.int64)
    return torch.gather(lut, 1, idx)


def reverse_complement(sequence: str) -> str:
    return sequence.upper().translate(_COMPLEMENT)[::-1]


def pad_bucket(n: int, minimum: int = 2048) -> int:
    """Static-shape bucket for a length: the {1, 1.25, 1.5, 1.75} x 2^k grid."""
    n = max(int(n), minimum)
    k = int(np.floor(np.log2(n)))
    base = 1 << k
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        if n <= base * frac:
            return int(base * frac)
    return base * 2


def signal_bucket(n: int) -> int:
    """Padded signal length of a read of ``n`` samples (the reference's grid)."""
    npad = pad_bucket(int(n))
    npad = (npad + ALIGN_CHUNK - 1) // ALIGN_CHUNK * ALIGN_CHUNK
    return (npad + CHUNK_T - 1) // CHUNK_T * CHUNK_T


@dataclass
class TargetClassifier:
    """Per-strand detection assets."""

    prefix: np.ndarray  # core flank template signals
    suffix: np.ndarray
    prefix_ext: np.ndarray  # extended flank template signals
    suffix_ext: np.ndarray
    repeat_hmm: object  # CompiledHMM
    mod_hmm: object | None


class RepeatCounter:
    def __init__(self, model_file: str, mod_model_file: str | None = None,
                 align_config: dict | None = None, hmm_config: dict | None = None,
                 device="cuda"):
        """``device``: where the kernels run; "cuda" (default) raises when
        no card is present -- there is no silent CPU fallback."""
        if mod_model_file is not None:
            raise NotImplementedError("mod calling is not ported yet (ROADMAP)")
        if os.environ.get("STRIQUE_SPLIT", "1") == "0":
            raise NotImplementedError(
                "only the split pipeline is ported; the fused dispatch (STRIQUE_SPLIT=0) is not")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("RepeatCounter(device='cuda') needs a CUDA device; "
                                   "pass device='cpu' for the plain PyTorch path")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        cfg = dict(DEFAULT_ALIGN_CONFIG)
        if align_config:
            cfg.update(align_config)
        self.align_params = AlignParams(
            dist_offset=cfg["dist_offset"], dist_min=cfg["dist_min"],
            gap_open_h=cfg["gap_open_h"], gap_open_v=cfg["gap_open_v"],
            gap_extension_h=cfg["gap_extension_h"], gap_extension_v=cfg["gap_extension_v"],
        )
        self.samples = int(cfg["samples"])
        self.pm = PoreModel(model_file)
        self.hmm_config = hmm_config
        self.targets: dict[str, tuple[TargetClassifier, TargetClassifier]] = {}
        self._hmm_cache: dict = {}
        self._pool = None
        self._init_lock = threading.RLock()

    # -- model construction ------------------------------------------------
    def add_target(self, target_name: str, repeat: str, prefix: str, suffix: str) -> None:
        """Build flank templates + HMMs for both strands."""
        if target_name in self.targets:
            raise ValueError(f"target {target_name!r} already defined")
        prefix_ext = prefix.upper()
        prefix = prefix[-50:].upper()
        suffix_ext = suffix.upper()
        suffix = suffix[:50].upper()
        repeat = repeat.upper()
        gen = lambda seq: self.pm.generate_signal(seq, samples=self.samples).astype(np.float32)
        tc_plus = TargetClassifier(
            gen(prefix), gen(suffix), gen(prefix_ext), gen(suffix_ext),
            build_flanked_repeat(repeat, prefix, suffix, self.pm, self.hmm_config), None)
        rc = reverse_complement
        tc_minus = TargetClassifier(
            gen(rc(suffix)), gen(rc(prefix)), gen(rc(suffix_ext)), gen(rc(prefix_ext)),
            build_flanked_repeat(rc(repeat), rc(suffix), rc(prefix), self.pm, self.hmm_config),
            None)
        self.targets[target_name] = (tc_plus, tc_minus)

    def _padded_hmm(self, chm) -> PaddedHMM:
        with self._init_lock:
            key = id(chm)
            if key not in self._hmm_cache:
                self._hmm_cache[key] = PaddedHMM(chm, self.device)
            return self._hmm_cache[key]

    def _prep_pool(self):
        with self._init_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8))
        return self._pool

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """Zeroed host staging tensor, pinned when the device is a card."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _to_host(self, x: torch.Tensor):
        """Queue a D2H copy of ``x``; returns (host tensor, event or None)."""
        if self.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # -- detection ---------------------------------------------------------
    def detect(self, target_name: str, raw_signal: np.ndarray, strand: str):
        """Count repeats in one read: (n, score_prefix, score_suffix, log_p,
        offset, ticks, mod)."""
        return self.detect_many(target_name, [raw_signal], strand)[0]

    def detect_many(self, target_name: str, raw_signals, strand: str):
        return self.detect_finish(self.detect_submit(target_name, raw_signals, strand))

    def detect_submit(self, target_name: str, raw_signals, strand: str,
                      preps=None) -> dict:
        """Phase 1: host prep, upload and the bounds pipeline (returns a handle).

        ``preps``: optional per-read share tokens (dicts); a read shared
        by several targets preps once and later batches reuse its LUT,
        morph bins and flt channel (prep is target- and strand-free).
        """
        tc_plus, tc_minus = self.targets[target_name]
        if strand == "+":
            tc = tc_plus
        elif strand == "-":
            tc = tc_minus
        else:
            raise ValueError("strand must be + or -")
        B = len(raw_signals)
        raws = [np.asarray(r, dtype=np.float64) for r in raw_signals]
        n_sigs = np.array([len(r) for r in raws], dtype=np.int32)
        npad = signal_bucket(int(n_sigs.max()))
        # pad to a multiple of 8 rows (dummies: length-1 reads, gated out)
        Bp = -(-B // 8) * 8
        n_sigs_p = np.ones(Bp, dtype=np.int32)
        n_sigs_p[:B] = n_sigs
        return self._split_submit(tc, raws, n_sigs_p, npad, Bp,
                                  native_lib.available(), preps=preps)

    def _split_submit(self, tc, raws, n_sigs_p, npad, Bp,
                      have_native: bool, preps=None) -> dict:
        upload = self._host_buffer((Bp, _morph_buf_bytes(npad)), torch.uint8)
        buf = upload.numpy()
        flt32s: list = [None] * len(raws)
        flts: list = [None] * len(raws)

        def _token(i):
            return preps[i] if preps is not None and i < len(preps) else None

        def _from_token(i, row):
            tok = _token(i)
            if tok is None or "prep" not in tok:
                return False
            lutb, qb, flt32, flt64 = tok["prep"]
            row[: 4 * _LUT_LEVELS] = np.frombuffer(lutb, np.uint8)
            row[4 * _LUT_LEVELS : 4 * _LUT_LEVELS + len(qb)] = np.frombuffer(qb, np.uint8)
            flt32s[i] = flt32
            flts[i] = flt64
            return True

        def _to_token(i, row, n):
            tok = _token(i)
            if tok is not None:
                tok["prep"] = (bytes(row[: 4 * _LUT_LEVELS]),
                               bytes(row[4 * _LUT_LEVELS : 4 * _LUT_LEVELS + n]),
                               flt32s[i], flts[i])

        if have_native:
            mc = model_const(self.pm)

            def _prep_row(i_raw):
                i, raw = i_raw
                n = len(raw)
                row = buf[i]
                if _from_token(i, row):
                    return
                lut = row[: 4 * _LUT_LEVELS].view(np.float32)
                q = row[4 * _LUT_LEVELS :][:n]
                flt32 = np.empty(n, np.float32)
                flt64 = native_lib.preprocess_read_lut(raw, mc, flt32, q, lut)
                flt32s[i] = flt32
                flts[i] = flt64
                _to_token(i, row, n)

            list(self._prep_pool().map(_prep_row, enumerate(raws)))
        else:
            for i, raw in enumerate(raws):
                row = buf[i]
                if _from_token(i, row):
                    continue
                flt = signal_ops.medfilt3(raw)
                bins = signal_ops.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt))
                bins = signal_ops.open_close_np(bins)
                row[4 * _LUT_LEVELS :][: len(raw)] = bins.astype(np.uint8)
                aff = self.pm.norm_params(bins, mode="minmax")
                lut64 = np.clip(np.arange(_LUT_LEVELS, dtype=np.float64)
                                * aff.scale + aff.offset, aff.lo, aff.hi)
                row[: 4 * _LUT_LEVELS].view(np.float32)[:] = lut64.astype(np.float32)
                flt_n = self.pm.normalize2model(flt, mode="minmax")
                flts[i] = flt_n
                flt32s[i] = flt_n.astype(np.float32)
                _to_token(i, row, len(raw))

        dev = self.device
        morph = _unpack_morph_upload(upload.to(dev, non_blocking=True))
        n_dev = torch.from_numpy(n_sigs_p).to(dev, non_blocking=True)
        pre, suf = align_fused_pair(morph, n_dev, tc.prefix_ext, tc.suffix_ext,
                                    self.align_params)
        b = segment_bounds(pre, suf, n_dev,
                           trim_prefix=len(tc.prefix_ext) - len(tc.prefix),
                           trim_suffix=len(tc.suffix_ext) - len(tc.suffix))
        meta_host, ev = self._to_host(pack_meta(b))
        # the pinned upload buffer stays referenced until the batch finishes:
        # its non_blocking copy may still be in flight
        return {"bounds_host": meta_host, "bounds_event": ev, "upload": upload,
                "tc": tc, "flts": flts, "flt32s": flt32s, "B": len(raws)}

    def detect_middle(self, state: dict) -> dict:
        """Phase 2: wait for the bounds rows, dispatch Viterbi on the segments.

        Idempotent, so schedulers may call it unconditionally.
        """
        if "bounds" in state:
            return state
        tc = state["tc"]
        B = state["B"]
        if state["bounds_event"] is not None:
            state["bounds_event"].synchronize()
        rows = unpack_meta(state["bounds_host"].numpy()[:B])
        bounds = [(r.ok, r.score_prefix, r.score_suffix, r.prefix_begin,
                   r.prefix_end, r.suffix_begin, r.suffix_end) for r in rows]
        live = [i for i in range(B) if rows[i].ok]
        state["bounds"] = bounds
        state["live"] = live
        if live:
            segs = [state["flt32s"][i][bounds[i][3]:bounds[i][6]] for i in live]
            state["vit"] = self._viterbi_submit(tc.repeat_hmm, segs)
        return state

    def decode_bounds(self, state: dict):
        """(bounds, paths, seg_lens) of a submit handle; cached on the state.

        bounds[i] = (ok, score_prefix, score_suffix, prefix_begin,
        prefix_end, suffix_begin, suffix_end); paths/seg_lens keyed by
        read index for gated-in reads.
        """
        if "decoded" not in state:
            state = self.detect_middle(state)
            bounds = state["bounds"]
            paths, seg_lens = {}, {}
            if state["live"]:
                mat = self._viterbi_collect(state["vit"])
                for k, i in enumerate(state["live"]):
                    paths[i] = mat[k]
                    seg_lens[i] = bounds[i][6] - bounds[i][3]
            state["decoded"] = (bounds, paths, seg_lens)
        return state["decoded"]

    def _main_results(self, state: dict) -> list:
        """Result rows (n, scores, log_p, offset, ticks, '-')."""
        tc = state["tc"]
        flts = state["flts"]
        bounds, paths, seg_lens = self.decode_bounds(state)
        results = []
        for i in range(state["B"]):
            ok, score_prefix, score_suffix, prefix_begin, prefix_end, suffix_begin, suffix_end = bounds[i]
            n = 0
            p = 0.0
            if ok:
                path = paths[i]
                segment = flts[i][prefix_begin:suffix_end]
                n = viterbi_ops.count_repeats(path, seg_lens[i], tc.repeat_hmm)
                p = viterbi_ops.path_logp_f64(segment, path, tc.repeat_hmm)
            results.append((n, score_prefix, score_suffix, p, prefix_end,
                            max(suffix_begin - prefix_end, 0), "-"))
        return results

    def detect_finish(self, state: dict):
        """Phase 3: collect the paths and decode the result tuples on the host."""
        return self._main_results(state)

    def _viterbi_submit(self, chm, segments) -> dict:
        """Queue the Viterbi decode of ``segments``; returns a collect handle."""
        lens = np.array([len(s) for s in segments], dtype=np.int32)
        B = len(segments)
        Bp = -(-B // 8) * 8
        lens_p = np.ones(Bp, dtype=np.int32)
        lens_p[:B] = lens
        tpad = max(-(-int(lens.max()) // CHUNK_T) * CHUNK_T, CHUNK_T)
        obs_host = self._host_buffer((Bp, tpad), torch.float32)
        obs = obs_host.numpy()
        for k, s in enumerate(segments):
            obs[k, : len(s)] = s
        dev = self.device
        _, paths = viterbi_batch(obs_host.to(dev, non_blocking=True),
                                 torch.from_numpy(lens_p).to(dev, non_blocking=True),
                                 self._padded_hmm(chm))
        if path_itemsize(chm.n_states) == 1:
            paths = paths.to(torch.uint8)  # 1 byte per entry for <= 256 states
        host, ev = self._to_host(paths)
        return {"paths": host, "event": ev, "B": B, "obs": obs_host}

    def _viterbi_collect(self, handle) -> np.ndarray:
        """Wait for a :meth:`_viterbi_submit` handle; (B, Tpad) int32 paths."""
        if handle["event"] is not None:
            handle["event"].synchronize()
        return handle["paths"].numpy()[: handle["B"]].astype(np.int32)
