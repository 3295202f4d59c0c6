"""Per-target repeat counting in PyTorch: the split pipeline, the fused
single dispatch and the two-phase host-bounds path.

Counterpart of ``strique_tpu/detect/counter.py``.  Its default "split"
path runs in three phases a caller can overlap across batches:

  1. :meth:`RepeatCounter.detect_submit` -- host prep (the port's
     native library, or NumPy), upload of 1 byte per sample (u8 morph
     bins plus a 256-entry f32 level table per read), both flank
     alignments on those bins and tables (``ops.align.align_fused_pair``
     in morph form: the TABLE score mode of the wave kernel, of the
     two-pass route's and of the column route's), tracebacks, segment
     bounds and the QC gate, packed into a 40-byte row per read whose
     copy to a pinned host buffer is queued behind one CUDA event.
  2. :meth:`RepeatCounter.detect_middle` -- waits for that event,
     slices each gated-in read's repeat segment from the host flt
     channel, and queues the Viterbi decode (``ops.viterbi_cuda``) with
     its paths' copy to pinned memory behind a second event.
  3. :meth:`RepeatCounter.detect_finish` -- waits for the paths and
     decodes counts and the float64 log_p on the host.

Two more routes, as in the reference:

  * the fused single dispatch (``STRIQUE_SPLIT=0``, or ``split =
    False``): one upload row a read, ``[flt f32 | LUT f32 | morph u8]``;
    both flank alignments, bounds, a per-row shift of the flt channel to
    each read's repeat segment, the Viterbi decode over the whole row
    (``t_actual`` = the segment length) and :func:`packed.pack_results`,
    whose one copy to pinned memory sits behind one CUDA event; phase 2
    is a no-op.  The decode's score plane is (npad, rows, SP) f32: a
    call takes :func:`fused_viterbi_rows` reads, and a bucket where 8
    rows exceed the budget, or whose alignment takes the two-pass route,
    runs the split path (logged).
  * the two-phase host-bounds path (``fused = False``, and any repeat
    HMM past ``MAX_FUSED_STATES`` states, logged): one single-template
    alignment a flank (``ops.align.align_core``), the ``[score | jpos |
    is_gap]`` planes copied to the host, bounds and gate in NumPy
    (``_nearest_positions``), then the Viterbi decode of the live
    segments, all in phase 3.

With a mod model (``mod_model_file``), :meth:`RepeatCounter.detect_mod_submit`
sits between 2 and 3 on every route: it collects the paths, cuts each
gated-in read's repeat-state samples from its minmax-normalised raw
signal, queues the mod HMM's Viterbi decode on them (the same kernels:
the factored forward in its diagonal-only slot layout, and the
backward) and decodes the counts on the host while the card runs it; 3
then reads the mod paths into one '0'/'1' character per repeat unit.
Without a mod model it returns its state unchanged, and the stream
scheduler calls it unconditionally.

Several devices (a list as ``device``, the counterpart of the
reference's ``mesh=``): a batch's rows pad to a multiple of the device
count and split into contiguous shards, one a device entry, each
running its device work (and the mod decode) on its own device and CUDA
stream; the rows come back in order, so the results are the single
device's.  A batch past the pointer budget splits the same way, each
shard running its own two-pass groups on its device.  The model's HMM
tensors are kept per device.

Results are ``(n, score_prefix, score_suffix, log_p, offset, ticks,
mod)`` tuples, as the reference returns them (``mod`` is '-' without a
mod model or for a read the gate drops).

Ultra-long reads (a bucket whose width-8 pointer plane exceeds
``ops.align_cuda.ptr_budget_bytes``; ``STRIQUE_PTR_BUDGET_GB``
overrides it) reach the checkpointed two-pass alignment through the
same calls: past the budget ``align_fused_pair`` runs both flanks'
two-pass routes as one row stream on the card, and on the CPU
``align_core`` routes each flank to ``align_longread_sharded``.  The
reference needs an eager twin of its jitted bounds pipeline for that
route (its ``_bounds_eager``); the port runs eagerly throughout, so
it has none.

Two knobs of the reference are honoured, through the same calls:

  * ``STRIQUE_ALIGN_KERNEL=col`` -- ``align_core`` (read per call) runs
    the column-sweep kernel and the column-layout traceback instead of
    the wave kernel; a partial batch that ``align_fused_pair`` fuses
    stays on the per-row-template wave kernel, as in the reference.
  * ``STRIQUE_DENSE_VITERBI=1`` -- read when the counter first stages
    an HMM (``PaddedHMM``, cached per counter): the decode, the mod
    HMM's too, runs the dense forward over the full transition matrix
    instead of the factored one.  HMMs that ``hmm/factor.py`` declines
    take it always.
"""
from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as native_lib
from ..hmm.models import build_flanked_repeat, build_repeat_mod
from ..ops import signal as signal_ops
from ..ops import viterbi as viterbi_ops
from ..ops.align import _nearest_positions, align_core, align_fused_pair, takes_two_pass
from ..ops.align_cuda import CHUNK as ALIGN_CHUNK
from ..ops.align_cuda import LANE, _round_up, ptr_budget_bytes
from ..ops.bounds import segment_bounds
from ..ops.prep import model_const
from ..ops.reference import AlignParams
from ..ops.viterbi_cuda import (CHUNK_T, GROUP, PaddedHMM, check_card_sp, padded_sp,
                                viterbi_batch)
from ..parallel.mesh import on_stream, shard_rows, shard_streams
from ..pore_model import PoreModel, mean_abs_dev
from ..utils import trace
from ..utils.logging import LogLevel, log
from .packed import pack_meta, pack_results, path_itemsize, unpack_meta, unpack_results

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

# u16 path packing bounds the fused route; past it (never for real repeat
# HMMs) the two-phase host-bounds path takes over, as in the reference
MAX_FUSED_STATES = 65536


def _morph_buf_bytes(npad: int) -> int:
    """Upload row size: [LUT f32 | morph u8] -- 1 byte per sample."""
    return 4 * _LUT_LEVELS + npad


def _buf_bytes(npad: int) -> int:
    """Fused upload row size: [flt f32 | LUT f32 | morph u8]."""
    return 4 * npad + _morph_buf_bytes(npad)


def _split_morph_upload(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uploaded (B, _morph_buf_bytes(npad)) uint8 rows -> ((B, npad) u8
    morph bins, (B, 256) f32 level tables), both contiguous."""
    lut = buf[:, : 4 * _LUT_LEVELS].contiguous().view(torch.float32)
    return buf[:, 4 * _LUT_LEVELS :].contiguous(), lut


def _split_fused_upload(buf: torch.Tensor, npad: int):
    """Uploaded (B, _buf_bytes(npad)) uint8 rows -> ((B, npad) f32 flt,
    (B, npad) u8 morph bins, (B, 256) f32 level tables)."""
    flt = buf[:, : 4 * npad].contiguous().view(torch.float32)
    bins, lut = _split_morph_upload(buf[:, 4 * npad :])
    return flt, bins, lut


def fused_viterbi_rows(npad: int, n_states: int, device) -> int:
    """Reads per Viterbi call on the fused route: the most, in multiples
    of 8 up to ``viterbi_cuda.GROUP``, whose (npad, rows, SP) f32 score
    plane fits ``ptr_budget_bytes(device)`` (the budget of one call's
    largest plane: 60% of the card's free memory, or
    ``STRIQUE_PTR_BUDGET_GB``); 0 when 8 rows do not fit."""
    per8 = npad * 8 * padded_sp(n_states) * 4
    return int(min(ptr_budget_bytes(device) // per8, GROUP // 8)) * 8


def _shift_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Row i of ``x`` rolled left by ``shift[i]`` (the reference's
    ``jnp.roll(x, -s)``), as one gather."""
    n = x.shape[1]
    idx = (torch.arange(n, device=x.device)[None, :] + shift.to(torch.int64)[:, None]) % n
    return x.gather(1, idx)


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
        no card is present -- there is no silent CPU fallback.  A list of
        devices (all of one kind, a device possibly repeated;
        ``parallel.mesh.local_devices``) shards each batch's rows over
        them; ``self.device`` is its first entry.
        ``mod_model_file``: the base-modification pore model; each target
        then also gets the mod HMM of its repeat unit on both strands."""
        listed = device if isinstance(device, (list, tuple)) else [device]
        self.devices = [torch.device(d) for d in listed]
        self.device = self.devices[0]
        if any(d.type != self.device.type for d in self.devices):
            raise ValueError(f"devices of one kind only, got {self.devices}")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("RepeatCounter(device='cuda') needs a CUDA device; "
                                   "pass device='cpu' for the plain PyTorch path")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self._streams = shard_streams(self.devices)
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
        self.pm_mod = PoreModel(mod_model_file) if mod_model_file else self.pm
        self.has_mod = mod_model_file is not None
        self.hmm_config = hmm_config
        self.targets: dict[str, tuple[TargetClassifier, TargetClassifier]] = {}
        self._hmm_cache: dict = {}
        self._pool = None
        self._init_lock = threading.RLock()
        # fused: the single dispatch (bounds, segment shift and Viterbi on
        # the device, one packed D2H); off, the two-phase host-bounds path.
        # split (default; STRIQUE_SPLIT=0 turns it off): the three-phase
        # pipeline, which ships 1 byte a sample and decodes segments only
        self.fused = True
        self.split = os.environ.get("STRIQUE_SPLIT", "1") != "0"

    # -- model construction ------------------------------------------------
    def add_target(self, target_name: str, repeat: str, prefix: str, suffix: str) -> None:
        """Build flank templates + HMMs for both strands (and the mod HMMs
        of the repeat and its reverse complement with a mod model).

        On the card an HMM wider than the Viterbi kernels take
        (``viterbi_cuda.MAX_SP`` padded states; the reference's chip path
        stops earlier) is refused here, as soon as it is built, with a
        ValueError naming the limit; ``device='cpu'`` takes any width."""
        if target_name in self.targets:
            raise ValueError(f"target {target_name!r} already defined")
        prefix_ext = prefix.upper()
        prefix = prefix[-50:].upper()
        suffix_ext = suffix.upper()
        suffix = suffix[:50].upper()
        repeat = repeat.upper()
        gen = lambda seq: self.pm.generate_signal(seq, samples=self.samples).astype(np.float32)

        def checked(chm):
            if chm is not None:
                check_card_sp(chm.n_states, self.device)
            return chm

        def hmms(unit, pre, suf):
            rep = checked(build_flanked_repeat(unit, pre, suf, self.pm, self.hmm_config))
            mod = (checked(build_repeat_mod(unit, self.pm, self.pm_mod, self.hmm_config))
                   if self.has_mod else None)
            return rep, mod

        tc_plus = TargetClassifier(gen(prefix), gen(suffix), gen(prefix_ext), gen(suffix_ext),
                                   *hmms(repeat, prefix, suffix))
        rc = reverse_complement
        tc_minus = TargetClassifier(
            gen(rc(suffix)), gen(rc(prefix)), gen(rc(suffix_ext)), gen(rc(prefix_ext)),
            *hmms(rc(repeat), rc(suffix), rc(prefix)))
        self.targets[target_name] = (tc_plus, tc_minus)

    def _padded_hmm(self, chm, device=None) -> PaddedHMM:
        """``chm``'s lane-padded tensors on ``device`` (default the first
        device), built once a device."""
        dev = self.device if device is None else torch.device(device)
        with self._init_lock:
            key = (id(chm), dev)
            if key not in self._hmm_cache:
                self._hmm_cache[key] = PaddedHMM(chm, dev)
            return self._hmm_cache[key]

    def _pad_rows(self, B: int) -> int:
        """Rows of a B-read batch: a multiple of 8 and of the device count
        (dummies: length-1 reads, gated out), as the reference pads for
        its mesh."""
        step = 8 * len(self.devices) // math.gcd(8, len(self.devices))
        return -(-B // step) * step

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
        """Queue a D2H copy of ``x`` on the current stream; returns (host
        tensor, event or None)."""
        if self.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _from_host(parts) -> torch.Tensor:
        """Wait for :meth:`_to_host` parts; their host tensors in order."""
        for _host, ev in parts:
            if ev is not None:
                ev.synchronize()
        hosts = [h for h, _ev in parts]
        return hosts[0] if len(hosts) == 1 else torch.cat(hosts)

    # -- detection ---------------------------------------------------------
    def detect(self, target_name: str, raw_signal: np.ndarray, strand: str):
        """Count repeats in one read: (n, score_prefix, score_suffix, log_p,
        offset, ticks, mod)."""
        return self.detect_many(target_name, [raw_signal], strand)[0]

    def detect_many(self, target_name: str, raw_signals, strand: str):
        return self.detect_finish(self.detect_submit(target_name, raw_signals, strand))

    def detect_submit(self, target_name: str, raw_signals, strand: str,
                      preps=None) -> dict:
        """Phase 1: host prep, upload and the device work of the batch's
        route (returns a handle).

        The route is the reference's: the split path by default; with
        ``split`` off the fused dispatch, unless the bucket's alignment
        takes the two-pass route or 8 rows of its Viterbi score plane
        exceed the budget (:func:`fused_viterbi_rows`); with ``fused``
        off, or a repeat HMM past ``MAX_FUSED_STATES``, the two-phase
        host-bounds path.  ``preps``: optional per-read share tokens
        (dicts) of the split and two-phase paths; a read shared by
        several targets preps once and later batches reuse its LUT,
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
        with trace.span("submit.prep"):  # the reads' float64 copies, every route's
            raws = [np.asarray(r, dtype=np.float64) for r in raw_signals]
        n_sigs = np.array([len(r) for r in raws], dtype=np.int32)
        npad = signal_bucket(int(n_sigs.max()))
        Bp = self._pad_rows(B)
        n_sigs_p = np.ones(Bp, dtype=np.int32)
        n_sigs_p[:B] = n_sigs
        if trace.enabled():
            trace.count("submit.samples", int(n_sigs.sum()))
            trace.count("submit.padded", Bp * npad)
        have_native = native_lib.available()
        n_states = tc.repeat_hmm.n_states
        fusible = self.fused and n_states <= MAX_FUSED_STATES
        if self.fused and not fusible:
            log(f"Counter: repeat HMM has {n_states} states (> {MAX_FUSED_STATES}); "
                f"using the two-phase host-bounds path.", LogLevel.Info)
        if not fusible:
            return self._two_phase_submit(tc, raws, n_sigs_p, npad, Bp, have_native, preps)
        if not self.split:
            mp = _round_up(max(len(tc.prefix_ext), len(tc.suffix_ext)) + 1, LANE)
            rows = fused_viterbi_rows(npad, n_states, self.device)
            if takes_two_pass(npad, mp, self.device):
                log(f"Counter: bucket {npad} takes the two-pass alignment; using the split "
                    f"path.", LogLevel.Info)
            elif not rows:
                log(f"Counter: the fused Viterbi's score plane ({npad} x 8 x "
                    f"{padded_sp(n_states)} f32) exceeds the budget; using the split path.",
                    LogLevel.Info)
            else:
                return self._fused_submit(tc, raws, n_sigs_p, npad, Bp, have_native, rows)
        return self._split_submit(tc, raws, n_sigs_p, npad, Bp, have_native, preps=preps)

    def _prep_morph(self, raws, npad, Bp, have_native: bool, preps=None):
        """Host prep into a (Bp, _morph_buf_bytes(npad)) upload buffer
        (pinned on a card): returns (upload, flts f64, flt32s)."""
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
        return upload, flts, flt32s

    def _split_submit(self, tc, raws, n_sigs_p, npad, Bp,
                      have_native: bool, preps=None) -> dict:
        with trace.span("submit.prep"):
            upload, flts, flt32s = self._prep_morph(raws, npad, Bp, have_native, preps)
        parts = []
        for k, sl in enumerate(shard_rows(Bp, len(self.devices))):
            dev = self.devices[k]
            with on_stream(self._streams[k]):
                with trace.span("submit.upload"):
                    bins, lut = _split_morph_upload(upload[sl].to(dev, non_blocking=True))
                    n_dev = torch.from_numpy(n_sigs_p[sl]).to(dev, non_blocking=True)
                with trace.span("submit.align") as sp:
                    if sp:
                        sp.attrs.update(route="split", rows=sl.stop - sl.start, bucket=npad)
                    pre, suf = align_fused_pair(bins, n_dev, tc.prefix_ext, tc.suffix_ext,
                                                self.align_params, lut=lut)
                with trace.span("submit.bounds"):
                    b = segment_bounds(pre, suf, n_dev,
                                       trim_prefix=len(tc.prefix_ext) - len(tc.prefix),
                                       trim_suffix=len(tc.suffix_ext) - len(tc.suffix))
                    parts.append(self._to_host(pack_meta(b)))
        # the pinned upload buffer stays referenced until the batch finishes:
        # its non_blocking copies may still be in flight
        return {"bounds_parts": parts, "upload": upload,
                "tc": tc, "raws": raws, "flts": flts, "flt32s": flt32s, "B": len(raws)}

    def _fused_submit(self, tc, raws, n_sigs_p, npad, Bp, have_native: bool,
                      rows: int) -> dict:
        """The fused dispatch: one upload row a read, the whole device
        pipeline, one packed copy back behind one event a shard.

        With the native library a row is ``[flt f32 | LUT f32 | morph
        u8]`` and the flanks align on the bins and table; the NumPy prep
        uploads f32 morph and flt channels and aligns on the f32 morph,
        as the reference's ``use_buf=False`` pipeline does.  ``rows``:
        reads per Viterbi call (:func:`fused_viterbi_rows`)."""
        B = len(raws)
        n_states = tc.repeat_hmm.n_states
        flts: list = [None] * B
        with trace.span("submit.prep"):
            if have_native:
                mc = model_const(self.pm)
                upload = self._host_buffer((Bp, _buf_bytes(npad)), torch.uint8)
                buf = upload.numpy()

                def _prep_row(i_raw):
                    i, raw = i_raw
                    n = len(raw)
                    row = buf[i]
                    flt32 = row[: 4 * npad].view(np.float32)[:n]
                    lut = row[4 * npad : 4 * npad + 4 * _LUT_LEVELS].view(np.float32)
                    q = row[4 * npad + 4 * _LUT_LEVELS :][:n]
                    flts[i] = native_lib.preprocess_read_lut(raw, mc, flt32, q, lut)

                list(self._prep_pool().map(_prep_row, enumerate(raws)))
            else:
                upload = self._host_buffer((2, Bp, npad), torch.float32)
                both = upload.numpy()
                for i, raw in enumerate(raws):
                    flt = signal_ops.medfilt3(raw)
                    morph = signal_ops.quantize_morph_np(flt, float(np.median(flt)),
                                                         mean_abs_dev(flt))
                    morph = signal_ops.open_close_np(morph)
                    both[0, i, : len(raw)] = self.pm.normalize2model(morph, mode="minmax")
                    flts[i] = self.pm.normalize2model(flt, mode="minmax")
                    both[1, i, : len(raw)] = flts[i]
        parts = []
        for k, sl in enumerate(shard_rows(Bp, len(self.devices))):
            dev = self.devices[k]
            with on_stream(self._streams[k]):
                with trace.span("submit.upload"):
                    if have_native:
                        flt, sig, lut = _split_fused_upload(
                            upload[sl].to(dev, non_blocking=True), npad)
                    else:
                        both_d = upload[:, sl].to(dev, non_blocking=True)
                        sig, flt, lut = both_d[0], both_d[1], None
                    n_dev = torch.from_numpy(n_sigs_p[sl]).to(dev, non_blocking=True)
                with trace.span("submit.align") as sp:
                    if sp:
                        sp.attrs.update(route="fused", rows=sl.stop - sl.start, bucket=npad)
                    pre, suf = align_fused_pair(sig, n_dev, tc.prefix_ext, tc.suffix_ext,
                                                self.align_params, lut=lut)
                with trace.span("submit.bounds"):
                    b = segment_bounds(pre, suf, n_dev,
                                       trim_prefix=len(tc.prefix_ext) - len(tc.prefix),
                                       trim_suffix=len(tc.suffix_ext) - len(tc.suffix))
                with trace.span("submit.viterbi"):
                    _, paths = viterbi_batch(_shift_rows(flt, b["prefix_begin"]),
                                             b["seg_len"],
                                             self._padded_hmm(tc.repeat_hmm, dev), group=rows)
                    parts.append(self._to_host(pack_results(b, paths, n_states)))
        return {"fused_parts": parts, "upload": upload, "tc": tc, "raws": raws, "flts": flts,
                "B": B}

    def _two_phase_submit(self, tc, raws, n_sigs_p, npad, Bp, have_native: bool,
                          preps=None) -> dict:
        """The two-phase host-bounds path's device half: one single-template
        alignment a flank on the morph upload (``align_core``: row 1 on
        the card, row 8 under ``STRIQUE_ALIGN_KERNEL=col``), the
        ``[score | jpos | is_gap]`` planes of both flanks as f32 copied
        back behind one event a shard."""
        with trace.span("submit.prep"):
            upload, flts, _ = self._prep_morph(raws, npad, Bp, have_native, preps)
        parts = []
        for k, sl in enumerate(shard_rows(Bp, len(self.devices))):
            dev = self.devices[k]
            with on_stream(self._streams[k]):
                with trace.span("submit.upload"):
                    bins, lut = _split_morph_upload(upload[sl].to(dev, non_blocking=True))
                    n_dev = torch.from_numpy(n_sigs_p[sl]).to(dev, non_blocking=True)
                planes = []
                with trace.span("submit.align") as sp:
                    if sp:
                        sp.attrs.update(route="two_phase", rows=sl.stop - sl.start, bucket=npad)
                    for tmpl in (tc.prefix_ext, tc.suffix_ext):
                        a = align_core(bins, n_dev, tmpl, self.align_params, lut=lut)
                        planes += [a["score"][:, None], a["jpos"].to(torch.float32),
                                   a["is_gap"].to(torch.float32)]
                with trace.span("submit.bounds"):
                    parts.append(self._to_host(torch.cat(planes, dim=1)))
        return {"planes_parts": parts, "upload": upload, "tc": tc, "raws": raws, "flts": flts,
                "B": len(raws)}

    def _two_phase_bounds(self, state: dict) -> list:
        """Bounds and gate of a two-phase state on the host, from its
        flank planes (the reference's loop)."""
        tc = state["tc"]
        mp_, ms_ = len(tc.prefix_ext), len(tc.suffix_ext)
        trim_prefix = len(tc.prefix_ext) - len(tc.prefix)
        trim_suffix = len(tc.suffix_ext) - len(tc.suffix)
        with trace.span("finish.wait"):
            packed = self._from_host(state["planes_parts"]).numpy()[: state["B"]]
        o = 0
        pre_score = packed[:, o]; o += 1
        pre_jpos = packed[:, o : o + mp_].astype(np.int64); o += mp_
        pre_gap = packed[:, o : o + mp_] != 0.0; o += mp_
        suf_score = packed[:, o]; o += 1
        suf_jpos = packed[:, o : o + ms_].astype(np.int64); o += ms_
        suf_gap = packed[:, o : o + ms_] != 0.0
        bounds = []
        for i, raw in enumerate(state["raws"]):
            n_sig = len(raw)
            pos_p = _nearest_positions(pre_gap[i], pre_jpos[i], n_sig)
            pos_s = _nearest_positions(suf_gap[i], suf_jpos[i], n_sig)
            span = int(pos_p[-1]) - int(pos_p[0])
            score_prefix = float(pre_score[i]) / span if span > 0 else 0.0
            span = int(pos_s[-1]) - int(pos_s[0])
            score_suffix = float(suf_score[i]) / span if span > 0 else 0.0
            prefix_begin, prefix_end = int(pos_p[trim_prefix]), int(pos_p[-1])
            suffix_begin, suffix_end = int(pos_s[0]), int(pos_s[len(pos_s) - 1 - trim_suffix])
            ok = prefix_begin < suffix_end and score_prefix > 0.0 and score_suffix > 0.0
            bounds.append((ok, score_prefix, score_suffix, prefix_begin, prefix_end,
                           suffix_begin, suffix_end))
        return bounds

    def detect_middle(self, state: dict) -> dict:
        """Phase 2 of the split path: wait for the bounds rows, dispatch
        Viterbi on the segments.

        Idempotent and a no-op on fused and two-phase states, so
        schedulers may call it unconditionally.
        """
        if "bounds" in state or "bounds_parts" not in state:
            return state
        tc = state["tc"]
        B = state["B"]
        with trace.span("middle.wait"):
            host = self._from_host(state["bounds_parts"])
        with trace.span("middle.viterbi"):
            rows = unpack_meta(host.numpy()[:B])
            bounds = [(r.ok, r.score_prefix, r.score_suffix, r.prefix_begin,
                       r.prefix_end, r.suffix_begin, r.suffix_end) for r in rows]
            live = [i for i in range(B) if rows[i].ok]
            state["bounds"] = bounds
            state["live"] = live
            if live:
                segs = [state["flt32s"][i][bounds[i][3]:bounds[i][6]] for i in live]
                state["vit"] = self._viterbi_submit(tc.repeat_hmm, segs)
        return state

    def detect_mod_submit(self, state: dict) -> dict:
        """The mod phase, between :meth:`detect_middle` and
        :meth:`detect_finish`: queue the mod decode early.

        A no-op without a mod model, so schedulers may call it
        unconditionally.  With one it collects the count decode, takes
        each gated-in read's repeat-state samples from its minmax-
        normalised raw signal (clipped to the mod HMM's level range; the
        prep pool fans the reads out), queues their mod Viterbi decode,
        and decodes the count rows on the host while the card runs it.
        Idempotent.
        """
        if not self.has_mod or "modsub" in state or state["tc"].mod_hmm is None:
            return state
        tc = state["tc"]
        raws = state["raws"]
        B = state["B"]
        bounds, paths, seg_lens = self.decode_bounds(state)
        mm = tc.mod_hmm.meta

        def _mod_input(i):
            ok, _sp, _ss, prefix_begin, _pe, _sb, suffix_end = bounds[i]
            if not ok:
                return None
            mask = viterbi_ops.repeat_sample_mask(paths[i], seg_lens[i], tc.repeat_hmm)
            nrm = self.pm.normalize2model(raws[i], mode="minmax")
            rep_signal = nrm[prefix_begin:suffix_end][mask]
            if not len(rep_signal):
                return None
            return np.clip(rep_signal, mm["model_min"], mm["model_max"]).astype(np.float32)

        with trace.span("mod.prep"):
            rep_signals = list(self._prep_pool().map(_mod_input, range(B)))
            mod_jobs = [(i, s) for i, s in enumerate(rep_signals) if s is not None]
            handle = (self._viterbi_submit(tc.mod_hmm, [s for _, s in mod_jobs])
                      if mod_jobs else None)
        # the count rows decode on the host while the mod decode runs
        results = self._main_results(state)
        state["modsub"] = (results, [(i, len(s)) for i, s in mod_jobs], handle)
        return state

    def decode_bounds(self, state: dict):
        """(bounds, paths, seg_lens) of a submit handle; cached on the state.

        bounds[i] = (ok, score_prefix, score_suffix, prefix_begin,
        prefix_end, suffix_begin, suffix_end); paths/seg_lens keyed by
        read index for gated-in reads.
        """
        if "decoded" in state:
            return state["decoded"]
        tc = state["tc"]
        paths, seg_lens = {}, {}
        if "fused_parts" in state:
            with trace.span("finish.wait"):
                host = self._from_host(state["fused_parts"])
            rows = unpack_results(host.numpy()[: state["B"]], tc.repeat_hmm.n_states)
            bounds = [(r.ok, r.score_prefix, r.score_suffix, r.prefix_begin, r.prefix_end,
                       r.suffix_begin, r.suffix_end) for r in rows]
            for i, r in enumerate(rows):
                if r.ok:
                    paths[i] = r.path
                    seg_lens[i] = r.seg_len
        elif "planes_parts" in state:
            bounds = self._two_phase_bounds(state)
            live = [i for i, b in enumerate(bounds) if b[0]]
            if live:
                segs = [state["flts"][i][bounds[i][3]:bounds[i][6]].astype(np.float32)
                        for i in live]
                handle = self._viterbi_submit(tc.repeat_hmm, segs)
                with trace.span("finish.wait"):
                    mat = self._viterbi_collect(handle)
                for k, i in enumerate(live):
                    paths[i] = mat[k]
                    seg_lens[i] = len(segs[k])
        else:
            state = self.detect_middle(state)
            bounds = state["bounds"]
            if state["live"]:
                with trace.span("finish.wait"):
                    mat = self._viterbi_collect(state["vit"])
                for k, i in enumerate(state["live"]):
                    paths[i] = mat[k]
                    seg_lens[i] = bounds[i][6] - bounds[i][3]
        state["decoded"] = (bounds, paths, seg_lens)
        return state["decoded"]

    def _main_results(self, state: dict) -> list:
        """Result rows [n, scores, log_p, offset, ticks, '-'], as lists
        the mod phase fills."""
        tc = state["tc"]
        flts = state["flts"]
        bounds, paths, seg_lens = self.decode_bounds(state)
        results = []
        with trace.span("finish.decode"):
            for i in range(state["B"]):
                (ok, score_prefix, score_suffix, prefix_begin, prefix_end, suffix_begin,
                 suffix_end) = bounds[i]
                n = 0
                p = 0.0
                if ok:
                    path = paths[i]
                    segment = flts[i][prefix_begin:suffix_end]
                    n = viterbi_ops.count_repeats(path, seg_lens[i], tc.repeat_hmm)
                    p = viterbi_ops.path_logp_f64(segment, path, tc.repeat_hmm)
                results.append([n, score_prefix, score_suffix, p, prefix_end,
                                max(suffix_begin - prefix_end, 0), "-"])
        return results

    def detect_finish(self, state: dict):
        """Phase 3: collect the paths and decode the result tuples on the
        host (with a mod model: the mod phase first, then its paths into
        each read's mod string)."""
        tc = state["tc"]
        state = self.detect_mod_submit(state)
        if "modsub" in state:
            results, mod_info, handle = state["modsub"]
            if handle is not None:
                with trace.span("mod.wait"):
                    mpaths = self._viterbi_collect(handle)
                for k, (ri, slen) in enumerate(mod_info):
                    results[ri][6] = viterbi_ops.mod_pattern(mpaths[k], slen, tc.mod_hmm)
            return [tuple(r) for r in results]
        return [tuple(r) for r in self._main_results(state)]

    def _viterbi_submit(self, chm, segments) -> dict:
        """Queue the Viterbi decode of ``segments`` (its rows split over
        the devices); returns a collect handle."""
        lens = np.array([len(s) for s in segments], dtype=np.int32)
        B = len(segments)
        Bp = self._pad_rows(B)
        lens_p = np.ones(Bp, dtype=np.int32)
        lens_p[:B] = lens
        tpad = max(-(-int(lens.max()) // CHUNK_T) * CHUNK_T, CHUNK_T)
        if trace.enabled():
            trace.count("viterbi.steps", int(lens.sum()))
            trace.count("viterbi.padded", Bp * tpad)
        obs_host = self._host_buffer((Bp, tpad), torch.float32)
        obs = obs_host.numpy()
        for k, s in enumerate(segments):
            obs[k, : len(s)] = s
        parts = []
        for k, sl in enumerate(shard_rows(Bp, len(self.devices))):
            dev = self.devices[k]
            with on_stream(self._streams[k]):
                _, paths = viterbi_batch(obs_host[sl].to(dev, non_blocking=True),
                                         torch.from_numpy(lens_p[sl]).to(dev, non_blocking=True),
                                         self._padded_hmm(chm, dev))
                if path_itemsize(chm.n_states) == 1:
                    paths = paths.to(torch.uint8)  # 1 byte per entry for <= 256 states
                parts.append(self._to_host(paths))
        return {"parts": parts, "B": B, "obs": obs_host, "lens": lens_p}

    def _viterbi_collect(self, handle) -> np.ndarray:
        """Wait for a :meth:`_viterbi_submit` handle; (B, Tpad) int32 paths
        (its host paths, rows in order, stay as ``handle["paths"]``)."""
        if "paths" not in handle:
            handle["paths"] = self._from_host(handle["parts"])
        return handle["paths"].numpy()[: handle["B"]].astype(np.int32)
