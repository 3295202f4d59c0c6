"""The reference's ``count`` row of a read: prep, align, bounds, decode.

``Reference(locus, model_file, align, device, dtype)`` builds, per
strand, the flank templates (the 150-base flanks, cut to 50 bases for
the bounds, ``samples`` per k-mer) and the flanked-repeat HMM, as
STRique's ``repeatCounter.add_target`` does (reference
scripts/STRique.py:541-560, the '-' strand from the reverse
complement).  ``rows(raws, strands)`` returns each read's
(count, score_prefix, score_suffix, log_p, offset, ticks, mod).

With ``mod_model_file`` (a 5mC twin of the model) each strand also gets
the mod HMM of its repeat unit (:561-575), and each gated-in read's mod
is called as upstream's ``repeatCounter.detect`` does (:605-609): the
raw signal minmax-normalised to the base model, cut to
[prefix_begin:suffix_end], the samples the count path puts on repeat
states kept, clipped to the mod HMM's joint level range
(``mod_repeats``, :493), decoded by the same dense Viterbi in the
reference's float type, and read one character a unit
(``viterbi.mod_pattern``).  Departures from upstream: the mod string is
'-' where no sample is left (upstream would decode an empty signal), as
the package writes it; the decode is the max-plus Viterbi of the
compiled HMM, not pomegranate's.  Without a twin every mod is '-'.
"""
from __future__ import annotations

import numpy as np
import torch

from . import align, viterbi
from .hmm import build_flanked_repeat, build_repeat_mod
from .pore import PoreModel
from .prep import prep

_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def reverse_complement(seq: str) -> str:
    return seq.upper().translate(_COMPLEMENT)[::-1]


class _Strand:
    def __init__(self, pm, repeat, prefix, suffix, samples, hmm_config, pm_mod=None):
        self.prefix_ext = pm.template(prefix, samples)
        self.suffix_ext = pm.template(suffix, samples)
        self.trim_prefix = len(self.prefix_ext) - len(pm.template(prefix[-50:], samples))
        self.trim_suffix = len(self.suffix_ext) - len(pm.template(suffix[:50], samples))
        self.hmm = build_flanked_repeat(repeat, prefix[-50:], suffix[:50], pm, hmm_config)
        self.mod_hmm = (None if pm_mod is None
                        else build_repeat_mod(repeat, pm, pm_mod, hmm_config))


class Reference:
    def __init__(self, locus: dict, model_file: str, align_params: dict, device,
                 dtype=torch.float32, hmm_config: dict | None = None,
                 mod_model_file: str | None = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.params = align_params
        self.pm = PoreModel(model_file)
        pm_mod = PoreModel(mod_model_file) if mod_model_file else None
        samples = int(align_params["samples"])
        rep, pre, suf = (locus[k].upper() for k in ("repeat", "prefix", "suffix"))
        rc = reverse_complement
        self.strands = {
            "+": _Strand(self.pm, rep, pre, suf, samples, hmm_config, pm_mod),
            "-": _Strand(self.pm, rc(rep), rc(suf), rc(pre), samples, hmm_config, pm_mod),
        }

    def rows(self, raws, strands) -> list:
        """One result tuple a read (``strands[i]`` is '+' or '-')."""
        preps = [prep(r, self.pm) for r in raws]
        templates, ns, sigs = [], [], []
        for (bins, lut, _flt), s in zip(preps, strands):
            st = self.strands[s]
            sig = lut[bins.astype(np.int64)]
            for tmpl in (st.prefix_ext, st.suffix_ext):
                templates.append(tmpl)
                ns.append(len(bins))
                sigs.append(sig)
        dev = self.device
        tmpl, ms = align.lane_templates(templates)
        N = max(ns)
        sig_b = np.zeros((len(sigs), N), np.float32)
        for r, s in enumerate(sigs):
            sig_b[r, : len(s)] = s
        n_d = torch.tensor(ns, dtype=torch.int64, device=dev)
        m_d = torch.from_numpy(ms).to(dev)
        codes, bottom = align.wave(torch.from_numpy(sig_b).to(dev), n_d,
                                   torch.from_numpy(tmpl).to(dev), m_d, self.params, self.dtype)
        j_end, score = align.end_columns(bottom, m_d, self.params)
        is_gap, jpos = align.traceback(codes, j_end, m_d, int(ms.max()))
        del codes, bottom
        score = score.float().cpu().numpy()
        is_gap, jpos = is_gap.cpu().numpy(), jpos.cpu().numpy()
        out = [None] * len(raws)
        live = {"+": [], "-": []}
        for i, ((_bins, _lut, flt), s) in enumerate(zip(preps, strands)):
            st = self.strands[s]
            a, b = 2 * i, 2 * i + 1
            pre = (score[a], is_gap[a, : ms[a]], jpos[a, : ms[a]])
            suf = (score[b], is_gap[b, : ms[b]], jpos[b, : ms[b]])
            bnd = align.bounds(pre, suf, len(flt), st.trim_prefix, st.trim_suffix)
            out[i] = bnd
            if bnd[0]:
                live[s].append(i)
        rows = [None] * len(raws)
        for s, idx in live.items():
            if not idx:
                continue
            hmm = self.strands[s].hmm
            segs = [preps[i][2][out[i][3] : out[i][6]] for i in idx]
            paths = viterbi.decode([g.astype(np.float32) for g in segs], hmm, dev, self.dtype)
            mods = self._mods(s, [raws[i] for i in idx], [out[i] for i in idx], paths)
            for i, seg, path, mod in zip(idx, segs, paths, mods):
                _ok, sp, ss, _pb, pe, sb, _se = out[i]
                rows[i] = (viterbi.count_repeats(path, hmm), sp, ss,
                           viterbi.path_logp(seg, path, hmm), pe, max(sb - pe, 0), mod)
        for i, bnd in enumerate(out):
            if rows[i] is None:
                _ok, sp, ss, _pb, pe, sb, _se = bnd
                rows[i] = (0, sp, ss, 0.0, pe, max(sb - pe, 0), "-")
        return rows

    def _mods(self, strand, raws, bounds, paths) -> list:
        """The mod string of each gated-in read of one strand: '-' without
        a twin, or where the count path puts no sample on a repeat state."""
        st = self.strands[strand]
        mods = ["-"] * len(raws)
        if st.mod_hmm is None:
            return mods
        mm = st.mod_hmm.meta
        jobs, signals = [], []
        for k, (raw, bnd, path) in enumerate(zip(raws, bounds, paths)):
            nrm = self.pm.normalize_minmax(np.asarray(raw, dtype=np.float64))
            rep = nrm[bnd[3] : bnd[6]][st.hmm.meta["repeat_states"][path]]
            if len(rep):
                jobs.append(k)
                signals.append(np.clip(rep, mm["model_min"], mm["model_max"]).astype(np.float32))
        if jobs:
            for k, path in zip(jobs, viterbi.decode(signals, st.mod_hmm, self.device, self.dtype)):
                mods[k] = viterbi.mod_pattern(path, st.mod_hmm)
        return mods
