"""The reference's ``count`` row of a read: prep, align, bounds, decode.

``Reference(locus, model_file, align, device, dtype)`` builds, per
strand, the flank templates (the 150-base flanks, cut to 50 bases for
the bounds, ``samples`` per k-mer) and the flanked-repeat HMM, as
STRique's ``repeatCounter.add_target`` does (reference
scripts/STRique.py:541-560, the '-' strand from the reverse
complement).  ``rows(raws, strands)`` returns each read's
(count, score_prefix, score_suffix, log_p, offset, ticks, mod).
"""
from __future__ import annotations

import numpy as np
import torch

from . import align, viterbi
from .hmm import build_flanked_repeat
from .pore import PoreModel
from .prep import prep

_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def reverse_complement(seq: str) -> str:
    return seq.upper().translate(_COMPLEMENT)[::-1]


class _Strand:
    def __init__(self, pm, repeat, prefix, suffix, samples, hmm_config):
        self.prefix_ext = pm.template(prefix, samples)
        self.suffix_ext = pm.template(suffix, samples)
        self.trim_prefix = len(self.prefix_ext) - len(pm.template(prefix[-50:], samples))
        self.trim_suffix = len(self.suffix_ext) - len(pm.template(suffix[:50], samples))
        self.hmm = build_flanked_repeat(repeat, prefix[-50:], suffix[:50], pm, hmm_config)


class Reference:
    def __init__(self, locus: dict, model_file: str, align_params: dict, device,
                 dtype=torch.float32, hmm_config: dict | None = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.params = align_params
        self.pm = PoreModel(model_file)
        samples = int(align_params["samples"])
        rep, pre, suf = (locus[k].upper() for k in ("repeat", "prefix", "suffix"))
        rc = reverse_complement
        self.strands = {
            "+": _Strand(self.pm, rep, pre, suf, samples, hmm_config),
            "-": _Strand(self.pm, rc(rep), rc(suf), rc(pre), samples, hmm_config),
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
            for i, seg, path in zip(idx, segs, paths):
                _ok, sp, ss, _pb, pe, sb, _se = out[i]
                rows[i] = (viterbi.count_repeats(path, hmm), sp, ss,
                           viterbi.path_logp(seg, path, hmm), pe, max(sb - pe, 0), "-")
        for i, bnd in enumerate(out):
            if rows[i] is None:
                _ok, sp, ss, _pb, pe, sb, _se = bnd
                rows[i] = (0, sp, ss, 0.0, pe, max(sb - pe, 0), "-")
        return rows
