"""Probe: what a step of the wave kernel's cluster TABLE form costs.

Times ``wave_align_kernel``'s one-CTA TABLE instances and
``wave_cluster_kernel``'s (csrc/wave_align.cu) in all three modes (PTR,
CKPT, WINDOW): a cluster of C CTAs a row, C = 2 to 8 where the split is
one the kernel takes (``align_cuda._split_ok``) and rows x C fit the
card's SMs, at MP 896 (the bench's c9orf72 flanks), MP 384 and 640
(those flanks cut short) and MP 2176 (phase 4e's flanks, 200 bases
longer), over 8, 16 and 64 rows of both flanks as per-row templates
and the widest call of each C (rows x C within the SMs, every cluster
running at once: ``align_cuda.cluster_capacity``); up to MP 896 the
one-CTA instance beside them.  Each shape runs N = 8192
samples (every row its full length), is timed by CUDA events (3
launches after a warm-up) and printed as us a step; its outputs are
held equal to the first C's at that shape (written pointer words,
bottom taps, written checkpoint slots).  Then one launch of the same
shape through the probe build (tools/probe_wave_cluster.cu: the kernels
with a clock64 hook) gives the share of the step loop that CTAs 1..C-1
wait for the CTA ring to fill and CTAs 0..C-2 for a slot to empty, the
same of a warp ring, and warp 1's cycles a group by phase.  First it
prints each wave instance's registers, stack and spills from the
build's ``-Xptxas -v``.  Needs a CUDA card and nvcc.

    python tools/probe_wave_cluster.py [--n 8192] [--out f.json]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch import _build  # noqa: E402
from strique_tpu_torch.detect.counter import RepeatCounter  # noqa: E402
from strique_tpu_torch.ops import align_cuda as AC  # noqa: E402
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, write_pore_model  # noqa: E402

MODES = ("ptr", "ckpt", "window")
ROWS = (8, 16, 64)
SHORT_MPS = (384, 640)  # the bench flanks cut short: the one-CTA step below 896 lanes
CKPT_STEPS = 1024
# wave_align_kernel<LPT, MODE, SCORE> (one CTA a row), wave_cluster_kernel<LPT, MODE, Hook>
KERNEL_RE = re.compile(r"wave_(align|cluster)_kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?")


def ptxas_instances(log: str) -> list:
    """(LPT, mode, score, cluster, registers, stack, spill stores, spill
    loads) of every wave kernel instance in an -Xptxas -v log (the
    cluster instances are TABLE's)."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = KERNEL_RE.search(line)
            cur = None if m is None else {
                "cluster": int(m.group(1) == "cluster"), "lpt": int(m.group(2)),
                "mode": int(m.group(3)), "score": 1 if m.group(4) is None else int(m.group(4))}
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(cur)
            cur = None
    return out


def lanes_a_thread(lanes: int) -> int:
    """The cluster kernel's lanes a thread for a CTA of ``lanes`` lanes
    (csrc/wave_align.cu dispatch_table)."""
    return 1 if lanes <= 1024 else 2 if lanes <= 1536 else 4


def build_hooked():
    """The probe build (tools/probe_wave_cluster.cu) with the wave entry
    points' C signatures, and its ring buffer setter."""
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_wave_cluster.so")
    src = os.path.join(ROOT, "tools", "probe_wave_cluster.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("wave_"):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    handle.probe_ring_buffer.argtypes = [ctypes.c_void_p]
    handle.probe_ring_buffer.restype = ctypes.c_int
    return handle


def flank_templates(seed: int):
    """{MP: (prefix, suffix)} of the bench target and phase 4e's, and
    the counter's AlignParams."""
    tmp = tempfile.mkdtemp(prefix="probe_wave_cluster_")
    c = RepeatCounter(write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=seed),
                      device="cuda")
    c.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    rng = np.random.default_rng(seed + 3)  # phase 4e's flanks
    c.add_target("long", REPEAT, "".join(rng.choice(list("ACGT"), 200)) + PREFIX,
                 SUFFIX + "".join(rng.choice(list("ACGT"), 200)))
    out = {}
    for name in ("c9orf72", "long"):
        tc = c.targets[name][0]
        rows, ms = AC.pad_template_rows([tc.prefix_ext, tc.suffix_ext])
        out[rows.shape[1]] = (rows, ms)
        if name == "c9orf72":  # shorter templates of the same levels: one CTA of fewer lanes
            for mp in SHORT_MPS:
                out[mp] = AC.pad_template_rows([tc.prefix_ext[: mp - 2], tc.suffix_ext[: mp - 122]])
    return out, c.align_params


class Shape:
    """Device inputs of B rows (half each flank) at one MP, N samples."""

    def __init__(self, rows, ms, B: int, N: int, rng, dev="cuda"):
        self.dev = dev = torch.device(dev)
        half = [B // 2, B - B // 2]
        self.tmpl = np.repeat(rows, half, axis=0)
        self.B, self.N, self.mp = B, N, rows.shape[1]
        self.m_max = int(ms.max())
        lut = np.sort(rng.uniform(40, 150, (B, 256)), axis=1).astype(np.float32)
        self.bins = torch.from_numpy(rng.integers(0, 256, (B, N)).astype(np.uint8)).to(dev)
        self.lut = torch.from_numpy(lut).to(dev)
        self.n = torch.full((B,), N, dtype=torch.int32, device=dev)
        self.m = torch.from_numpy(np.repeat(ms.astype(np.int32), half)).to(dev)
        self.nd = -(-(N + self.mp) // CKPT_STEPS) * CKPT_STEPS
        lane0 = torch.arange(self.mp, device=dev) == 0
        s1 = torch.where(lane0, 0.0, AC.NEG).to(torch.float32).expand(B, -1).contiguous()
        self.state4 = (s1, *(torch.full((B, self.mp), AC.NEG, device=dev) for _ in range(3)))

    def levels(self, ctas: int):
        lv, li = AC.template_levels(self.tmpl, ctas)
        return torch.from_numpy(lv).to(self.dev), torch.from_numpy(li).to(self.dev)

    def steps(self, mode: str) -> int:
        if mode == "window":
            return self.N
        nd = self.nd if mode == "ckpt" else self.N + self.mp
        return min(nd, (self.N + self.m_max + 7) // 8 * 8)

    def call(self, mode: str, lv, li, params):
        if mode == "ptr":
            return lambda: AC.align_forward_wave_multi_morph(self.bins, self.lut, self.n, lv, li,
                                                             self.m, params)
        if mode == "ckpt":
            return lambda: AC.align_forward_ckpt_morph(self.bins, self.lut, self.n, lv, li,
                                                       params, self.m, CKPT_STEPS // AC.CHUNK,
                                                       self.nd)
        zeros = torch.zeros(self.B, dtype=torch.int32, device=self.dev)
        cold = torch.ones_like(zeros)
        return lambda: AC.align_window_from_state_morph(self.bins, self.lut, zeros, self.state4,
                                                        cold, self.n, lv, li, params, self.m_max,
                                                        self.N)

    def written(self, mode: str, out) -> list:
        """The outputs a row writes (the rest is left as allocated)."""
        if mode == "ptr":
            ptr, bot = out
            return [ptr[CS.valid_ptr_mask(self.n, self.m, ptr.shape[0])], bot]
        if mode == "ckpt":
            bot, cks = out
            mask = CS.written_slots(self.n, self.m, self.nd, CKPT_STEPS)
            return [bot, *(c[mask] for c in cks)]
        return [out]


def ring_shares(hooked, shape: Shape, fn, ctas: int) -> dict:
    """One launch through the probe build: the ring waits' shares of the
    step loop (the CTA ring's full wait: CTAs 1..C-1, empty: CTAs
    0..C-2; a warp ring's: warp 1's first thread, warp 0's last), the
    loop's cycles a step, and warp 1's cycles a group by phase."""
    buf = torch.zeros((shape.B * ctas, 18), dtype=torch.int64, device="cuda")
    if hooked.probe_ring_buffer(buf.data_ptr()):
        raise RuntimeError("probe_ring_buffer failed")
    saved = _build._lib
    _build._lib = hooked
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _build._lib = saved
    st = buf.view(shape.B, ctas, 18).double().cpu()
    loop = st[:, :, 0]
    return {"full": float(st[:, 1:, 1].sum() / loop[:, 1:].sum()),
            "empty": float(st[:, :-1, 2].sum() / loop[:, :-1].sum()),
            "warp_full": float(st[:, :, 4].sum() / loop.sum()),
            "warp_empty": float(st[:, :, 5].sum() / loop.sum()),
            "cycles_per_step": float((loop / (8 * st[:, :, 3])).mean()),
            # cycles a group of warp 1's, warp 0's and the last warp's first
            # thread: ring work at the group's end, reading its scores, its
            # waits, its 8 steps
            "group_phases": [float((st[:, :, 6 + k] / st[:, :, 3]).mean()) for k in range(4)],
            "group_phases_warp0": [float((st[:, :, 10 + k] / st[:, :, 3]).mean())
                                   for k in range(4)],
            "group_phases_last": [float((st[:, :, 14 + k] / st[:, :, 3]).mean())
                                  for k in range(4)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=8192, help="samples a row")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_wave_cluster: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(force=True)
    names = {0: "PTR", 1: "CKPT", 2: "WINDOW"}
    regs = ptxas_instances(_build.BUILD_INFO.get("ptxas", ""))
    for r in regs:
        if r["score"] == 1:
            kern = "wave_cluster_kernel" if r["cluster"] else "wave_align_kernel"
            print(f"ptxas: {kern}<LPT {r['lpt']}, {names[r['mode']]}> (TABLE): "
                  f"{r['registers']} registers, "
                  f"stack {r['stack']} B, spill stores {r['spill_stores']} B, loads "
                  f"{r['spill_loads']} B", flush=True)
    hooked = build_hooked()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    templates, params = flank_templates(args.seed)
    rng = np.random.default_rng(args.seed + 11)
    table, bad = [], 0
    for mp, (rows, ms) in sorted(templates.items()):
        first = AC.wave_table_ctas(rows)
        splits = [c for c in range(max(first, 1), AC.MAX_CTAS + 1)
                  if c == 1 or AC._split_ok(mp, c)]
        # the widest call of each C: rows x C within the SMs, every
        # cluster running at once (the plan's width)
        wide = {c: AC.kernel_batch(None, device="cuda", ctas=c) for c in splits}
        for c in (c for c in splits if c > 1):
            cap = AC.cluster_capacity("cuda", c, AC.cta_lanes(mp, c))
            wide[c] = min(wide[c], cap // 8 * 8)
            print(f"MP {mp} C {c}: {cap} clusters at once ({sms} SMs), {wide[c]} rows a call",
                  flush=True)
        for B in sorted(set(ROWS) | set(wide.values())):
            shape = Shape(rows, ms, B, args.n, rng)
            cands = [c for c in splits
                     if B * c <= sms and B <= wide[c] and (B in ROWS or B == wide[c])]
            forms = {c: shape.levels(c) for c in cands}
            for mode in MODES:
                ref = None
                for c in cands:
                    lv, li = forms[c]
                    fn = shape.call(mode, lv, li, params)
                    out = shape.written(mode, fn())
                    same = ref is None or all(torch.equal(a, b) for a, b in zip(out, ref))
                    ref = out if ref is None else ref
                    bad += not same
                    del out
                    ms_ = CS.cuda_ms(fn, 3)
                    steps = shape.steps(mode)
                    ring = ring_shares(hooked, shape, fn, c) if c > 1 else None
                    row = {"mode": mode, "mp": mp, "rows": B, "ctas": c,
                           "lanes_a_cta": AC.cta_lanes(mp, c),
                           "lanes_a_thread": lanes_a_thread(AC.cta_lanes(mp, c)),
                           "levels_a_cta": int(lv.shape[-1]), "steps": steps, "ms": ms_,
                           "us_per_step": ms_ * 1e3 / steps, "ring": ring, "equal": same}
                    table.append(row)
                    ring_s = ("" if ring is None else
                              f"; ring wait full {ring['full']:.3f}, empty {ring['empty']:.3f} "
                              f"(warp ring {ring['warp_full']:.3f}, {ring['warp_empty']:.3f}) "
                              f"of the loop, {ring['cycles_per_step']:.0f} cycles a step; a "
                              f"group's end / scores / waits / 8 steps, warp 1: "
                              + " / ".join(f"{x:.0f}" for x in ring["group_phases"])
                              + ", warp 0: "
                              + " / ".join(f"{x:.0f}" for x in ring["group_phases_warp0"])
                              + ", last warp: "
                              + " / ".join(f"{x:.0f}" for x in ring["group_phases_last"])
                              + " cycles")
                    print(f"{mode.upper():6s} MP {mp} rows {B:3d} C {c} ({row['lanes_a_cta']} "
                          f"lanes a CTA, {row['lanes_a_thread']} a thread, "
                          f"{row['levels_a_cta']} levels): {ms_:.3f} ms, "
                          f"{row['us_per_step']:.4f} us/step{ring_s}; outputs "
                          f"{'equal' if same else 'DIFFER'}", flush=True)
                    torch.cuda.empty_cache()
            del shape, forms
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "n": args.n, "ptxas": regs, "shapes": table}, fp, indent=1)
    print(f"probe_wave_cluster: {len(table)} shapes, {bad} with outputs differing from the "
          f"first C's; card: {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
