"""The port's own copies of the JAX package's jax-free modules, pinned to
their originals on seeded inputs.

strique_tpu_torch imports nothing of strique_tpu (tests/
test_torch_imports.py), so it carries copies of the pore model, the HMM
builders and factorizer, the NumPy signal ops, ``model_const``,
``AlignParams``, the native host prep and the bounds-row decoder.  Each
is held equal to its original here: arrays exactly, the native prep's
outputs byte for byte.  The count CLI's host modules (config, SAM,
fast5, writer, logger, dispatcher) and the scheduler's tail merge plan
are held to theirs on seeded inputs: the same values, bytes, log lines,
rows and plans; tests/test_io.py's extraction cases run on the port's
fast5 copy, and the fused route's packed rows decode as the reference
decodes them.
"""
import os

import numpy as np
import pytest

from strique_tpu import native as jax_native
from strique_tpu.detect import packed as JK
from strique_tpu.hmm.models import build_flanked_repeat as jax_build
from strique_tpu.ops import prep as JPR
from strique_tpu.ops import reference as JR
from strique_tpu.ops import signal as JS
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch import native
from strique_tpu_torch.detect import packed as TK
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import prep as TPR
from strique_tpu_torch.ops import reference as TR
from strique_tpu_torch.ops import signal as TS
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, write_pore_model


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=5)
    return PoreModel(path), JaxPoreModel(path)


def _raw(seed, n=6000):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 3, n)) + rng.uniform(300, 600) + rng.normal(0, 8, n)


@pytest.mark.parametrize("mode", ["median", "minmax", "entropy"])
def test_pore_model_normalisation_and_synthesis(models, mode):
    pm, jpm = models
    for k in ("model_median", "model_MAD", "model_min", "model_max", "_m5_mod", "_m95_mod"):
        assert getattr(pm, k) == getattr(jpm, k), k
    x = _raw(1)
    a, b = pm.norm_params(x, mode=mode), jpm.norm_params(x, mode=mode)
    assert (a.scale, a.offset, a.lo, a.hi) == (b.scale, b.offset, b.lo, b.hi)
    np.testing.assert_array_equal(pm.normalize2model(x, mode=mode),
                                  jpm.normalize2model(x, mode=mode))
    seq = PREFIX[-40:] + REPEAT * 7 + SUFFIX[:40]
    for samples, noise in ((6, False), (None, False), (8, True)):
        np.testing.assert_array_equal(
            pm.generate_signal(seq, samples=samples, noise=noise, rng=np.random.default_rng(2)),
            jpm.generate_signal(seq, samples=samples, noise=noise, rng=np.random.default_rng(2)))


@pytest.mark.parametrize("config", [None, {"pomegranate_compat": True}])
def test_flanked_repeat_hmm_and_factor_spec(models, config):
    pm, jpm = models
    got = build_flanked_repeat(REPEAT, PREFIX[-30:], SUFFIX[:30], pm, config)
    ref = jax_build(REPEAT, PREFIX[-30:], SUFFIX[:30], jpm, config)
    assert got.names == ref.names
    for k in ("log_start", "log_trans", "log_end", "mu", "sigma", "is_uniform", "log_uni"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.meta.keys() == ref.meta.keys()
    for k in ref.meta:
        np.testing.assert_array_equal(got.meta[k], ref.meta[k], err_msg=k)
    f, g = got.factored, ref.factored
    assert f is not None and g is not None and f.stats == g.stats
    assert [o for o, _ in f.diags] == [o for o, _ in g.diags]
    for (_, a), (_, b) in zip(f.diags, g.diags):
        np.testing.assert_array_equal(a, b)
    assert len(f.chains) == len(g.chains)
    for c, d in zip(f.chains, g.chains):
        np.testing.assert_array_equal(c.ramp, d.ramp)
        np.testing.assert_array_equal(c.slots, d.slots)
        for side in ("entries", "exits"):
            assert [o for o, _ in getattr(c, side)] == [o for o, _ in getattr(d, side)]
            for (_, a), (_, b) in zip(getattr(c, side), getattr(d, side)):
                np.testing.assert_array_equal(a, b)


def test_signal_ops(models):
    x = _raw(3, 2000)
    flt = TS.medfilt3(x)
    np.testing.assert_array_equal(flt, JS.medfilt3(x))
    med, mad = float(np.median(flt)), float(np.mean(np.abs(flt - np.median(flt))))
    q = TS.quantize_morph_np(flt, med, mad)
    np.testing.assert_array_equal(q, JS.quantize_morph_np(flt, med, mad))
    for f in ("erode_np", "dilate_np", "open_close_np"):
        np.testing.assert_array_equal(getattr(TS, f)(q), getattr(JS, f)(q), err_msg=f)


def test_model_const_and_align_params(models):
    pm, jpm = models
    assert TPR.model_const(pm) == JPR.model_const(jpm)
    for kw in ({}, {"gap_open_h": -3.0, "dist_min": 2.0}):
        a, b = TR.AlignParams(**kw), JR.AlignParams(**kw)
        assert a.__dataclass_fields__.keys() == b.__dataclass_fields__.keys()
        assert all(getattr(a, k) == getattr(b, k) for k in b.__dataclass_fields__)


@pytest.fixture
def both_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("a C++ compiler is needed to build the native host prep")


@pytest.mark.parametrize("n", [5, 1000, 25000])
def test_native_preprocess_read_lut_byte_equal(models, both_native, n):
    pm, jpm = models
    raw = _raw(10 + n, n)
    outs = []
    for lib, m in ((native, pm), (jax_native, jpm)):
        mc = (TPR if lib is native else JPR).model_const(m)
        flt32, q, lut = np.empty(n, np.float32), np.empty(n, np.uint8), np.empty(256, np.float32)
        flt64 = lib.preprocess_read_lut(raw, mc, flt32, q, lut)
        outs.append((flt64, flt32, q, lut))
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


def test_unpack_meta_and_path_itemsize():
    rng = np.random.default_rng(4)
    meta = rng.uniform(0, 500, (6, len(TK.META_FIELDS))).astype(np.float32).round()
    meta[:, 1] = [0, 3, 5, 0, 7, 2]
    meta[:, 8] = [1, 0, 1, 1, 0, 1]
    assert TK.META_FIELDS == JK.META_FIELDS
    for a, b in zip(TK.unpack_meta(meta), JK.unpack_meta(meta)):
        assert a.__dict__ == b.__dict__
    for s in (1, 256, 257, 4000):
        assert TK.path_itemsize(s) == JK.path_itemsize(s)


# -- the count CLI's host modules ---------------------------------------------

def test_parse_config(tmp_path):
    import json

    from strique_tpu.utils.config import parse_config as jax_parse
    from strique_tpu_torch.synthetic import LOCI, write_repeat_config
    from strique_tpu_torch.utils.config import parse_config

    tsv = write_repeat_config(str(tmp_path / "repeats.tsv"), LOCI)
    with open(tsv, "a") as fp:
        fp.write("chr1\t5\t9\tshort\tCAG\n")  # a column mismatch: logged and skipped
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"align": {"gap_open_h": -2.0, "samples": 7},
                                  "HMM": {"state_loop": 0.3}}))
    for args in ((tsv,), (tsv, str(params))):
        assert parse_config(*args) == jax_parse(*args)
    assert set(parse_config(tsv)["repeat"]) == set(LOCI)
    params.write_text(json.dumps({"align": {}}))
    for fn in (parse_config, jax_parse):
        with pytest.raises(SystemExit):
            fn(tsv, str(params))


SAM_LINES = [
    "r-fwd\t0\tchr9\t27541232\t60\t5S40000M3I12D7S\t*\t0\t0\t*\t*",
    "r-rev\t16\tchrX\t146973569\t60\t3H10S41000M2D\t*\t0\t0\t*\t*",
    "r-unmapped\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
    "r-short\t0\tchr9\t27573000\t60\t100M\t*\t0\t0\t*\t*",
    "r-bad\tnot-a-flag\tchr9\t1\t60\t10M\t*\t0\t0\t*\t*",
    "too\tfew\tcolumns",
]


@pytest.mark.parametrize("line", SAM_LINES)
def test_decode_sam_and_intersect_targets(line):
    from strique_tpu.io import sam as jax_sam
    from strique_tpu_torch.io import sam
    from strique_tpu_torch.synthetic import LOCI

    got, ref = sam.decode_sam(line), jax_sam.decode_sam(line)
    assert got.__dict__ == ref.__dict__ and got.strand == ref.strand
    loci = {}
    for name, (chrom, begin, end, *_rest) in LOCI.items():
        loci.setdefault(chrom, []).append((name, begin, end))
    assert sam.intersect_targets(got, loci) == jax_sam.intersect_targets(ref, loci)
    assert sam.decode_cigar("5S40M2I") == jax_sam.decode_cigar("5S40M2I")


def _write_bulk(path, reads):
    import h5py

    with h5py.File(path, "w") as f:
        for rid, sig in reads.items():
            g = f.create_group(f"read_{rid}/Raw")
            g.attrs["read_id"] = np.bytes_(rid.encode())
            g.create_dataset("Signal", data=sig)


def _fast5_dir(d, rng):
    from strique_tpu_torch.synthetic import write_single_fast5

    d.mkdir()
    reads = {f"read-{k}": rng.integers(300, 700, 50 + 10 * k).astype(np.int16)
             for k in range(5)}
    for rid in ("read-0", "read-1"):
        write_single_fast5(str(d / f"{rid}.fast5"), rid, reads[rid])
    _write_bulk(str(d / "bulk.fast5"), {k: reads[k] for k in ("read-2", "read-3", "read-4")})
    (d / "broken.fast5").write_bytes(b"not an hdf5 file")  # reported and skipped
    return reads


def test_fast5_index_get_raw_set_raw(tmp_path):
    from strique_tpu.io import fast5 as jax_fast5
    from strique_tpu_torch.io import fast5

    indexes = []
    for mod, name in ((fast5, "port"), (jax_fast5, "jax")):
        d = tmp_path / name
        reads = _fast5_dir(d, np.random.default_rng(8))
        lines = list(mod.index(str(d)))
        (d / "reads.fofn").write_text("\n".join(lines) + "\n")
        indexes.append((mod.Fast5Index(str(d / "reads.fofn")), sorted(lines)))
    (port, port_lines), (ref, ref_lines) = indexes
    assert port_lines == ref_lines and len(port_lines) == 5
    for rid, sig in reads.items():
        np.testing.assert_array_equal(port.get_raw(rid), ref.get_raw(rid))
        np.testing.assert_array_equal(port.get_raw(rid), sig)
    for idx in (port, ref):
        idx.set_raw("read-1", reads["read-1"][::2])
        idx.set_raw("read-3", reads["read-3"][5:])
    for rid in reads:
        np.testing.assert_array_equal(port.get_raw(rid), ref.get_raw(rid))
    assert len(port.get_raw("read-3")) == len(reads["read-3"]) - 5
    for idx in (port, ref):
        with pytest.raises(RuntimeError):
            idx.get_raw("no-such-read")
    assert fast5.Locator.parse("a/b.fast5/read_x") == fast5.Locator(fast5.BULK, "a/b.fast5",
                                                                     "read_x")


def test_fast5_module_imports_without_h5py():
    """The CLI's import chain (fast5 and the masker included) needs
    neither h5py nor matplotlib."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['h5py'] = None; sys.modules['matplotlib'] = None\n"
            "import strique_tpu_torch.cli, strique_tpu_torch.io.fast5 as f\n"
            "import strique_tpu_torch.io.masker\n"
            "import strique_tpu_torch.detect.detector, strique_tpu_torch.parallel.dispatcher\n"
            "assert f.Fast5Index(None).index_file is None\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


def _single_f5(path, read_id, signal):
    """tests/test_io.py's ``make_single_f5``."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_1")
        g.attrs["read_id"] = np.bytes_(read_id.encode())
        g.attrs["duration"] = np.uint32(len(signal))
        g.create_dataset("Signal", data=signal.astype(np.int16))


def test_extract_subset(tmp_path):
    """tests/test_io.py::test_extract_subset on the port's copy."""
    from strique_tpu_torch.io import fast5

    rids = [f"xtr-read-{i}" for i in range(3)]
    for i, rid in enumerate(rids):
        _single_f5(tmp_path / f"s{i}.fast5", rid, np.full(10 + i, i, np.int16))
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(tmp_path))) + "\n")
    ids_txt = tmp_path / "subset.txt"
    ids_txt.write_text("\n".join(rids[:2]) + "\n")
    out = tmp_path / "out"
    fast5.Fast5Index(str(fofn)).extract(str(ids_txt), str(out), format="single")
    assert sorted(os.listdir(out)) == ["s0.fast5", "s1.fast5"]


def test_tar_extract_exact_member_match(tmp_path):
    """tests/test_io.py::test_tar_extract_exact_member_match on the port's
    copy: a member path that is a suffix of another must not over-extract."""
    import tarfile

    from strique_tpu_torch.io import fast5

    sigs = {"a.fast5": np.arange(10, dtype=np.int16),
            "sub/a.fast5": np.arange(20, dtype=np.int16)}
    work = tmp_path / "work"
    os.makedirs(work / "sub")
    rids = {}
    for arc, sig in sigs.items():
        rids[arc] = f"rid-{arc.replace('/', '-')}"
        _single_f5(work / arc, rids[arc], sig)
    with tarfile.open(tmp_path / "batch.tar", "w") as tf:
        for arc in sigs:
            tf.add(work / arc, arcname=arc)
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("".join(f"batch.tar/{arc}\t{rid}\n" for arc, rid in rids.items()))
    out = tmp_path / "out"
    fast5.Fast5Index(str(fofn)).materialize_reads([rids["a.fast5"]], str(out))
    assert sorted(os.listdir(out)) == ["a.fast5"]
    np.testing.assert_array_equal(fast5._read_signal(str(out / "a.fast5")), sigs["a.fast5"])


def test_singles_to_multi_ont_layout(tmp_path):
    """tests/test_io.py::test_singles_to_multi_ont_layout on the port's copy,
    with a synthetic single read in the layout of the reference's data
    file (read number 2628, UniqueGlobalKey groups): single -> multi in
    ont_fast5_api's layout, and back."""
    import h5py

    from strique_tpu_torch.io import fast5

    rid = "ce47b364-synthetic"
    src = tmp_path / "single.fast5"
    orig = np.random.default_rng(2).integers(300, 700, 500).astype(np.int16)
    with h5py.File(src, "w") as f:
        g = f.create_group("Raw/Reads/Read_2628")
        g.attrs["read_id"] = np.bytes_(rid.encode())
        g.attrs["read_number"] = np.int32(2628)
        g.create_dataset("Signal", data=orig)
        f.create_group("UniqueGlobalKey/tracking_id").attrs["run_id"] = np.bytes_(b"run7")
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 49.0
        f.create_group("UniqueGlobalKey/context_tags")
    bulk = tmp_path / "packed.fast5"
    fast5.singles_to_multi([str(src)], str(bulk))
    with h5py.File(bulk) as f:
        assert f.attrs["file_version"] == "2.0"
        g = f[f"read_{rid}"]
        assert g.attrs["run_id"] == b"run7"
        assert isinstance(g["Raw/Signal"], h5py.Dataset)
        assert g["Raw"].attrs["read_id"] == rid.encode()
        assert g["Raw"].attrs["read_number"] == 2628
        for name in ("channel_id", "context_tags", "tracking_id"):
            assert name in g
        assert g["channel_id"].attrs["digitisation"] == 8192.0
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(bulk))) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    np.testing.assert_array_equal(idx.get_raw(rid), orig)
    out = tmp_path / "unpacked"
    idx.extract(str(bulk), str(out), format="single")
    single = out / f"{rid}.fast5"
    assert fast5.read_id_single(str(single)) == rid
    with h5py.File(single) as f:
        np.testing.assert_array_equal(f["Raw/Reads/Read_2628/Signal"][()], orig)
        assert f["UniqueGlobalKey/channel_id"].attrs["offset"] == 49.0


def test_multi_to_single_ugk_named_child(tmp_path):
    """tests/test_io.py::test_multi_to_single_ugk_named_child on the port's
    copy: a bulk read group's child named UniqueGlobalKey merges into the
    created group."""
    import h5py

    from strique_tpu_torch.io import fast5

    rid = "read-ugk-child"
    src = tmp_path / f"{rid}.fast5"
    sig = np.arange(32, dtype=np.int16)
    _single_f5(src, rid, sig)
    bulk = tmp_path / "packed.fast5"
    fast5.singles_to_multi([str(src)], str(bulk))
    with h5py.File(bulk, "r+") as f:
        f.create_group(f"read_{rid}/UniqueGlobalKey/context_args").attrs["note"] = \
            np.bytes_(b"kept")
    out = tmp_path / "single_out.fast5"
    with h5py.File(bulk) as f:
        fast5.multi_group_to_single(f, f"read_{rid}", str(out))
    with h5py.File(out) as f:
        assert f["UniqueGlobalKey/context_args"].attrs["note"] == b"kept"
        np.testing.assert_array_equal(f["Raw/Reads/Read_0/Signal"][()], sig)


def test_pack_results_round_trip_and_unpack_copy():
    """The port's pack_results (torch) through its unpack_results copy
    gives the JAX package's unpack_results of the same bytes, at u8 and
    u16 path entries; gated rows decode with no path."""
    import torch

    rng = np.random.default_rng(6)
    B, T = 5, 37
    bounds = {k: torch.from_numpy(rng.integers(0, 3000, B).astype(np.int32))
              for k in TK.META_FIELDS}
    bounds["score_p"] = torch.from_numpy(rng.uniform(-5, 900, B).astype(np.float32))
    bounds["score_s"] = torch.from_numpy(rng.uniform(-5, 900, B).astype(np.float32))
    bounds["ok"] = torch.tensor([True, False, True, True, False])
    for n_states in (200, 256, 257, 4000):
        paths = torch.from_numpy(rng.integers(0, n_states, (B, T)).astype(np.int32))
        packed = TK.pack_results(bounds, paths, n_states).numpy()
        assert packed.dtype == np.uint8
        assert packed.shape == (B, TK.META_BYTES + T * TK.path_itemsize(n_states))
        got, ref = TK.unpack_results(packed, n_states), JK.unpack_results(packed, n_states)
        for i, (a, b) in enumerate(zip(got, ref)):
            assert {k: v for k, v in a.__dict__.items() if k != "path"} == \
                {k: v for k, v in b.__dict__.items() if k != "path"}
            if a.ok:
                np.testing.assert_array_equal(a.path, b.path)
                np.testing.assert_array_equal(a.path, paths[i].numpy())
            else:
                assert a.path is None and b.path is None


ROWS = [("read-a", "c9orf72", "+", 12, 8.804217333737352, 8.740056275905323,
         -2609.5124184012366, 1686, 407, "-"),
        ("read-b", "fmr1", "-", 0, 0.0, 0.0, 0.0, 0, 0, "-")]


def test_writer_processed_ids_merge_shards(tmp_path, capsys):
    from strique_tpu.detect import writer as jax_writer
    from strique_tpu_torch.detect import writer

    assert writer.HEADER == jax_writer.HEADER
    outs = {}
    for mod, name in ((writer, "port"), (jax_writer, "jax")):
        d = tmp_path / name
        d.mkdir()
        out = d / "counts.tsv"
        w = mod.OutputWriter(str(out))
        w.write_line(target_counts=ROWS[:1])
        w.write_line(target_counts=ROWS[1:])
        mod.OutputWriter(str(out), append=True).write_line(target_counts=ROWS[:1])
        merged = d / "merged.tsv"
        for rank in (0, 2):  # part 1 is on another host's filesystem
            part = mod.OutputWriter(f"{merged}.part{rank}")
            part.write_line(target_counts=[ROWS[rank // 2]])
        assert mod.merge_shards(str(merged), 3) == 2
        mod.OutputWriter(None).write_line(target_counts=ROWS)  # to stdout
        outs[name] = (out.read_bytes(), merged.read_bytes(), mod.processed_ids(str(out)),
                      mod.processed_ids(str(tmp_path / "absent.tsv")), capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert outs["port"][2] == {"read-a", "read-b"}


@pytest.mark.parametrize("level", ["error", "warning", "info", "debug"])
def test_logger_levels(capsys, tmp_path, level):
    from strique_tpu.utils import logging as jax_log
    from strique_tpu_torch.utils import logging as ulog

    emitted = []
    for mod in (ulog, jax_log):
        sink = tmp_path / f"{mod.__name__}.log"
        mod.init(file=str(sink), log_level=level)
        for lv in mod.LogLevel:
            mod.log(f"message at {lv.name}", lv)
        mod.close()
        err = capsys.readouterr().err.splitlines()
        emitted.append(([ln.split(" ", 3)[3] for ln in err],
                        [ln.split(" ", 3)[3] for ln in sink.read_text().splitlines()]))
    assert emitted[0] == emitted[1]
    assert emitted[0][0] == emitted[0][1]
    assert len(emitted[0][0]) == ["error", "warning", "info", "debug"].index(level) + 1


def test_plan_merged_batches_matches_reference():
    from strique_tpu.detect import stream as jax_stream
    from strique_tpu_torch.detect import stream

    rng = np.random.default_rng(21)
    grid = sorted({stream.signal_bucket(int(n)) for n in rng.integers(2000, 120000, 60)})
    for _ in range(40):
        k = int(rng.integers(0, 7))
        buckets = sorted(rng.choice(grid, k, replace=False).tolist()) if k else []
        groups = [(int(b), int(rng.integers(1, 80))) for b in buckets]
        rng.shuffle(groups)
        assert stream.plan_merged_batches(groups) == jax_stream.plan_merged_batches(groups)
        for b, n in groups:
            assert stream._batch_cost(b, n) == jax_stream._batch_cost(b, n)


class _FakeCounter:
    """A counter of the scheduler's protocol: a read's result is a
    function of its signal; reads whose first sample is negative break
    their batch's finish, and again alone."""

    def detect_submit(self, target_name, raws, strand, preps=None):
        return {"t": target_name, "s": strand, "raws": raws}

    def detect_middle(self, state):
        return state

    def detect_mod_submit(self, state):
        return state

    def detect_finish(self, state):
        if any(r[0] < 0 for r in state["raws"]):
            raise ValueError("poisoned batch")
        return [self._one(state["t"], r, state["s"]) for r in state["raws"]]

    def detect(self, target_name, raw, strand):
        if raw[0] < 0:
            raise ValueError("poisoned read")
        return self._one(target_name, raw, strand)

    @staticmethod
    def _one(target_name, raw, strand):
        return (len(raw) % 97, float(raw[0]), float(raw[-1]), -float(len(raw)), 3, 4, "-")


class _FakeDetector:
    def __init__(self, lines):
        self.counter = _FakeCounter()
        self.jobs = lines

    def _job(self, line):
        rid, strand, targets, n = line.split()
        if n == "0":
            return None
        sig = np.full(int(n), -1.0 if rid.startswith("bad") else float(len(rid)))
        return type("SR", (), {"QNAME": rid, "strand": strand})(), targets.split(","), sig

    def decode_line(self, line):
        return self._job(line)

    def detect(self, line):
        job = self._job(line)
        if job is None:
            return None
        sr, targets, raw = job
        return {"target_counts": [(sr.QNAME, t, sr.strand, *self.counter.detect(t, raw, sr.strand))
                                  for t in targets]}


@pytest.mark.parametrize("batch_size, io_threads", [(1, 1), (1, 3), (4, 1), (4, 3), (16, 2)])
def test_run_pipeline_matches_reference(batch_size, io_threads):
    """The dispatcher and the stream scheduler over a ragged, multi-target
    stream with skipped and poisoned reads: the same rows in the same
    order as the reference's."""
    from strique_tpu.parallel.dispatcher import run_pipeline as jax_run
    from strique_tpu_torch.parallel.dispatcher import run_pipeline

    rng = np.random.default_rng(17)
    lines = []
    for k in range(70):
        n = int(rng.choice([0, 1500, 2100, 3000, 5000, 9000, 20000]))
        targets = ",".join(rng.choice(["c9", "fmr1", "c9,fmr1"], 1))
        rid = ("bad" if k % 23 == 5 else "r") + f"-{k}"
        lines.append(f"{rid} {'+-'[k % 2]} {targets} {n}")

    class Sink:
        def __init__(self):
            self.rows = []

        def write_line(self, target_counts=()):
            self.rows.append(list(target_counts))

    got, ref = Sink(), Sink()
    assert (run_pipeline(iter(lines), _FakeDetector(lines), got, io_threads, batch_size)
            == jax_run(iter(lines), _FakeDetector(lines), ref, io_threads, batch_size)
            == len(lines))
    assert got.rows == ref.rows
    assert sum(len(r) for r in got.rows) > 40
