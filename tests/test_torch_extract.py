"""The port's ``plot`` and ``extract`` commands and its fast5 masker
against strique_tpu's, on the CPU (h5py and matplotlib).

One synthetic run (``_run``): three single-read fast5 files, a bulk file
in ont_fast5_api's layout (three reads, UniqueGlobalKey groups and
attributes), a tar archive of two single files carrying an Analyses
group, a fofn from the port's ``fast5.index``, a read-ID list naming one
read of each container and one read not in the index, and a count TSV.

  * ``plot``: ``_iter_count_rows`` yields the JAX CLI's rows, the
    signals and rows handed to ``_render_read_figure`` are the JAX
    CLI's, and the PNG files are written under the reference's names;
  * ``extract`` in ``single``, ``bulk`` and ``lazy`` from the bulk
    ``.fast5``, the ``.tar`` and the ``.txt`` ID list writes the files
    of the JAX ``extract``: the same names, and in each fast5 the same
    groups, datasets and attributes;
  * ``mask_counts`` (``single`` and ``bulk``) masks the same reads to
    the same signals and files as the JAX masker.
"""
import os
import tarfile

import numpy as np
import pytest

from strique_tpu import cli as jax_cli
from strique_tpu.io import fast5 as jax_fast5
from strique_tpu.io import masker as jax_masker
from strique_tpu_torch import cli
from strique_tpu_torch.io import fast5, masker
from strique_tpu_torch.synthetic import write_single_fast5

h5py = pytest.importorskip("h5py")

SINGLES = ("s-read-0", "s-read-1", "s-read-2")
BULK = ("b-read-3", "b-read-4", "b-read-5")
TARRED = ("t-read-6", "t-read-7")
IDS = ("s-read-1", "b-read-4", "t-read-7", "not-indexed")
# (id, target, strand, count, offset, ticks); the last read is not indexed
COUNTS = [("s-read-0", "c9orf72", "+", 12, 300, 700), ("b-read-3", "fmr1", "-", 30, 1200, 900),
          ("t-read-6", "c9orf72", "+", 5, 40, 260), ("not-indexed", "c9orf72", "-", 7, 10, 20)]


def _signal(k):
    return np.random.default_rng(k).integers(300, 700, 2400 + 100 * k).astype(np.int16)


def _run(d):
    """The run's containers, fofn, ID list and count TSV in ``d``."""
    d.mkdir()
    for k, rid in enumerate(SINGLES):
        write_single_fast5(str(d / f"{rid}.fast5"), rid, _signal(k))
    with h5py.File(d / "bulk.fast5", "w") as f:
        f.attrs["file_version"] = "2.0"
        for k, rid in enumerate(BULK, start=3):
            g = f.create_group(f"read_{rid}")
            g.attrs["run_id"] = np.bytes_(b"run0001")
            raw = g.create_group("Raw")
            raw.attrs["read_id"] = np.bytes_(rid.encode())
            raw.attrs["read_number"] = np.uint32(100 + k)
            raw.create_dataset("Signal", data=_signal(k))
            for name in ("channel_id", "context_tags", "tracking_id"):
                g.create_group(name)
            g["channel_id"].attrs["sampling_rate"] = np.float64(4000.0)
            g["tracking_id"].attrs["run_id"] = np.bytes_(b"run0001")
    staging = d / "staging"
    staging.mkdir()
    with tarfile.open(d / "batch.tar", "w") as tf:
        for k, rid in enumerate(TARRED, start=6):
            path = staging / f"{rid}.fast5"
            write_single_fast5(str(path), rid, _signal(k))
            with h5py.File(path, "r+") as f:
                f.create_group("UniqueGlobalKey/tracking_id").attrs["run_id"] = np.bytes_(b"r9")
                f.create_dataset("Analyses/Basecall/Fastq", data=np.bytes_(b"@r\nACGT\n"))
            tf.add(path, arcname=f"reads/{rid}.fast5")
            path.unlink()
    staging.rmdir()
    (d / "reads.fofn").write_text("\n".join(fast5.index(str(d))) + "\n")
    (d / "ids.txt").write_text("\n".join(IDS) + "\n")
    rows = ["ID\ttarget\tstrand\tcount\tscore_prefix\tscore_suffix\tlog_p\toffset\tticks\tmod"]
    rows += [f"{r}\t{t}\t{s}\t{n}\t8.5\t7.25\t-1234.5\t{o}\t{k}\t-" for r, t, s, n, o, k in COUNTS]
    (d / "counts.tsv").write_text("\n".join(rows) + "\n")
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("extract") / "run")


def _attrs(obj):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes()) for k, v in obj.attrs.items()}


def _h5_tree(path):
    """Every group and dataset of an HDF5 file: attributes, and for a
    dataset its dtype, shape and bytes."""
    with h5py.File(path, "r") as f:
        out = {"/": _attrs(f)}

        def visit(name, obj):
            entry = {"attrs": _attrs(obj)}
            if isinstance(obj, h5py.Dataset):
                entry["data"] = (obj.dtype.str, obj.shape, np.asarray(obj[()]).tobytes())
            out[name] = entry

        f.visititems(visit)
    return out


def _dir_tree(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, d)
            out[rel] = _h5_tree(path) if name.endswith(".fast5") else open(path, "rb").read()
    return out


def test_iter_count_rows_and_plot(run, tmp_path, monkeypatch):
    counts = str(run / "counts.tsv")
    rows = list(cli._iter_count_rows(counts))
    assert rows == list(jax_cli._iter_count_rows(counts)) and len(rows) == len(COUNTS)
    calls = {}
    for mod, name in ((cli, "port"), (jax_cli, "jax")):
        real = mod._render_read_figure
        seen = calls.setdefault(name, [])

        def spy(plt, signal, row, zoom, margin_frac, real=real, seen=seen):
            seen.append((np.array(signal), dict(row), zoom, margin_frac))
            return real(plt, signal, row, zoom, margin_frac)

        monkeypatch.setattr(mod, "_render_read_figure", spy)
        args = ["plot", str(run / "reads.fofn"), "--counts", counts, "--output",
                str(tmp_path / name), "--width", "4", "--height", "3", "--dpi", "20",
                "--zoom", "100"]
        assert mod.main(args) == 0
    assert len(calls["port"]) == len(calls["jax"]) == len(COUNTS) - 1
    for (s, r, z, m), (s2, r2, z2, m2) in zip(calls["port"], calls["jax"]):
        assert s.tobytes() == s2.tobytes() and (r, z, m) == (r2, z2, m2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(f"{r}_{t}_{n}.png" for r, t, _s, n, _o, _k in COUNTS[:-1])


@pytest.mark.parametrize("fmt", ["single", "bulk", "lazy"])
@pytest.mark.parametrize("source", ["bulk.fast5", "batch.tar", "ids.txt"])
def test_extract_matches_jax(run, tmp_path, source, fmt):
    outs = {}
    for mod, name in ((cli, "port"), (jax_cli, "jax")):
        out = tmp_path / name
        args = ["extract", str(run / source), str(out), "--index", str(run / "reads.fofn"),
                "--output_format", fmt]
        assert mod.main(args) == 0
        outs[name] = _dir_tree(out)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) >= 1


@pytest.mark.parametrize("fmt", ["single", "bulk"])
def test_mask_counts_matches_jax(run, tmp_path, fmt):
    got = masker.mask_counts(str(run / "reads.fofn"), str(run / "counts.tsv"),
                             str(tmp_path / "port"), format=fmt)
    ref = jax_masker.mask_counts(str(run / "reads.fofn"), str(run / "counts.tsv"),
                                 str(tmp_path / "jax"), format=fmt)
    assert got == ref == len(COUNTS) - 1
    idx = fast5.Fast5Index(str(tmp_path / "port" / "reads.fofn"))
    jidx = jax_fast5.Fast5Index(str(tmp_path / "jax" / "reads.fofn"))
    src = fast5.Fast5Index(str(run / "reads.fofn"))
    for rid, _t, _s, _n, off, ticks in COUNTS[:-1]:
        sig = src.get_raw(rid)
        want = np.concatenate([sig[:off], sig[off + ticks:]])
        np.testing.assert_array_equal(idx.get_raw(rid), want)
        np.testing.assert_array_equal(jidx.get_raw(rid), want)
    assert _dir_tree(tmp_path / "port") == _dir_tree(tmp_path / "jax")
    assert masker.main([str(run / "reads.fofn"), str(run / "counts.tsv"),
                        str(tmp_path / "main"), "--format", fmt]) == 0
