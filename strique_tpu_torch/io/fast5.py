"""Fast5 raw-signal store: indexing, retrieval, extraction, in-place edits.

Fills the role of the reference's ``fast5Index`` module (reference
STRique_lib/fast5Index.py:45-245) with a first-party design on h5py —
no ont_fast5_api.  Three container layouts are understood:

  * **single** — one read per file: a ``Signal`` dataset somewhere under
    ``/Raw``, with the read ID stored as a ``read_id`` attribute on the
    dataset's parent group;
  * **bulk** — one top-level group per read, each nesting the single
    layout;
  * **tar** — a tar archive of single-read fast5 files.

Everything routes through :class:`Locator`, a parsed form of one index
entry.  The on-disk index format is the reference's (``container[/member]
<TAB> read_id`` with container paths relative to the index file's
directory), so existing STRique indices load unchanged.

The port's copy of ``strique_tpu/io/fast5.py`` (tests/test_torch_copies.py
and tests/test_torch_extract.py pin the two equal), with one
difference: ``h5py`` is imported inside the functions that open a
container, not when the module loads, so the CLI imports on a host
without h5py.
"""
from __future__ import annotations

import glob
import os
import shutil
import tarfile
import tempfile
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..utils.logging import LogLevel, log

SINGLE, BULK, TAR = "single", "bulk", "tar"


# ---------------------------------------------------------------------------
# HDF5 layout helpers
# ---------------------------------------------------------------------------

def _signal_path(group: h5py.Group) -> str:
    """Path of the Signal dataset below ``group`` (first match wins)."""
    hit = group.visit(lambda name: name if "Signal" in name else None)
    if hit is None:
        raise KeyError(f"no Signal dataset under {group.name}")
    return hit


def _decode_attr(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


def _raw_group_id(h5: h5py.File | h5py.Group, base: str = "") -> str:
    """read_id attribute of the group holding the Signal dataset."""
    raw = h5[f"{base}/Raw" if base else "/Raw"]
    parent = _signal_path(raw).rpartition("/")[0]
    holder = raw[parent] if parent else raw
    return _decode_attr(holder.attrs["read_id"])


def read_id_single(f5_file: str) -> str:
    """Read ID of a single-read fast5."""
    import h5py

    with h5py.File(f5_file, "r") as h5:
        return _raw_group_id(h5)


def read_ids_multi(f5_file: str) -> list[tuple[str, str]]:
    """(group name, read ID) pairs of a bulk fast5."""
    import h5py

    with h5py.File(f5_file, "r") as h5:
        return [(name, _raw_group_id(h5, name)) for name in h5]


def is_multi_read(f5_file: str) -> bool:
    """True when the file uses the bulk (group-per-read) layout."""
    import h5py

    with h5py.File(f5_file, "r") as h5:
        if "Raw" in h5:
            return False
        return any(isinstance(h5[name], h5py.Group) and "Raw" in h5[name] for name in h5)


# ---------------------------------------------------------------------------
# index entries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Locator:
    """Parsed index entry: which container holds a read, and where."""

    kind: str        # SINGLE | BULK | TAR
    container: str   # container file path (relative to the index dir)
    member: str = "" # bulk group name / tar member path

    @classmethod
    def parse(cls, entry: str) -> "Locator":
        hits = [(entry.find(ext), ext, kind)
                for ext, kind in ((".fast5/", BULK), (".tar/", TAR))]
        hits = [h for h in hits if h[0] >= 0]
        if not hits:
            return cls(SINGLE, entry)
        cut, ext, kind = min(hits)  # earliest container suffix in the path
        split = cut + len(ext) - 1
        return cls(kind, entry[:split], entry[split + 1 :])


def _candidate_files(root: str, recursive: bool) -> list[str]:
    """Container files to index below ``root`` (or ``root`` itself)."""
    if os.path.isfile(root):
        return [root]
    if recursive:
        return [os.path.join(dirpath, name)
                for dirpath, _, names in os.walk(root)
                for name in names if name.endswith((".fast5", ".tar"))]
    found = []
    for pattern in ("*.fast5", "*.tar"):
        found.extend(glob.glob(os.path.join(root, pattern)))
    return found


def index(input_path: str, recursive: bool = False, output_prefix: str = "",
          tmp_prefix: str | None = None):
    """Yield ``container[/member]\tread_id`` lines for every read found.

    Unreadable files are reported and skipped so one corrupt fast5 never
    aborts an indexing run.
    """
    if tmp_prefix and not os.path.exists(tmp_prefix):
        os.makedirs(tmp_prefix)
    for path in _candidate_files(input_path, recursive):
        rel = os.path.normpath(os.path.join(
            output_prefix,
            os.path.relpath(path, start=input_path) if not os.path.isfile(input_path)
            else os.path.basename(path)))
        try:
            if path.endswith(".tar"):
                yield from _index_tar(path, rel, tmp_prefix)
            elif is_multi_read(path):
                for group, rid in read_ids_multi(path):
                    yield f"{os.path.join(rel, group)}\t{rid}"
            else:
                yield f"{rel}\t{read_id_single(path)}"
        except Exception as exc:
            log(f"Fast5: skipping unreadable container {path} ({exc})", LogLevel.Warning)


def _index_tar(tar_path: str, rel: str, tmp_prefix: str | None):
    """Index every single-read fast5 member of a tar archive."""
    with tempfile.TemporaryDirectory(prefix=tmp_prefix) as staging, \
            tarfile.open(tar_path) as archive:
        archive.extractall(path=staging, filter="data")
        for dirpath, _, names in os.walk(staging):
            for name in names:
                if not name.endswith(".fast5"):
                    continue
                extracted = os.path.join(dirpath, name)
                member = os.path.relpath(extracted, start=staging)
                try:
                    rid = read_id_single(extracted)
                except Exception as exc:
                    log(f"Fast5: skipping unreadable tar member {member} of "
                        f"{tar_path} ({exc})", LogLevel.Warning)
                    continue
                yield f"{os.path.normpath(os.path.join(rel, member))}\t{rid}"


# ---------------------------------------------------------------------------
# random access
# ---------------------------------------------------------------------------

class Fast5Index:
    """Random access to indexed raw signals by read ID."""

    def __init__(self, index_file: str | None = None, tmp_prefix: str | None = None):
        self.index_file = index_file
        self.tmp_prefix = tmp_prefix
        self._entries: dict[str, str] = {}
        self.index_dir = ""
        if index_file is not None:
            if not os.path.exists(index_file):
                raise RuntimeError(f"Fast5 index {index_file} does not exist")
            self.index_dir = os.path.dirname(index_file)
            with open(index_file, "r") as fp:
                for line in fp:
                    line = line.rstrip("\n")
                    if line:
                        entry, _, rid = line.rpartition("\t")
                        self._entries[rid] = entry

    def __contains__(self, read_id: str) -> bool:
        return read_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def _locate(self, read_id: str) -> Locator:
        entry = self._entries.get(read_id)
        if entry is None:
            raise RuntimeError(f"read {read_id} is not in index {self.index_file}")
        return Locator.parse(entry)

    def _abs(self, container: str) -> str:
        return os.path.join(self.index_dir, container)

    def get_raw(self, read_id: str) -> np.ndarray:
        """Raw signal for one read, whichever container holds it."""
        loc = self._locate(read_id)
        if loc.kind == SINGLE:
            return _read_signal(self._abs(loc.container))
        if loc.kind == BULK:
            return _read_signal(self._abs(loc.container), base=loc.member)
        with tempfile.TemporaryDirectory(prefix=self.tmp_prefix) as staging, \
                tarfile.open(self._abs(loc.container)) as archive:
            member = archive.getmember(loc.member)
            archive.extract(member, path=staging, filter="data")
            return _read_signal(os.path.join(staging, member.name))

    def set_raw(self, read_id: str, signal: np.ndarray) -> None:
        """Replace a read's stored signal in place (single/bulk only)."""
        loc = self._locate(read_id)
        if loc.kind == TAR:
            raise RuntimeError("cannot rewrite a signal inside a tar archive; "
                               "extract the read first")
        _write_signal(self._abs(loc.container), signal,
                      base=loc.member if loc.kind == BULK else "")

    # -- extraction ----------------------------------------------------------

    def materialize_reads(self, read_ids, output: str) -> None:
        """Write the given reads into ``output`` as single-read fast5s.

        Reads are grouped by container so each bulk file / tar archive is
        opened once.
        """
        os.makedirs(output, exist_ok=True)
        by_container: dict[Locator, list[tuple[str, Locator]]] = defaultdict(list)
        for rid in read_ids:
            if rid not in self._entries:
                log(f"Fast5: read {rid} not in index, skipped for extraction",
                    LogLevel.Warning)
                continue
            loc = self._locate(rid)
            by_container[(loc.kind, loc.container)].append((rid, loc))

        for (kind, container), members in sorted(by_container.items()):
            src = self._abs(container)
            if kind == SINGLE:
                for _, loc in members:
                    shutil.copy(src, output)
            elif kind == TAR:
                # exact-path match: a read ID that is a substring of
                # another member path must not over-extract
                wanted = {os.path.normpath(loc.member) for _, loc in members}
                with tarfile.open(src) as archive:
                    for member in archive.getmembers():
                        if os.path.normpath(member.name) in wanted:
                            member.name = os.path.basename(member.name)
                            archive.extract(member, path=output, filter="data")
            else:  # BULK
                import h5py

                with h5py.File(src, "r") as bulk:
                    for rid, loc in members:
                        multi_group_to_single(
                            bulk, loc.member, os.path.join(output, f"{rid}.fast5"))

    def extract(self, input_path: str, output: str, format: str = "single") -> None:
        """Extract a batch (.tar / .fast5 / .txt ID list) into ``output``.

        ``format``: 'single' (one fast5 per read), 'bulk' (one multi-read
        fast5), or 'lazy' (keep the cheapest representation).
        """
        os.makedirs(output, exist_ok=True)
        stem, ext = os.path.splitext(input_path)
        as_bulk = format == "bulk"
        if ext == ".tar":
            if as_bulk:
                with tempfile.TemporaryDirectory(prefix=self.tmp_prefix) as staging, \
                        tarfile.open(input_path) as archive:
                    archive.extractall(path=staging, filter="data")
                    singles_to_multi(
                        _candidate_files(staging, recursive=True),
                        os.path.join(output, os.path.basename(stem) + ".fast5"))
            else:
                with tarfile.open(input_path) as archive:
                    archive.extractall(path=output, filter="data")
        elif ext == ".fast5":
            if format == "single":
                import h5py

                with h5py.File(input_path, "r") as bulk:
                    for group in bulk:
                        rid = _raw_group_id(bulk, group)
                        multi_group_to_single(bulk, group,
                                              os.path.join(output, f"{rid}.fast5"))
            else:
                shutil.copy(input_path, output)
        elif ext == ".txt":
            if not self._entries:
                raise RuntimeError("extracting by read ID requires an index file")
            with open(input_path, "r") as fp:
                ids = [line.strip() for line in fp if line.strip()]
            if as_bulk:
                with tempfile.TemporaryDirectory(prefix=self.tmp_prefix) as staging:
                    self.materialize_reads(ids, staging)
                    singles_to_multi(
                        _candidate_files(staging, recursive=True),
                        os.path.join(output, os.path.basename(stem) + ".fast5"))
            else:
                self.materialize_reads(ids, output)
        else:
            raise RuntimeError(f"unsupported batch extension {ext!r} "
                               "(expected .tar, .fast5 or .txt)")


def _read_signal(f5_file: str, base: str = "") -> np.ndarray:
    import h5py

    with h5py.File(f5_file, "r") as h5:
        raw = h5[f"{base}/Raw" if base else "Raw"]
        return raw[_signal_path(raw)][()]


def _write_signal(f5_file: str, signal: np.ndarray, base: str = "") -> None:
    import h5py

    with h5py.File(f5_file, "r+") as h5:
        raw = h5[f"{base}/Raw" if base else "Raw"]
        rel = _signal_path(raw)
        del raw[rel]
        ds = raw.create_dataset(rel, data=signal)
        ds.parent.attrs["duration"] = len(signal)


# ---------------------------------------------------------------------------
# container conversion (ont_fast5_api-compatible layouts)
# ---------------------------------------------------------------------------

# The multi-read layout written here matches what ont_fast5_api's
# single_to_multi converter produces (the reference extracts through it,
# STRique_lib/fast5Index.py:96-135,195,216), so downstream nanopore tools
# accept the output: root attr ``file_version`` = "2.0"; one
# ``read_<read_id>`` group per read carrying attr ``run_id`` and the
# subgroups ``Raw`` (read attrs + Signal dataset directly beneath) plus
# ``channel_id`` / ``context_tags`` / ``tracking_id`` lifted out of the
# single file's ``UniqueGlobalKey``.
MULTI_FILE_VERSION = "2.0"
_UGK_GROUPS = ("channel_id", "context_tags", "tracking_id")


def _copy_attrs(src, dst) -> None:
    for k, v in src.attrs.items():
        dst.attrs[k] = v


def multi_group_to_single(bulk, group: str, out_file: str) -> None:
    """Copy one bulk read group into a standalone single-read fast5.

    ont_fast5_api-shaped groups (Signal directly under ``Raw``) convert
    to the canonical single layout (``Raw/Reads/Read_<n>`` +
    ``UniqueGlobalKey``); anything else copies through unchanged.
    """
    import h5py

    g = bulk[group]
    raw = g.get("Raw")
    ont_shaped = isinstance(raw, h5py.Group) and isinstance(raw.get("Signal"), h5py.Dataset)
    with h5py.File(out_file, "w") as out:
        if not ont_shaped:
            for key in g:
                bulk.copy(g[key], out, name=key)
            _copy_attrs(g, out)
            return
        read_number = int(raw.attrs.get("read_number", 0))
        read_grp = out.create_group(f"Raw/Reads/Read_{read_number}")
        _copy_attrs(raw, read_grp)
        for key in raw:  # Signal plus any sibling datasets/groups
            bulk.copy(raw[key], read_grp, name=key)
        ugk = out.create_group("UniqueGlobalKey")
        for name in _UGK_GROUPS:
            if name in g:
                bulk.copy(g[name], ugk, name=name)  # attrs AND children
            else:
                ugk.create_group(name)
        # anything else the read group carries (Analyses, extra UGK-style
        # groups, ...) passes through at the single file's top level;
        # a child literally named UniqueGlobalKey would collide with the
        # group created above, so merge its children into it instead
        for key in g:
            if key == "Raw" or key in _UGK_GROUPS:
                continue
            if key == "UniqueGlobalKey":
                for sub in g[key]:
                    if sub not in ugk:
                        bulk.copy(g[key][sub], ugk, name=sub)
                continue
            bulk.copy(g[key], out, name=key)
        _copy_attrs(g, out)


def singles_to_multi(f5_files, out_file: str) -> None:
    """Pack single-read fast5 files into one ont-compatible multi-read fast5."""
    import h5py

    with h5py.File(out_file, "w") as out:
        out.attrs["file_version"] = MULTI_FILE_VERSION
        for f5_file in f5_files:
            with h5py.File(f5_file, "r") as src:
                grp = out.create_group(f"read_{read_id_single(f5_file)}")
                raw_holder = src["Raw"]
                sig_rel = _signal_path(raw_holder)
                sig = raw_holder[sig_rel]
                raw_out = grp.create_group("Raw")
                _copy_attrs(sig.parent, raw_out)
                sig_leaf = sig.name.rsplit("/", 1)[-1]
                for key in sig.parent:  # Signal plus any sibling content
                    src.copy(sig.parent[key], raw_out,
                             name="Signal" if key == sig_leaf else key)
                ugk = src.get("UniqueGlobalKey")
                run_id = b""
                if ugk is not None:
                    for name in ugk:  # attrs AND children, all groups
                        src.copy(ugk[name], grp, name=name)
                        if name == "tracking_id" and "run_id" in ugk[name].attrs:
                            run_id = ugk[name].attrs["run_id"]
                # non-Raw top-level content (Analyses, ...) rides along
                # inside the read group, as ont_fast5_api lays it out
                for key in src:
                    if key not in ("Raw", "UniqueGlobalKey"):
                        src.copy(src[key], grp, name=key)
                grp.attrs["run_id"] = run_id
