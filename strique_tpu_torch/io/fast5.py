"""Fast5 raw-signal store: indexing, retrieval, in-place edits.

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

The port's copy of ``strique_tpu/io/fast5.py`` up to ``Fast5Index``'s
reads and writes (tests/test_torch_copies.py pins the two equal), with
one difference: ``h5py`` is imported inside the functions that open a
container, not when the module loads, so the CLI imports on a host
without h5py.  The reference's extraction half (``materialize_reads``,
``extract`` and the container conversions) waits for the ``extract``
subcommand (ROADMAP).
"""
from __future__ import annotations

import glob
import os
import tarfile
import tempfile
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
