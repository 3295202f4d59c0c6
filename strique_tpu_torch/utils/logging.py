"""Lightweight leveled logger (replaces the reference's logger process,
reference scripts/STRique.py:55-107).

The reference needed a dedicated logging *process* because its workers
were forked; the TPU pipeline is single-process (host threads + device),
so a lock-guarded writer with the same message format suffices.

The port's own copy of ``strique_tpu/utils/logging.py``;
tests/test_torch_copies.py pins the two equal.
"""
from __future__ import annotations

import datetime
import enum
import os
import sys
import threading


class LogLevel(enum.Enum):
    Error = "[ERROR]"
    Warning = "[WARNING]"
    Info = "[INFO]"
    Debug = "[DEBUG]"


_ORDER = [LogLevel.Error, LogLevel.Warning, LogLevel.Info, LogLevel.Debug]
# sink None = "the CURRENT sys.stderr", resolved at write time — capturing
# the stream object at init time would pin a redirected/captured stderr
# that may be closed later (e.g. per-test capture buffers)
_state = {"levels": set(_ORDER[:3]), "sinks": [None], "lock": threading.Lock()}


def init(file: str | None = None, log_level: str = "info") -> None:
    n = {"error": 1, "warning": 2, "info": 3, "debug": 4}.get(log_level, 3)
    _state["levels"] = set(_ORDER[:n])
    _state["sinks"] = [None]
    if file:
        parent = os.path.abspath(os.path.dirname(file)) or "."
        if (os.path.isfile(file) and os.access(file, os.W_OK)) or os.access(parent, os.W_OK):
            _state["sinks"].append(file)
        else:
            log(f"Log-file {file} is not accessible", LogLevel.Error)


def close() -> None:
    _state["sinks"] = [None]


def log(message: str, level: LogLevel = LogLevel.Info) -> None:
    if level not in _state["levels"]:
        return
    line = " ".join([
        datetime.datetime.now().strftime("%d.%m.%Y %H:%M:%S"),
        f"[PID {os.getpid()}]", str(level.value), message])
    with _state["lock"]:
        for sink in _state["sinks"]:
            if isinstance(sink, str):
                try:
                    with open(sink, "a") as fp:
                        print(line, file=fp)
                except OSError:
                    # unwritable/full log file: fall back to stderr so the
                    # message is not silently dropped (the swallow-all case
                    # only concerns redirected stream sinks closing under us)
                    try:
                        print(line, file=sys.stderr)
                    except (ValueError, OSError):
                        pass
            else:
                stream = sys.stderr if sink is None else sink
                try:
                    print(line, file=stream)
                    stream.flush()
                except (ValueError, OSError):
                    pass  # a redirected sink closed under us; logging must not raise
