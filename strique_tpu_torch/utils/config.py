"""Configuration parsing (reference scripts/STRique.py:836-868).

Repeat config TSV: ``chr begin end name repeat prefix suffix`` (header
required); parameter JSON with ``align`` and ``HMM`` sections — missing
keys get code defaults, unknown keys are ignored downstream.

The port's own copy of ``strique_tpu/utils/config.py``;
tests/test_torch_copies.py pins the two equal.
"""
from __future__ import annotations

import json

from .logging import log, LogLevel


def parse_config(repeat_config_file: str, param_config_file: str | None = None) -> dict:
    repeats = {}
    with open(repeat_config_file, "r") as fp:
        next(fp)  # header
        for line in fp:
            cols = line.rstrip().split()
            if len(cols) == 7:
                repeats[cols[3]] = (cols[0], int(cols[1]), int(cols[2]), cols[4], cols[5], cols[6])
            elif cols:
                log(f"Config: Repeat config column mismatch while parsing \n{line}", LogLevel.Error)
    config = {"repeat": repeats, "align": None, "HMM": None}
    if param_config_file:
        with open(param_config_file) as fp:
            ld_conf = json.load(fp)
        if not (isinstance(ld_conf, dict) and isinstance(ld_conf.get("align"), dict)
                and isinstance(ld_conf.get("HMM"), dict)):
            raise SystemExit("Config: file format broken (need 'align' and 'HMM' dict sections)")
        config["align"] = ld_conf["align"]
        config["HMM"] = ld_conf["HMM"]
    return config
