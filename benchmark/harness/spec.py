"""The benchmark's data: ``BENCHMARK.json``, the cell, its configuration.

Everything that belongs to one cell, configuration or per-layer metric
sits in a file of its own, found by its name:

  * ``benchmark/workloads/<cell>.json``: its configuration, its traffic
    generator (``benchmark/traffic/<generator>.py``) and the generator's
    parameters, the batch size, the reads the check compares;
  * ``benchmark/configs/<config>.json``: the locus, alignment and HMM
    parameters and the model's shape, and optionally ``mod_model``,
    ``{"shift_pA": <float>}``: the configuration calls methylation with a
    5mC twin of the run's seeded model, the model with ``shift_pA`` added
    to the level of every k-mer that contains ``CG`` (stdvs unchanged),
    which the harness writes in set-up and hands to the generator, the
    detector and the reference; an allele of such a cell may carry
    ``"methylation"`` (``traffic/pool.py``);
  * ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.

A traffic generator has ``write_model(path, seed, k)``,
``write_mod_model(path, seed, k, shift_pA)``, ``methylation(params)``
and ``make_pool(model_file, locus, params, seed, mod_model_file)``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _named(kind: str, name: str, suffix: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = os.path.join(HERE, kind, name + suffix)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {os.path.relpath(path, ROOT)}")
    return path


def cell(name: str) -> dict:
    """The cell's file, with ``name`` and its ``config`` file loaded."""
    spec = _load_json(_named("workloads", name, ".json"))
    spec["name"] = name
    spec["config_spec"] = _load_json(_named("configs", spec["config"], ".json"))
    return spec


def module(kind: str, name: str):
    """The Python module ``benchmark/<kind>/<name>.py``."""
    path = _named(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, section: str) -> list:
    """The ``section`` metrics of ``BENCHMARK.json`` this cell reports."""
    return [m for m in bench[section] if "workloads" not in m or cell_name in m["workloads"]]
