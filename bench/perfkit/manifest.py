"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a file of its own: ``bench/configs/<config>.json`` (the entry's
``file``), ``bench/traffic/<traffic>.json``, and the cell's own sizing and
correctness limits in ``bench/cells/<workload>.json``.  A pair of
configuration and traffic names one cell, so a mix that states its
``data_ranks`` runs only on that many chips.  A per-layer metric
is read by ``bench/metrics/<metric>.py``.  Adding a cell adds files and
entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry ``name`` with its configuration, traffic mix,
    cell file and metric entries resolved."""
    m = manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; known: "
                       f"{sorted(by_name)}")
    w = dict(by_name[name])
    conf_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    w["conf"] = load_json(root / conf_entry["file"])
    w["conf_entry"] = conf_entry
    w["mix"] = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    if w["mix"].get("data_ranks", w["chips"]) != w["chips"]:
        raise ValueError(f"{name}: traffic {w['traffic']!r} is for "
                         f"{w['mix']['data_ranks']} data ranks, the cell "
                         f"asks for {w['chips']} chips")
    w["sizing"] = load_json(BENCH / "cells" / f"{name}.json")
    w["end_to_end"] = [e for e in m["end_to_end"] if name in
                       e.get("workloads", [name])]
    w["per_layer"] = [e for e in m["per_layer"] if name in
                      e.get("workloads", [name])]
    w["run_seconds"] = m["run_seconds"]
    return w


def metric_reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
