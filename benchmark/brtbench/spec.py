"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<traffic>` is an entry of `workloads`.  Its configuration
is the file its `configs` entry names; its traffic mix is
`benchmark/traffic/<traffic>.json`; what its correctness check compares and
the limits it holds are `benchmark/cells/<cell>.json`.  A traffic mix names
its runner, `benchmark/runners/<runner>.py` (the contract is in
brtbench/main.py), whose CPU rehearsal is
`benchmark/tests/rehearse_<runner>.py`; a metric is read by
`benchmark/metrics/<metric>.py`.  So a new cell, mix, configuration,
runner or metric is a new file and an entry, and no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), with its files."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        check=load_json(bench_dir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def runner(name: str, root: Path = ROOT):
    """The module that runs a mix's items: `benchmark/runners/<name>.py`."""
    return load_module(root / "benchmark" / "runners" / f"{name}.py",
                       f"brtbench_runner_{name}")


def rehearsal(name: str, root: Path = ROOT):
    """The CPU rehearsal of the runner `name`:
    `benchmark/tests/rehearse_<name>.py`."""
    return load_module(root / "benchmark" / "tests" / f"rehearse_{name}.py",
                       f"brtbench_rehearse_{name}")


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` of `benchmark/metrics/<metric>.py`."""
    safe = metric.replace(".", "_").replace("-", "_")
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       f"brtbench_metric_{safe}").read
