"""BENCHMARK.json, and every file it names, parse and are found by name;
new cells, mixes and metrics are new files that the harness finds."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from brtbench import scene_gen, spec, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # A full check of 24 cells fits 43,200 s (run_seconds + 60 a run, 180
    # a cell to compile, 1,200 spare).
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_entries(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_every_metric_is_reported_and_read():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        spec.reader(m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        spec.reader(m["name"])
        for w in m["workloads"]:  # the metric it moves is reported there
            assert w in e2e[m["moves"]].get("workloads", cells)
    for c in cells:  # every cell: setup_s, another end-to-end, a layer
        rep = [m for m in BENCH["end_to_end"]
               if c in m.get("workloads", cells)]
        assert len(rep) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    """A cell loads by its name, its runner by the mix's, and the runner
    takes the cell: the limits are its check's numbers, and what else it
    needs of a cell (for `session`: a sample and a bounce a path, no more
    checked pixels than a frame has) holds."""
    cell = spec.load_cell(name)
    work = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert name == f"{work['config']}.{work['traffic']}"
    assert cell.chips == work["chips"] == 1
    assert cell.config["name"] == work["config"]
    runner = spec.runner(cell.traffic["runner"])
    assert set(cell.check["limits"]) == set(runner.NUMBERS)
    assert runner.FAULTS and runner.STEPS
    runner.validate(cell)
    spec.rehearsal(cell.traffic["runner"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    for key, cut in data["reduced"].items():
        assert data[key] == cut["run"] != cut["published"] and cut["why"]
    assert data["precision"] == "float32" and data["assumed"]
    assert scene_gen.build(data["scene"], 1, "cpu").count >= 1


def test_new_files_are_found_without_editing_any(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "benchmark" / "traffic" / "render64.json").write_text(
        json.dumps(dict(json.loads((ROOT / "benchmark" / "traffic" /
                                    "render.json").read_text()),
                        samples_per_pixel=64)))
    (tmp_path / "benchmark" / "cells" / "rtiow_final.render64.json"
     ).write_text((ROOT / "benchmark" / "cells" /
                   "rtiow_final.render.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "frames_total.py").write_text(
        "def read(run):\n    return run.frames\n")
    bench["workloads"].append({"name": "rtiow_final.render64",
                               "config": "rtiow_final", "traffic": "render64",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_total", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "session", "moves": "rays_per_s",
                               "workloads": ["rtiow_final.render64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("rtiow_final.render64", root=tmp_path)
    assert traffic.samples_per_pixel(cell.traffic, cell.config) == 64
    assert "frames_total" in [m["name"] for m in cell.per_layer]
    assert spec.reader("frames_total", root=tmp_path)(
        type("R", (), {"frames": 7})()) == 7
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_runner_of_another_kind_is_new_files_only(tmp_path):
    """A cell of a runner whose items are not frames (`another_runner/`:
    gradient steps of a toy least-squares problem, with check numbers,
    faults, control and CPU rehearsal of its own) added to a copy of the
    benchmark as new files and appended entries: the copy's generic tests
    take it through `main.main` (trace 0 and 1), `readings.main` with the
    control and with each of its faults, and its loading and validation,
    and no file that was there changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    toy = ROOT / "benchmark" / "tests" / "another_runner"
    entries = json.loads((toy / "entries.json").read_text())
    for src in toy.rglob("*"):
        if src.is_file() and src.suffix in (".py", ".json") and (
                src.name != "entries.json"):
            dst = bench_dir / src.relative_to(toy)
            assert not dst.exists(), dst
            dst.write_bytes(src.read_bytes())
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] += entries["workloads"]
    bench["per_layer"] += entries["per_layer"]
    for m in bench["end_to_end"]:
        m.get("workloads", []).extend(entries["reports"].get(m["name"], []))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    cell = entries["workloads"][0]["name"]
    runner = spec.runner("lsq", root=tmp_path)
    assert set(runner.NUMBERS).isdisjoint({"median_err", "bad_frac",
                                           "mean_bias"})

    spec_cases = ["test_every_metric_is_reported_and_read",
                  "test_names_units_and_entries",
                  "test_top_level_keys_and_limits"]
    out = subprocess.run(
        [sys.executable, "-m", "pytest", str(bench_dir / "tests"), "-v",
         "-p", "no:cacheprovider", f"--rootdir={tmp_path}", "-k",
         " or ".join([cell] + spec_cases)],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))  # the port, for imports
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = set(re.findall(r"::(\S+) PASSED", out.stdout))
    faults = sorted(runner.FAULTS)
    want = {f"test_cell_rehearsal_is_correct[{cell}]",
            f"test_traced_rehearsal_is_correct[{cell}]",
            f"test_control_fails_the_limits[{cell}]",
            f"test_every_cell_loads_by_name[{cell}]"}
    want |= {f"test_each_fault_is_not_correct[{cell}-{f}]" for f in faults}
    want |= {f"test_readings_of_a_planted_fault[{cell}-{f}]" for f in faults}
    assert want <= passed, sorted(want - passed)
    assert {t.split("[")[0] for t in passed} >= set(spec_cases)
    for p, data in before.items():
        assert p.read_bytes() == data, p
    grown = json.loads((tmp_path / "BENCHMARK.json").read_text())
    grown["workloads"] = grown["workloads"][:len(BENCH["workloads"])]
    grown["per_layer"] = grown["per_layer"][:len(BENCH["per_layer"])]
    for m, was in zip(grown["end_to_end"], BENCH["end_to_end"]):
        if "workloads" in m:
            m["workloads"] = m["workloads"][:len(was["workloads"])]
    assert grown == BENCH
