"""A tiny run of each cell on the CPU through its runner's rehearsal
(`benchmark/tests/rehearse_<runner>.py`: for `session`, the port's plain
paths, K1's twin in the card's session schedule), the control, each fault
the cell's runner names, and the trace's reduction.

The runs skip the harness's look for a card and drive the rest: the
runner, the check against the plain reference with the cell's own limits,
the metric readers and the result line.  The faults are planted as
`readings.py --fault` plants them on the card."""

import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

import readings
from brtbench import main, spec, tracing

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 101


KINDS = {name: spec.load_cell(name).traffic["runner"] for name in CELLS}
FAULT_CASES = [pytest.param(name, fault, id=f"{name}-{fault}")
               for name in CELLS
               for fault in sorted(spec.runner(KINDS[name]).FAULTS)]
SESSION_CELLS = [name for name in CELLS if KINDS[name] == "session"]


def _runner(name):
    """The cell's runner and its CPU rehearsal."""
    return spec.runner(KINDS[name]), spec.rehearsal(KINDS[name])


def _run(monkeypatch, capsys, name, fault=None, trace=0):
    runner, helper = _runner(name)
    cell = helper.tiny_cell(name, fault)
    monkeypatch.setattr(spec, "load_cell", lambda n, *a, **k: cell)
    if trace:
        helper.trace(monkeypatch, runner)
        monkeypatch.setattr(spec, "runner", lambda n, *a, **k: runner)
    session = helper.make_session
    if fault is not None:
        session = runner.FAULTS[fault](session)
    rc = main.main(["--workload", name, "--seed", str(SEED), "--seconds",
                    "0.2", "--trace", str(trace)], time.perf_counter(),
                   device="cpu", make_session=session, sync=helper.sync)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal_is_correct(monkeypatch, capsys, name):
    out = _run(monkeypatch, capsys, name)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    cell = spec.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == list(_runner(name)[0].NUMBERS)


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_is_correct(monkeypatch, capsys, name):
    """--trace 1: the same check, the cell's per-layer metrics that found
    something to read, the traced window and the breakdown."""
    out = _run(monkeypatch, capsys, name, trace=1)
    assert out["correct"] is True and out["failed"] == 0
    cell = spec.load_cell(name)
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] >= 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == list(_runner(name)[0].NUMBERS)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                    "--trace", "0"], time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""


def test_jax_loaded_no_result(monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    runner, helper = _runner(CELLS[1])
    cell = helper.tiny_cell(CELLS[1])
    monkeypatch.setattr(spec, "load_cell", lambda n, *a, **k: cell)
    rc = main.main(["--workload", CELLS[1], "--seed", "3", "--seconds",
                    "0.1", "--trace", "0"], time.perf_counter(),
                   device="cpu", make_session=helper.make_session,
                   sync=helper.sync)
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jax" in captured.err


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(monkeypatch, capsys, name):
    """The control in the program's place (for `session`, the plain
    reference at bfloat16) fails one of the cell's limits or more; the
    program passes them on the same inputs."""
    runner, helper = _runner(name)
    cell = helper.tiny_cell(name)
    monkeypatch.setattr(spec, "load_cell", lambda n, *a, **k: cell)
    assert readings.main(["--workload", name, "--seeds", f"{SEED},7",
                          "--seconds", "0.1"], device="cpu",
                         make_session=helper.make_session,
                         sync=helper.sync) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = cell.check["limits"]
    assert len(lines) == 3
    for ln in lines[:-1]:
        assert ln["correct"] is True
        assert not all(ln["control"][k] <= limits[k]
                       for k in runner.NUMBERS)


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_each_fault_is_not_correct(monkeypatch, capsys, name, fault):
    """Each fault of the cell's runner planted in the program's session
    comes out not correct, at the size the rehearsal gives that fault (the
    block fault on every pixel of the tiny frame, where its band is two
    rows of 24, 8%)."""
    out = _run(monkeypatch, capsys, name, fault=fault)
    assert out["correct"] is False


@pytest.mark.parametrize("name", SESSION_CELLS)
def test_block_fault_moves_no_median_and_no_bias(monkeypatch, capsys, name):
    """The block fault is caught by the share of pixels off, alone."""
    out = _run(monkeypatch, capsys, name, fault="block")
    limits = spec.load_cell(name).check["limits"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["bad_frac"] > limits["bad_frac"]
    assert checks["median_err"] <= limits["median_err"]
    assert checks["mean_bias"] <= limits["mean_bias"]


@pytest.mark.parametrize("name", SESSION_CELLS)
def test_mix_with_a_key_the_runner_does_not_read_is_refused(name):
    runner, helper = _runner(name)
    cell = helper.tiny_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, clients=4))
    with pytest.raises(ValueError, match="clients"):
        runner.run(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                   make_session=helper.make_session, sync=helper.sync)


@pytest.mark.parametrize("name", SESSION_CELLS)
@pytest.mark.parametrize("change,match", [
    (lambda c: dict(c, check=dict(c["check"], limits=dict(
        c["check"]["limits"], grad_max_rel=1e-3))), "limits"),
    (lambda c: dict(c, check=dict(c["check"], pixels=32 * 24 + 1)),
     "more than a frame"),
    (lambda c: dict(c, traffic=dict(c["traffic"], samples_per_pixel=0)),
     "a sample"),
    (lambda c: dict(c, config=dict(c["config"], max_depth=0)), "a sample"),
], ids=["limits", "pixels", "spp", "depth"])
def test_a_cell_the_session_runner_cannot_run_is_refused(name, change,
                                                         match):
    """The image check's numbers alone, as many checked pixels as a frame
    has at most, and a sample and a bounce a path, or no run."""
    runner, helper = _runner(name)
    cell = helper.tiny_cell(name)
    cell = dataclasses.replace(cell, **change(dataclasses.asdict(cell)))
    with pytest.raises(ValueError, match=match):
        runner.validate(cell)


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_readings_of_a_planted_fault(monkeypatch, capsys, name, fault):
    """`readings.py --fault` plants the fault of the cell's runner in the
    program's session, as on the card at the cell's size, and reads every
    run not correct."""
    runner, helper = _runner(name)
    cell = helper.tiny_cell(name, fault)
    monkeypatch.setattr(spec, "load_cell", lambda n, *a, **k: cell)
    assert readings.main(["--workload", name, "--seeds", f"{SEED},7",
                          "--seconds", "0.1", "--fault", fault],
                         device="cpu", make_session=helper.make_session,
                         sync=helper.sync) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [ln["correct"] for ln in lines[:-1]] == [False, False]
    assert lines[-1]["fault"] == fault
    assert lines[-1]["every_run_not_correct"] is True


def test_readings_refuses_a_fault_the_runner_does_not_have(monkeypatch,
                                                            capsys):
    runner, helper = _runner(CELLS[0])
    cell = helper.tiny_cell(CELLS[0])
    monkeypatch.setattr(spec, "load_cell", lambda n, *a, **k: cell)
    with pytest.raises(SystemExit) as exc:
        readings.main(["--workload", CELLS[0], "--seeds", "1", "--fault",
                       "no_such_fault"], device="cpu")
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


class _FakeEvent:
    def __init__(self, name, start, end, act="kernel"):
        self._n, self._s, self._e, self._a = name, start, end, act

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def activity_type(self):
        return self._a

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


class _OlderEvent(_FakeEvent):
    """An event of a profiler whose events do not name their activity."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


@pytest.mark.parametrize("event", [_FakeEvent, _OlderEvent])
def test_trace_reduction(event):
    """Busy time as the union of device intervals inside the window, kernel
    time by name, idle gaps by the host step at their middle."""
    off = 10**9  # the trace's clock runs 1 s ahead of the host's
    ev = [event("fill", off + 0, off + 5),  # the marker
          event("k1_render_kernel<true>", off + 110, off + 150),
          event("copy", off + 140, off + 160, "gpu_memcpy"),
          event("k1_render_kernel<true>", off + 230, off + 280)]
    if event is _FakeEvent:  # an activity that is not the device's work
        ev.append(event("annotation", off + 100, off + 300,
                        "gpu_user_annotation"))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    marks = np.array([[100, 100, 120, 170], [200, 210, 220, 290]])
    steps = ("camera", "render_frame", "synchronize")
    tr = tracing.reduce(prof, 0, marks, steps)
    assert tr.window_s == pytest.approx(190e-9)
    assert tr.busy_s == pytest.approx(100e-9)  # 110-160 and 230-280
    assert tr.kernel_seconds("k1_render_kernel") == (pytest.approx(90e-9), 2)
    # Gaps: 100-110 (render_frame), 160-230 (middle 195: harness),
    # 280-290 (synchronize).
    assert tr.idle_by_step == pytest.approx(
        {"render_frame": 10e-9, "harness": 70e-9, "synchronize": 10e-9})
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("k1_render_kernel")
    assert bd["idle_gaps"][0][0] == "harness"


def test_trace_reduction_takes_the_runners_steps():
    """Another runner's steps label the gaps: marks have one column more
    than it has steps."""
    off = 5
    ev = [_FakeEvent("fill", off + 0, off + 1),
          _FakeEvent("k2_record_kernel", off + 20, off + 60),
          _FakeEvent("k3_replay_grad_kernel", off + 70, off + 90)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    marks = np.array([[10, 65, 100]])
    tr = tracing.reduce(prof, 0, marks, ("render", "backward"))
    assert tr.busy_s == pytest.approx(60e-9)
    assert tr.idle_by_step == pytest.approx(
        {"render": 10e-9, "backward": 20e-9})
    with pytest.raises(ValueError):
        tracing.reduce(prof, 0, marks, ("camera", "render_frame",
                                        "synchronize"))
