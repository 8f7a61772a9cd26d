"""The port's bench, `bench_torch.py`, on the CPU at a few pixels: its one
JSON line, its parity gate (the reference bench's thresholds and
statistics), the gate failing on a wrong image, and no run without a card
unless the CPU is asked for.

bench.py imports only numpy at module level, so it is loaded by path, as
tests/test_scaling_tool.py loads tools/scaling.py.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from bevy_raytrace_tpu_torch import parity

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "reference_bench", os.path.join(_REPO, "bench.py"))
reference_bench = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(reference_bench)

ARGV = ["--device", "cpu", "--backend", "pallas", "--width", "16",
        "--height", "8", "--spp", "2", "--depth", "3", "--repeats", "1"]


@pytest.fixture
def tiny(monkeypatch):
    """Every size of the bench shrunk to a few pixels, 2 spp, depth 3."""
    for name, value in (("VERIFY_W", 24), ("VERIFY_H", 16), ("VERIFY_SPP", 2),
                        ("VERIFY_DEPTH", 3), ("GRAD_SHAPE", (16, 8, 2, 3)),
                        ("GRAD_FLAGSHIP_SHAPE", (16, 8, 2, 3)),
                        ("REFERENCE_SHAPE", (16, 8, 3)),
                        ("REFERENCE_SPP", 2)):
        monkeypatch.setattr(bench_torch, name, value)


def test_bench_prints_one_line(tiny, capsys, tmp_path):
    assert bench_torch.main(ARGV + ["--trace", str(tmp_path)]) == 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == bench_torch.KEYS
    assert line["verify"] == "pass" and line["unit"] == "rays/s"
    assert line["device"] is None  # no card: no card's name
    rates = {k: v for k, v in line.items()
             if k not in ("metric", "unit", "verify", "device")}
    assert all(np.isfinite(v) and v > 0 for v in rates.values()), rates
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / reference_bench.REFERENCE_IMPLIED_RAYS_PER_SEC)
    assert "197-sphere" in line["metric"]


def test_gate_is_the_reference_bench_gate():
    """The gate's config and thresholds are bench.py's, and its statistics
    are bench.py:133-140's formula on the same pair of images."""
    rb = reference_bench
    assert (bench_torch.VERIFY_W, bench_torch.VERIFY_H, bench_torch.VERIFY_SPP,
            bench_torch.VERIFY_DEPTH) == (rb.VERIFY_W, rb.VERIFY_H,
                                          rb.VERIFY_SPP, rb.VERIFY_DEPTH)
    assert parity.COMPILED == parity.Thresholds(
        median=rb.VERIFY_MEDIAN, bad_tol=rb.VERIFY_BAD_TOL,
        bad_frac=rb.VERIFY_BAD_FRAC, mean_bias=rb.VERIFY_MEAN_BIAS)
    assert bench_torch.REFERENCE_IMPLIED_RAYS_PER_SEC == (
        rb.REFERENCE_IMPLIED_RAYS_PER_SEC)

    rng = np.random.default_rng(12)
    b = rng.random((16, 24, 3), dtype=np.float32)
    a = b + (rng.standard_normal(b.shape) * 3e-3).astype(np.float32)
    d = a - b  # bench.py:133-136, in the images' float32
    err = np.abs(d).max(axis=-1)
    med = float(np.median(err))
    bad = float((err > rb.VERIFY_BAD_TOL).mean())
    bias = float(np.abs(d.mean(axis=(0, 1))).max())
    got = parity.compare(a, b, parity.COMPILED)
    # parity.compare works in float64: the float32 difference and mean
    # differ from it in their last bits only.
    np.testing.assert_allclose([got["median"], got["mean_bias"]],
                               [med, bias], rtol=1e-5)
    assert got["bad_frac"] == bad and 0.0 < bad < 1.0
    assert got["ok"] == (np.isfinite(err).all() and med <= rb.VERIFY_MEDIAN
                         and bad <= rb.VERIFY_BAD_FRAC
                         and bias <= rb.VERIFY_MEAN_BIAS)


def test_gate_fails_on_a_wrong_image(tiny, monkeypatch, capsys):
    """K1's render off by 0.1 in one channel: the `verify: "fail"` line
    and exit code 1, before anything is timed."""
    from bevy_raytrace_tpu_torch.kernels import render_lanes

    real = render_lanes.render_mxu_balanced

    def wrong(*args, **kw):
        img = real(*args, **kw).clone()
        img[..., 0] += 0.1
        return img

    monkeypatch.setattr(render_lanes, "render_mxu_balanced", wrong)
    with pytest.raises(SystemExit) as exit_:
        bench_torch.main(ARGV)
    assert exit_.value.code == 1
    captured = capsys.readouterr()
    (line,) = captured.out.strip().splitlines()
    assert json.loads(line)["verify"] == "fail"
    assert "cuda disagrees with torch" in captured.err
    assert "grad bench" not in captured.err


def test_gate_holds_the_headline_session(tiny, monkeypatch, capsys):
    """The session the headline times, off by 0.1 in one channel while the
    render functions stay right: the gate fails on it alone."""
    from bevy_raytrace_tpu_torch.kernels import record

    real = record.render_pallas

    def wrong(*args, **kw):
        img = real(*args, **kw).clone()
        img[..., 0] += 0.1
        return img

    # `Renderer("pallas")` renders through kernels.record; the gate's
    # `pallas` function is bound from the kernels package.
    monkeypatch.setattr(record, "render_pallas", wrong)
    with pytest.raises(SystemExit) as exit_:
        bench_torch.main(ARGV)
    assert exit_.value.code == 1
    err = capsys.readouterr().err
    assert "verify: pallas vs torch" in err and "-> ok" in err
    assert "session disagrees with torch" in err


def test_no_card_and_no_cpu_asked_for_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "found none" in out.stderr
    assert '"value"' not in out.stdout


@pytest.mark.parametrize("argv", [
    ["--backend", "torch", "--no-verify", "--no-grad"],
    ["--backend", "pallas", "--cluster-size", "0", "--no-grad"],
], ids=["torch_backend", "pallas_brute_force"])
def test_bench_backends(tiny, capsys, argv):
    """The other backends head the same line; without the gate `verify` is
    "skipped", without the gradient legs no `grad_*` key is printed."""
    assert bench_torch.main(ARGV + argv) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["verify"] == ("skipped" if "--no-verify" in argv else "pass")
    assert set(line) == {k for k in bench_torch.KEYS
                         if not k.startswith("grad_")}
    assert "backend=" + argv[1] in line["metric"]


def test_bench_cuda_backend_needs_the_card(capsys):
    with pytest.raises(SystemExit) as exit_:
        bench_torch.main(["--device", "cpu"])
    assert exit_.value.code == 2
    assert "runs on the card" in capsys.readouterr().err
