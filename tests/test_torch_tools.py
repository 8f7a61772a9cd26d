"""The port's tool entry points on the CPU: `tools.proto_probes`,
`tools.fp32_probe`, `tools.grad_bench`, `tools.scaling`'s record,
`tools.ref_probe`, `tools.livechunks` and `graft_entry`.

On the CPU every probe runs its plain PyTorch version (the wrappers take it
because the tensors lie on the CPU); the rates of the card are measured on
the card only, so here the tools are held to running, to what they print and
to their exit codes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch import graft_entry, set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.tools import (
    fp32_probe,
    grad_bench,
    livechunks,
    proto_probes,
    ref_probe,
    scaling,
)

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_proto_probes_prints_one_line_a_probe(capsys):
    assert proto_probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "p1_while", "p2_dot", "p3_reshape", "p4_minpack", "p5_onehot"]
    assert all(ln.split()[1] == "OK" and "ms on cpu" in ln for ln in lines)
    figures = {ln.split()[0]: float(ln.split("result=")[1].split()[0])
               for ln in lines}
    np.testing.assert_allclose(figures["p1_while"], 51.5108, rtol=1e-5)
    assert figures["p2_dot"] <= 1e-5
    assert figures["p3_reshape"] == figures["p5_onehot"] == 0.0
    assert figures["p4_minpack"] == 0  # the reference reports 8 here


def test_proto_probes_reports_a_result_that_is_off(monkeypatch, capsys):
    """A wrong result is no exception: the line says OFF and the exit code
    is 1."""
    from bevy_raytrace_tpu_torch.kernels import probes

    monkeypatch.setattr(probes, "p3_reshape_plain", lambda x: x * 3.0)
    assert proto_probes.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "p3_reshape   OFF" in out and "p2_dot       OK" in out


def test_tools_need_a_card_unless_asked_for_the_cpu():
    """No `--device`: the tool runs on the card and raises where there is
    none (this machine); nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    code = ("from bevy_raytrace_tpu_torch.tools import proto_probes as t\n"
            "t.main([])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "found none" in out.stderr


def test_fp32_probe_at_a_tiny_shape(capsys):
    assert fp32_probe.main(["--device", "cpu", "--spheres", "12", "--rays",
                            "64", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("probe: (S,R)=(12,64) x 2 rounds on cpu")
    names = [" ".join(ln.split()[:ln.split().index("S=12")])
             for ln in lines[1:]]
    assert names == ["v1 sweep", "v2 fma f32", "v2 fma bf16", "v3 prod",
                     "v3 nosqrt", "v3 nobranch", "v3 smem", "v3 k1"]
    # A CPU run states no rate of the card.
    assert not any("TFLOP/s" in ln for ln in lines)
    assert [r["name"] for r in fp32_probe.ROWS] == names
    assert all(r["device"] == "cpu" and r["ms"] > 0 and "tflops" not in r
               for r in fp32_probe.ROWS)
    # "prod", "smem" and "k1" share one plain version: one digest.
    sha = {r["name"]: r["sha256"] for r in fp32_probe.ROWS}
    assert sha["v3 prod"] == sha["v3 smem"] == sha["v3 k1"] != sha["v3 nosqrt"]
    with pytest.raises(SystemExit):
        fp32_probe.main(["--device", "cpu", "--spheres", "12"])


def test_fp32_probe_inputs():
    """The card-filling shape's operands: a scene's own table and camera
    rays, uniform within a warp, and shuffled."""
    g, r = fp32_probe.scene_inputs("reference_scene", 256, "cpu")
    scene = tsc.reference_scene(0)[0]
    assert g.shape == (197, 8) and r.shape == (8, 256)
    torch.testing.assert_close(g[:, :3], scene.centers)
    torch.testing.assert_close(g[:, 3], scene.radii ** 2)
    torch.testing.assert_close((r[3:6] ** 2).sum(0), torch.ones(256))
    u = fp32_probe.warp_uniform(r)
    assert torch.equal(u[:, 32:64], r[:, 32:33].expand(8, 32))
    s = fp32_probe.shuffled(r, 0)
    assert not torch.equal(s, r)
    assert torch.equal(s.sort(dim=1).values, r.sort(dim=1).values)
    assert fp32_probe.CARD_RAYS == 132 * 2048


def test_grad_bench_on_the_cpu(capsys):
    assert grad_bench.main(["32", "24", "2", "3", "torch,wavefront",
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["torch/pallas", "wavefront"]
    assert all("step=" in ln and "paths/s=" in ln for ln in lines)
    assert [s["path"] for s in grad_bench.STEPS] == ["torch", "wavefront"]
    assert grad_bench.main(["32", "24", "2", "3", "kernel", "--forward",
                            "sweep", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split()[0] == "kernel/sweep"
    with pytest.raises(SystemExit):
        grad_bench.main(["32", "24", "2", "3", "xla", "--device", "cpu"])


def test_grad_bench_reports_non_finite_gradients(monkeypatch, capsys):
    """A NaN albedo reaches the gradient: reported, exit code 1."""
    import dataclasses

    real = tsc.rtiow_final_scene

    def poisoned(seed=0, grid=11, device=None):
        scene, reg = real(seed, 1, device)
        albedo = scene.materials.albedo.clone()
        albedo[0] = float("nan")  # the ground's
        return dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=albedo)), reg

    monkeypatch.setattr(tsc, "rtiow_final_scene", poisoned)
    assert grad_bench.main(["16", "8", "1", "2", "wavefront", "--device",
                            "cpu"]) == 1
    assert "NON-FINITE GRADS" in capsys.readouterr().out


def test_graft_entry_renders():
    """entry() is the 400x224 x 4 spp wavefront step on the 486-sphere
    scene; its fn is run here on a 4-sphere scene of the same function."""
    fn, (scene, camera) = graft_entry.entry()
    assert scene.count == 486 and scene.device.type == "cpu"
    small = tsc.rtiow_final_scene(seed=0, grid=0)[0]
    img = fn(small, camera)
    assert img.shape == (224, 400, 3) and not img.requires_grad
    assert bool(torch.isfinite(img).all()) and float(img.max()) <= 1.0 + 1e-5
    assert float(img.std()) > 0.05


def test_dryrun_multichip_on_gloo():
    """Two ranks on the CPU over gloo as a 2x1 mesh: a finite training step
    that moved the parameters and a finite fast gradient, equal on both
    ranks (the gradients are summed by the backward's all-reduce)."""
    reports = graft_entry.dryrun_multichip(2)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["ok"] and r["backend"] == "gloo" and r["device"] == "cpu"
        assert (r["hosts"], r["chips"], r["width"], r["height"]) == (2, 1, 16,
                                                                     8)
        assert np.isfinite(r["loss"]) and r["moved"] > 0.0
        assert r["fast_all_reduces"] == 1
        assert all(v > 0.0 for v in r["train_grad_max"].values())
        assert all(v > 0.0 for v in r["fast_grad_max"].values())
    assert json.dumps(reports[0]["train_grad_max"]) == json.dumps(
        reports[1]["train_grad_max"])
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(0)



def _rank_line(rank, timed=None, **kw):
    """One `shard.worker` JSON line, as a rank of a 2-rank world prints it
    on rtiow's 486 spheres, with its timed runs (`timed`: changes to them)."""
    return {"ok": True, "rank": rank, "device": "cpu", "backend": "gloo",
            "spheres": 486, "forward_collectives": 0,
            "wavefront_backward_all_reduces": 1,
            "fast_backward_all_reduces": [1] * 8,
            "all_reduce_bytes": [21448],
            "timed": {"shape": [64, 32, 2, 3], "paths": 4096, "spheres": 486,
                      "all_reduce_bytes": 21448,
                      "frame_s": [[0.5, 0.7], [0.7, 0.5]][rank],
                      "step_s": [2.0 + rank, 1.0 + rank], **(timed or {})},
            **kw}


def test_scaling_summary_counts_and_sizes_collectives():
    """The counterpart of tests/test_scaling_tool.py's audit case: the ranks'
    counts folded into the world's record, the fast backward's one
    all-reduce of (11 S + 16) x 4 bytes; a timed run ends with its slowest
    rank, and the best run counts."""
    record = scaling.summarize([_rank_line(0), _rank_line(1)])
    assert record["world"] == 2 and record["spheres"] == 486
    assert record["forward_collectives"] == {"count": 0, "bytes": 0}
    assert record["backward_collectives"] == {
        "wavefront_all_reduces": 1, "fast_all_reduces": 1,
        "fast_bytes": (11 * 486 + 16) * 4, "fast_backwards_counted": 8}
    assert record["backward_collectives"]["fast_bytes"] == 21448
    assert record["matches_single_process"]
    timed = record["timed"]
    # frame runs: rank 0 [0.5, 0.7], rank 1 [0.7, 0.5] -> ends [0.7, 0.7];
    # step runs: [2.0, 1.0] and [3.0, 2.0] -> ends [3.0, 2.0].
    assert (timed["frame_s"], timed["step_s"]) == (0.7, 2.0)
    assert timed["rays_per_s"] == 4096 / 0.7
    assert timed["paths_per_s"] == 2048.0
    assert timed["step_s_by_rank"] == [[2.0, 1.0], [3.0, 2.0]]
    assert (timed["spheres"], timed["fast_bytes"]) == (486, 21448)
    untimed = [_rank_line(r) for r in (0, 1)]
    for line in untimed:
        del line["timed"]
    assert "timed" not in scaling.summarize(untimed)


@pytest.mark.parametrize("lines", [
    [_rank_line(0, forward_collectives=1),
     _rank_line(1, forward_collectives=1)],
    [_rank_line(0), _rank_line(1, all_reduce_bytes=[21452])],
    [_rank_line(0), _rank_line(1, fast_backward_all_reduces=[1] * 7 + [2])],
    [_rank_line(0, all_reduce_bytes=[21448, 284])],
    [_rank_line(0), _rank_line(1, timed={"shape": [32, 32, 2, 3]})],
    [],
], ids=["forward_collective", "ranks_disagree_on_bytes",
        "ranks_disagree_on_counts", "two_payloads",
        "ranks_disagree_on_the_timed_shape", "no_rank"])
def test_scaling_summary_refuses_a_bad_record(lines):
    """The counterpart of the clean-module case: a forward that counted a
    collective, two ranks that disagree, a backward of two payloads or no
    rank at all raise."""
    with pytest.raises(ValueError):
        scaling.summarize(lines)


def test_ref_probe_on_the_cpu(monkeypatch, capsys):
    """Both frame loops at a few pixels through Renderer("torch"): one JSON
    line of the four rates, labelled with the CPU."""
    monkeypatch.setattr(ref_probe, "FRAME", (16, 8, 3))
    monkeypatch.setattr(ref_probe, "SPPS", (1, 2))
    assert ref_probe.main(["--frames", "2", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert (out.pop("device"), out.pop("backend")) == ("cpu", "torch")
    assert sorted(out) == sorted(f"spp{s}_{m}_rays_per_s" for s in (1, 2)
                                 for m in ("sync", "pipelined"))
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert ref_probe.main(["--frames", "1", "--device", "cpu",
                           "--skip-spp64"]) == 0
    assert sorted(json.loads(capsys.readouterr().out)) == [
        "backend", "device", "spp1_pipelined_rays_per_s",
        "spp1_sync_rays_per_s"]


def test_livechunks_on_the_cpu(capsys):
    """The culled twin's live count on rtiow (486 spheres) at 32x24x2: the
    mean within (0, C), its p90, one timed line per layout, and the record
    in RESULTS; max_rounds caps every lane's rounds."""
    assert livechunks.main(["12", "2", "5", "--width", "32", "--height",
                            "24", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "plan: 41 chunks x 12"
    assert lines[1].startswith("live chunks/round: mean ")
    assert "/ 41" in lines[1] and lines[1].endswith("on cpu")
    assert lines[2] == "dense launch: not timed with max_rounds"
    assert [ln.split()[0] for ln in lines[3:]] == ["coherent", "identity"]
    (row,) = livechunks.RESULTS
    assert 0.0 < row["mean_live_chunks"] < 41 and row["n_clusters"] == 41
    assert row["mean_live_chunks"] <= row["p90_live_chunks"] + 41
    assert 0 < row["rounds"] <= 32 * 24 * 5
    assert sorted(row["ms"]) == ["coherent", "identity"]
    assert row["dense_ms"] == {}
    # A lane stops at max_rounds: one round each at 1.  Without a cap the
    # dense launch of the same lanes is timed beside the culled one.
    assert livechunks.main(["12", "2", "1", "--width", "32", "--height",
                            "24", "--device", "cpu"]) == 0
    assert livechunks.RESULTS[0]["rounds"] == 32 * 24
    capsys.readouterr()
    assert livechunks.main(["64", "1", "0", "--width", "16", "--height",
                            "16", "--depth", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "plan: 8 chunks x 64" and "dense" in lines[2]
    assert sorted(livechunks.RESULTS[0]["dense_ms"]) == ["coherent",
                                                        "identity"]
