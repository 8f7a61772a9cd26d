"""The port's CLI: the cases of tests/test_cli.py, driven in-process with
`--device cpu` at their tiny sizes, and the same arguments through both
CLIs.

On the CPU `--backend torch` runs the wavefront and `--backend pallas` K2's
plain twin; `--backend cuda` needs the card and is refused (its session
cases are in test_torch_cuda.py).  Both CLIs on the same arguments: the
decoded PNGs agree to <= 1 of 255 on >= 98% of pixels (two float32
renderers of the same paths, quantized to 8 bits).
"""

import os

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import cli as jcli
from bevy_raytrace_tpu_torch import cli

torch.set_num_threads(2)

CPU = ["--device", "cpu"]
TINY = ["--scene", "config1", "--width", "48", "--height", "24", "--spp", "1",
        "--depth", "2"]


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


def test_render_writes_png_and_metrics(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    cli.main([
        "render", "--scene", "config1", "--width", "64", "--height", "32",
        "--spp", "2", "--depth", "3", "--backend", "torch", "-o", out, *CPU,
    ])
    cap = capsys.readouterr()
    assert cap.out.strip() == out
    assert "rays/s" in cap.err
    assert os.path.exists(out) and os.path.getsize(out) > 100
    assert _png(out).shape == (32, 64, 3)


def test_render_is_the_api_image(tmp_path):
    """The file holds what the Python API renders for the same arguments,
    tone-mapped; .ppm and .exr go through the same step."""
    from bevy_raytrace_tpu_torch import RenderConfig, render, scenes
    from bevy_raytrace_tpu_torch.io import tonemap

    cfg = RenderConfig(width=48, height=24, samples_per_pixel=1, max_depth=2,
                       spp_chunk=1)
    scene, _ = scenes.baseline_config1_scene(device="cpu")
    cam = scenes.baseline_config1_camera(cfg.aspect, device="cpu")
    with torch.no_grad():
        want = render(scene, cam, cfg, 3)
    for ext in ("png", "ppm", "exr"):
        cli.main(["render", *TINY, "--backend", "torch", "--frame", "3",
                  "-o", str(tmp_path / f"x.{ext}"), *CPU])
    np.testing.assert_array_equal(_png(tmp_path / "x.png"),
                                  tonemap(want).astype(np.int32))
    with open(tmp_path / "x.ppm", "rb") as f:
        assert f.readline() == b"P6\n"
    assert os.path.getsize(tmp_path / "x.exr") > 48 * 24 * 12


def test_render_camera_override_changes_image(tmp_path):
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    base = ["render", *TINY, "--backend", "torch", *CPU]
    cli.main(base + ["-o", a])
    cli.main(base + ["--lookfrom", "0", "4", "8", "-o", b])
    ia = np.fromfile(a, np.uint8)
    ib = np.fromfile(b, np.uint8)
    assert ia.shape != ib.shape or not np.array_equal(ia, ib)


def test_render_sharded_flag(tmp_path, capsys):
    """--sharded in a lone process: a gloo group of world size 1, opened
    and closed by the command; the image is the unsharded one."""
    import torch.distributed as dist

    out, plain = str(tmp_path / "s.png"), str(tmp_path / "p.png")
    base = ["render", "--scene", "config1", "--width", "64", "--height", "32",
            "--spp", "1", "--depth", "2", "--backend", "torch", *CPU]
    cli.main(base + ["--sharded", "-o", out])
    cap = capsys.readouterr()
    assert "mesh: 1x1" in cap.err
    assert not dist.is_initialized()
    cli.main(base + ["-o", plain])
    np.testing.assert_array_equal(_png(out), _png(plain))


def test_animate_writes_frames(tmp_path, capsys):
    outdir = str(tmp_path / "seq")
    cli.main(["animate", *TINY, "--frames", "3", "--backend", "torch", "-o",
              outdir, *CPU])
    cap = capsys.readouterr()
    assert cap.out.strip() == outdir
    frames = sorted(os.listdir(outdir))
    assert frames == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert "s/frame" in cap.err
    imgs = [_png(os.path.join(outdir, f)) for f in frames]
    assert all(i.shape == (24, 48, 3) for i in imgs)
    assert not np.array_equal(imgs[0], imgs[1])  # the camera orbits


def test_inverse_improves_and_checkpoints(tmp_path, capsys):
    out = str(tmp_path / "inv.png")
    ckpt = str(tmp_path / "ck.npz")
    argv = ["inverse", "--width", "48", "--height", "27", "--spp", "2",
            "--depth", "3", "--checkpoint", ckpt, "--checkpoint-every", "3",
            "--backend", "torch", "-o", out, *CPU]
    cli.main(argv + ["--steps", "3"])
    cap = capsys.readouterr()
    assert os.path.exists(out)
    assert os.path.exists(ckpt)
    assert "recovered center" in cap.err
    losses = [float(line.split("loss")[1])
              for line in cap.err.splitlines() if line.startswith("step ")]
    assert losses, "no loss lines logged"
    # The closing line: the last loss and the ball's errors, end and start.
    (final,) = [line for line in cap.err.splitlines()
                if line.startswith("final ")]
    got = {k: float(v) for k, v in (kv.split("=") for kv in final.split()[1:])}
    assert set(got) == {"loss", "center_error", "albedo_error",
                        "center_error_start", "albedo_error_start"}
    assert all(np.isfinite(v) for v in got.values()), got
    np.testing.assert_allclose(got["center_error_start"],
                               np.linalg.norm([0.25, -0.1, 0.1]), rtol=1e-5)
    # The checkpoint is what a second run resumes from: steps 3-5 only.
    with np.load(ckpt) as z:
        assert int(z["step"]) == 3
    cli.main(argv + ["--steps", "6"])
    with np.load(ckpt) as z:
        assert int(z["step"]) == 6
    assert "step 0:" not in capsys.readouterr().err


def test_bad_scene_flag_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--scene", "nope"])
    assert e.value.code != 0


def test_cluster_size_validated_at_flag_boundary(tmp_path):
    """A negative --cluster-size fails at argparse time.  Any integer >= 0
    is taken (the reference wants a multiple of its kernel's unroll, which
    the Hopper kernel does not have): 16 renders, and equals brute force."""
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--cluster-size", "-6"])
    assert e.value.code != 0
    with pytest.raises(SystemExit):
        cli.main(["render", "--interpret"])  # the flag does not exist here
    base = ["render", "--scene", "rtiow", "--width", "48", "--height", "32",
            "--spp", "1", "--depth", "3", "--backend", "pallas", *CPU]
    paths = {}
    for size in (16, 12, 0):
        paths[size] = str(tmp_path / f"c{size}.png")
        cli.main(base + ["--cluster-size", str(size), "-o", paths[size]])
    brute = open(paths[0], "rb").read()
    assert open(paths[16], "rb").read() == brute
    assert open(paths[12], "rb").read() == brute


def test_cuda_backend_needs_the_card(tmp_path):
    """--backend cuda (the default) on --device cpu exits with that error,
    sharded or not, for every command; nothing falls back to another
    path."""
    out = str(tmp_path / "never.png")
    for argv in (["render", *TINY, "-o", out, *CPU],
                 ["render", *TINY, "--sharded", "-o", out, *CPU],
                 ["animate", *TINY, "--frames", "2", "--backend", "cuda",
                  "-o", str(tmp_path / "seq"), *CPU],
                 ["serve", *TINY, *CPU]):
        with pytest.raises(SystemExit, match="CUDA device"):
            cli.main(argv)
    assert not os.path.exists(out)
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_no_device_flag_means_the_card(tmp_path, monkeypatch):
    """Without --device every command runs on the CUDA device; where there
    is none it raises instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # Another test module of this process may have asked for the CPU.
    monkeypatch.setattr("bevy_raytrace_tpu_torch.device._OVERRIDE", None)
    for backend in ("torch", "pallas", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            cli.main(["render", *TINY, "--backend", backend, "-o",
                      str(tmp_path / "never.png")])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["inverse", "--steps", "1", "-o",
                  str(tmp_path / "never.png")])
    assert not os.path.exists(tmp_path / "never.png")


def test_pallas_backend_plans_once_per_sequence(tmp_path, monkeypatch):
    """cli animate --backend pallas builds ONE cluster plan for the
    sequence (its `Renderer` session's) and passes it to every frame's
    render."""
    from bevy_raytrace_tpu_torch.kernels import clusters as clusters_mod
    from bevy_raytrace_tpu_torch.kernels import record as record_mod

    plans, seen = [], []
    real_plan, real_render = clusters_mod.cluster_scene, record_mod.render_pallas

    def spy_plan(scene, cluster_size=12, **kw):
        plans.append(real_plan(scene, cluster_size=cluster_size, **kw))
        return plans[-1]

    def spy_render(*a, clusters=None, **kw):
        seen.append(clusters)
        return real_render(*a, clusters=clusters, **kw)

    monkeypatch.setattr(clusters_mod, "cluster_scene", spy_plan)
    monkeypatch.setattr(record_mod, "render_pallas", spy_render)
    outdir = str(tmp_path / "seq")
    cli.main(["animate", "--scene", "rtiow", "--width", "48", "--height",
              "24", "--spp", "2", "--depth", "2", "--frames", "3",
              "--backend", "pallas", "--cluster-size", "10", "-o", outdir,
              *CPU])
    assert len(plans) == 1 and plans[0].cluster_size == 10
    assert len(seen) == 3 and all(p is plans[0] for p in seen)
    assert sorted(os.listdir(outdir)) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    # The session's rule holds for the CLI too: a scene under 32 spheres
    # (config2 has 5) is not clustered and runs the brute-force loop.
    del plans[:], seen[:]
    cli.main(["render", "--scene", "config2", "--width", "48", "--height",
              "24", "--spp", "2", "--depth", "2", "--backend", "pallas",
              "--cluster-size", "2", "-o", str(tmp_path / "small.png"), *CPU])
    assert plans == [] and seen == [None]


def test_inverse_problem_comes_from_recovery(tmp_path, capsys, monkeypatch):
    """`cli inverse` makes its problem with inverse/recovery.py's
    perturbed_problem, the function the card's recovery checks use: the
    closing line's start errors are ball_errors of that function's
    perturbed scene, and its loss is the first loss of that problem."""
    from bevy_raytrace_tpu_torch.inverse import optimize, recovery

    built = []
    original = recovery.perturbed_problem

    def spy(config, *args, **kw):
        built.append(config)
        return original(config, *args, **kw)

    monkeypatch.setattr(recovery, "perturbed_problem", spy)
    cli.main(["inverse", "--width", "16", "--height", "8", "--spp", "1",
              "--depth", "2", "--steps", "1", "--backend", "torch", "-o",
              str(tmp_path / "inv.png"), *CPU])
    (final,) = [line for line in capsys.readouterr().err.splitlines()
                if line.startswith("final ")]
    got = {k: float(v) for k, v in (kv.split("=") for kv in final.split()[1:])}
    (config,) = built
    scene_bad, scene_true, problem = original(config, "cpu")
    np.testing.assert_allclose(
        [got["center_error_start"], got["albedo_error_start"]],
        recovery.ball_errors(scene_bad, scene_true), rtol=1e-5)
    first = optimize(scene_bad, problem, steps=1, learning_rate=1.5e-2)
    np.testing.assert_allclose(got["loss"], first.losses[0], rtol=1e-5)


def test_inverse_fast_backend(tmp_path, capsys):
    """cli inverse --backend pallas drives the residual-replay fast path
    (inverse/fast_grad.py; on the CPU K2's and K3's twins) end to end."""
    out = str(tmp_path / "rec.png")
    cli.main([
        "inverse", "--width", "48", "--height", "32", "--spp", "1",
        "--depth", "2", "--steps", "2", "--backend", "pallas", "-o", out,
        *CPU,
    ])
    cap = capsys.readouterr()
    assert "loss" in cap.err and os.path.exists(out)


def test_inverse_sharded_fast_backend(tmp_path, capsys):
    """cli inverse --sharded --backend pallas drives the SHARDED fast path
    (inverse/shard_grad.py) in a gloo group of world size 1."""
    out = str(tmp_path / "rec.png")
    cli.main([
        "inverse", "--width", "48", "--height", "32", "--spp", "1",
        "--depth", "2", "--steps", "2", "--sharded", "--backend", "pallas",
        "-o", out, *CPU,
    ])
    cap = capsys.readouterr()
    assert "mesh" in cap.err and "loss" in cap.err and os.path.exists(out)


def test_render_sharded_pallas_rejected(tmp_path):
    """--sharded --backend pallas has no implementation: reject loudly
    instead of silently rendering through another path."""
    with pytest.raises(SystemExit, match="sharded"):
        cli.main([
            "render", "--scene", "config1", "--width", "64", "--height",
            "32", "--spp", "1", "--depth", "2", "--sharded", "--backend",
            "pallas", "-o", str(tmp_path / "never.png"), *CPU,
        ])
    assert not os.path.exists(tmp_path / "never.png")


def test_serve_live_viewer():
    """cli serve: GET / is the page, GET /frame.png?yaw=... renders a frame
    through the session step (under its lock), POST /quit stops the server.
    Runs the real server in-process and drives it over HTTP."""
    import socket
    import threading
    import time
    import urllib.error
    import urllib.request

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    t = threading.Thread(target=cli.main, args=([
        "serve", "--scene", "config1", "--width", "64", "--height", "32",
        "--spp", "1", "--depth", "2", "--backend", "pallas", "--port",
        str(port), *CPU],), daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    page = None
    for _ in range(100):  # wait for the server to come up
        try:
            page = urllib.request.urlopen(f"{base}/", timeout=30).read()
            break
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    assert page is not None, "server never came up"
    assert b"<html" in page and b"frame.png" in page
    # Two different camera poses must both render valid PNGs.
    p1 = urllib.request.urlopen(
        f"{base}/frame.png?yaw=0.2&pitch=0.1&dist=13", timeout=600).read()
    p2 = urllib.request.urlopen(
        f"{base}/frame.png?yaw=1.2&pitch=0.1&dist=9", timeout=600).read()
    assert p1[:8] == b"\x89PNG\r\n\x1a\n" and p2[:8] == p1[:8]
    assert p1 != p2  # the camera really moved
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{base}/nope", timeout=60)
    r = urllib.request.urlopen(
        urllib.request.Request(f"{base}/quit", method="POST"), timeout=60)
    assert r.read() == b"bye"
    t.join(timeout=60)
    assert not t.is_alive(), "server did not shut down on /quit"


@pytest.mark.parametrize("backend,ref_flags", [
    ("torch", ["--backend", "xla"]),
    ("pallas", ["--backend", "pallas", "--interpret"]),
])
def test_both_clis_render_the_same_png(tmp_path, backend, ref_flags):
    """The same arguments through the JAX package's CLI and the port's:
    decoded PNGs within 1 of 255 on >= 98% of pixels."""
    args = ["render", "--scene", "config2", "--width", "64", "--height", "32",
            "--spp", "2", "--depth", "3", "--seed", "5", "--frame", "2",
            "--lookfrom", "3", "2", "4", "--aperture", "0.1"]
    a, b = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    jcli.main(args + ref_flags + ["-o", a])
    cli.main(args + ["--backend", backend, "-o", b, *CPU])
    ia, ib = _png(a), _png(b)
    assert ia.shape == ib.shape == (32, 64, 3)
    close = (np.abs(ia - ib).max(axis=-1) <= 1).mean()
    assert close >= 0.98, close
    assert ia.std() > 10  # a picture, not a constant
