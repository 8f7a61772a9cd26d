"""The host-built camera (`core/camera.py`): `Camera.look_at` of host values
computes the 16 packed floats on the host, rounded as the tensor path's
torch ops round them, and its fields are views of one [16] tensor; a tensor
argument takes the tensor path.  Poses: the real-time cell's fly path
(`benchmark/brtbench/traffic.py`) and the scene builders' three cameras.
The JAX parity of the camera stays in `test_torch_geometry.py`."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch import Camera, set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.utils import spans

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SEEDS = (7, 2**31 + 11, 3_000_000_019)
# (focus_dist, aperture): the real-time cell's pinhole, and a thin lens.
LENSES = [(None, 0.0), (None, 0.25), (6.5, 0.0), (6.5, 0.25)]


def _fly_path(seed, frames):
    """(kwargs of look_at but the pose, lookfrom [n, 3], lookat [n, 3]) of
    the real-time cell's fly path."""
    if str(_BENCH) not in sys.path:
        sys.path.insert(0, str(_BENCH))
    from brtbench.traffic import CameraPath

    cfg = json.loads((_BENCH / "configs/bevy_reference.json").read_text())
    mix = json.loads((_BENCH / "traffic/realtime.json").read_text())
    cam = cfg["camera"]
    kw = dict(vup=tuple(cam["vup"]), vfov_deg=float(cam["vfov_deg"]),
              aspect=cfg["width"] / cfg["height"])
    f, a = CameraPath(mix, cfg, seed).poses(np.arange(frames))
    return kw, f, a


def _ulps(x, y):
    """Per element, how many float32 steps lie between x and y."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(x) - ordered(y)).abs()


def _tensor_path(lookfrom, lookat, **kw):
    """The same camera through the tensor path: every argument a tensor."""
    kw = {k: v if v is None else torch.tensor(v) for k, v in kw.items()}
    return Camera.look_at(torch.tensor(lookfrom), torch.tensor(lookat), **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("focus_dist,aperture", LENSES)
def test_fly_path_packs_within_one_ulp_of_the_tensor_path(seed, focus_dist,
                                                          aperture):
    kw, f, a = _fly_path(seed, 256)
    kw.update(focus_dist=focus_dist, aperture=aperture)
    host = torch.stack([Camera.look_at(f[k].tolist(), a[k].tolist(),
                                       **kw).pack() for k in range(len(f))])
    dev = torch.stack([_tensor_path(f[k], a[k], **kw).pack()
                       for k in range(len(f))])
    d = _ulps(host, dev)
    print(f"{int((d == 0).sum())} of {d.numel()} bit-equal, "
          f"largest {int(d.max())} ulp")
    assert int(d.max()) <= 1


@pytest.mark.parametrize("build", [tsc.baseline_config1_camera,
                                   tsc.baseline_config2_camera,
                                   tsc.rtiow_final_camera])
def test_builder_cameras_pack_within_one_ulp_of_the_tensor_path(build):
    """Each builder's camera (focus given or not, aperture 0 or 0.1) and the
    same camera with every argument a tensor."""
    spans.reset_counters("camera.")
    cam = build(1.5)
    assert spans.counters("camera.") == {"camera.look_at_host": 1}
    # Rebuild it through the tensor path from the builder's own arguments.
    args = {tsc.baseline_config1_camera: ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                          dict(vfov_deg=90.0, focus_dist=1.0)),
            tsc.baseline_config2_camera: ((-2.0, 2.0, 1.0), (0.0, 0.0, -1.0),
                                          dict(vfov_deg=20.0)),
            tsc.rtiow_final_camera: ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                     dict(vfov_deg=20.0, aperture=0.1,
                                          focus_dist=10.0))}[build]
    f, a, kw = args
    kw = {"vup": (0.0, 1.0, 0.0), "aspect": 1.5, "aperture": 0.0,
          "focus_dist": None, **kw}
    dev = _tensor_path(f, a, **kw)
    assert spans.counter("camera.look_at_device") == 1
    assert int(_ulps(cam.pack(), dev.pack()).max()) <= 1


def test_random_poses_and_up_vectors_within_one_ulp():
    """Poses far from the fly path: any up vector, field of view and
    aspect, so that the cross products cancel."""
    rng = np.random.default_rng(5)
    worst = 0
    for _ in range(300):
        f, a, up = (rng.standard_normal(3) * s for s in (10.0, 1.0, 1.0))
        kw = dict(vup=up, vfov_deg=rng.uniform(1.0, 170.0),
                  aspect=rng.uniform(0.5, 3.0), aperture=rng.uniform(0, 1),
                  focus_dist=None)
        host = Camera.look_at(f, a, **kw).pack()
        worst = max(worst, int(_ulps(host, _tensor_path(f, a, **kw)
                                     .pack()).max()))
    assert worst <= 1


# --- which path a call takes ------------------------------------------------

HOST_INPUTS = {
    "tuples": ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0),
    "lists_of_ints": ([13, 2, 3], [0, 0, 0], [0, 1, 0], 20),
    "numpy_float64": (np.array([13.0, 2.0, 3.0]), np.zeros(3),
                      np.array([0.0, 1.0, 0.0]), np.float64(20.0)),
    "numpy_float32": (np.array([13, 2, 3], np.float32),
                      np.zeros(3, np.float32),
                      np.array([0, 1, 0], np.float32), np.array(20.0)),
    "numpy_scalars": ((np.float64(13.0), np.float32(2.0), np.int64(3)),
                      (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), np.float32(20.0)),
}


@pytest.mark.parametrize("kind", sorted(HOST_INPUTS))
def test_host_values_take_the_host_path(kind):
    f, a, up, vfov = HOST_INPUTS[kind]
    spans.reset_counters("camera.")
    cam = Camera.look_at(f, a, up, vfov, aspect=1.5, aperture=0.1,
                         focus_dist=np.float32(10.0))
    assert spans.counters("camera.") == {"camera.look_at_host": 1}
    want = tsc.rtiow_final_camera(1.5)
    assert torch.equal(cam.pack(), want.pack())


ARGS = ("lookfrom", "lookat", "vup", "vfov_deg", "aspect", "aperture",
        "focus_dist")


@pytest.mark.parametrize("tensor_arg", ARGS)
def test_any_tensor_takes_the_tensor_path(tensor_arg):
    kw = dict(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
              vup=(0.0, 1.0, 0.0), vfov_deg=20.0, aspect=1.5, aperture=0.1,
              focus_dist=10.0)
    kw[tensor_arg] = torch.tensor(kw[tensor_arg])
    spans.reset_counters("camera.")
    cam = Camera.look_at(**kw)
    assert spans.counters("camera.") == {"camera.look_at_device": 1}
    host = tsc.rtiow_final_camera(1.5)
    assert int(_ulps(cam.pack(), host.pack()).max()) <= 1


@pytest.mark.parametrize("batched", [np.array, list])
def test_batched_vectors_take_the_tensor_path(batched):
    """Only vectors of the camera's shape [3] are built on the host; a
    [1, 3] pose goes where it went before."""
    spans.reset_counters("camera.")
    cam = Camera.look_at(batched([[13.0, 2.0, 3.0]]), batched([[0.0] * 3]),
                         batched([[0.0, 1.0, 0.0]]), aspect=1.5)
    assert spans.counters("camera.") == {"camera.look_at_device": 1}
    assert cam.u.shape == (1, 3)


def test_a_sequence_holding_a_tensor_takes_the_tensor_path():
    spans.reset_counters("camera.")
    cam = Camera.look_at([13.0, 2.0, torch.tensor(3.0)], (0.0, 0.0, 0.0),
                         aspect=1.5)
    assert spans.counters("camera.") == {"camera.look_at_device": 1}
    assert torch.equal(cam.origin, torch.tensor([13.0, 2.0, 3.0]))


def test_a_pose_with_a_gradient_still_gets_one_through_pack():
    lookfrom = torch.tensor([13.0, 2.0, 3.0], requires_grad=True)
    spans.reset_counters("camera.")
    cam = Camera.look_at(lookfrom, (0.0, 0.0, 0.0), aspect=1.5)
    assert spans.counters("camera.") == {"camera.look_at_device": 1}
    (cam.pack() * torch.arange(16.0)).sum().backward()
    assert lookfrom.grad is not None
    assert bool(torch.isfinite(lookfrom.grad).all())
    assert float(lookfrom.grad.abs().sum()) > 0


def test_fields_are_views_of_one_packed_tensor():
    cam = tsc.rtiow_final_camera(1.5)
    base = cam.origin._base
    assert base is not None and base.shape == (16,) and base.is_contiguous()
    offsets = []
    for name in ("origin", "u", "v", "w", "half_width", "half_height",
                 "lens_radius", "focus_dist"):
        t = getattr(cam, name)
        assert t._base is base
        offsets.append(t.storage_offset())
    assert offsets == [0, 3, 6, 9, 12, 13, 14, 15]
    assert cam.half_width.shape == () and cam.u.shape == (3,)
    assert torch.equal(cam.pack(), base)
    assert torch.equal(Camera.from_packed(base).pack(), cam.pack())


@pytest.mark.parametrize("lookfrom,lookat", [
    ((1.0, 2.0, 3.0), (1.0, 2.0, 3.0)),
    ((1e39, 2.0, 3.0), (0.0, 0.0, 0.0)),
    ((1.0, 2.0, 3.0), (0.0, float("nan"), 0.0))])
def test_degenerate_poses_match_the_tensor_path(lookfrom, lookat):
    """lookfrom == lookat (the 1e-12 clamp: a zero basis, a zero focus
    distance), a coordinate past float32's range, a NaN: the same floats,
    and NaN in the same places, on both paths."""
    kw = dict(vfov_deg=40.0, aspect=2.0, aperture=0.0, focus_dist=None,
              vup=(0.0, 1.0, 0.0))
    host = Camera.look_at(lookfrom, lookat, **kw).pack()
    dev = _tensor_path(lookfrom, lookat, **kw).pack()
    assert torch.equal(host.isnan(), dev.isnan())
    assert torch.equal(host.nan_to_num(0.0, 1.0, -1.0),
                       dev.nan_to_num(0.0, 1.0, -1.0))
    if lookfrom == lookat:
        assert float(host[3:12].abs().sum()) == 0.0 and float(host[15]) == 0
