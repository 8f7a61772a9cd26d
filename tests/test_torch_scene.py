"""Scene builders, registry, camera and interop of the port against the JAX
package.  Scene tables come from the same numpy draws, so they must be
bit-equal; cameras go through tan/sqrt in float32, held at 1e-6."""

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.camera import Camera as JCamera
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch.core.camera import Camera as TCamera
from bevy_raytrace_tpu_torch.interop import (
    camera_from_arrays,
    camera_from_reference,
    scene_from_arrays,
    scene_from_reference,
    scene_to_arrays,
)
from bevy_raytrace_tpu_torch.scenes.registry import MaterialRegistry

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

BUILDERS = {
    "config1": lambda m: m.baseline_config1_scene(),
    "config2": lambda m: m.baseline_config2_scene(),
    "rtiow_final": lambda m: m.rtiow_final_scene(seed=0),
    "reference": lambda m: m.reference_scene(0),
}


def _ref_arrays(scene):
    m = scene.materials
    return [np.asarray(a) for a in (scene.centers, scene.radii,
                                    scene.material_id, m.albedo, m.kind,
                                    m.fuzz, m.ior)]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_arrays_equal_reference(name):
    (jscene, jreg), (tscene, treg) = (BUILDERS[name](jsc),
                                      BUILDERS[name](tsc))
    assert treg.names() == jreg.names()
    assert tscene.count == jscene.count
    for want, got in zip(_ref_arrays(jscene), scene_to_arrays(tscene)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,aspect", [
    ("baseline_config1_camera", 2.0),
    ("baseline_config2_camera", 1.5),
    ("rtiow_final_camera", 16 / 9),
])
def test_camera_pack_matches_reference(name, aspect):
    want = np.asarray(getattr(jsc, name)(aspect).pack())
    got = getattr(tsc, name)(aspect).pack()
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_from_transform_matches_reference():
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (1.0, 2.0, 3.0)
    kw = dict(fov=1.2, aspect=1.5, image_plane_distance=8.0,
              lens_focal_length=0.2, fstop=0.5)
    for lens in (True, False):
        want = np.asarray(JCamera.from_transform(m, enable_lens=lens,
                                                 **kw).pack())
        got = TCamera.from_transform(m, enable_lens=lens, **kw).pack()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_interop_round_trip_is_exact():
    jscene, _ = jsc.rtiow_final_scene(seed=3, grid=2)
    arrays = _ref_arrays(jscene)
    for tscene in (scene_from_arrays(*arrays), scene_from_reference(jscene)):
        for want, got in zip(arrays, scene_to_arrays(tscene)):
            np.testing.assert_array_equal(got, want)
    jcam = jsc.rtiow_final_camera(1.5)
    packed = np.asarray(jcam.pack())
    np.testing.assert_array_equal(camera_from_reference(jcam).pack().numpy(),
                                  packed)
    leaves = [np.asarray(getattr(jcam, f)) for f in (
        "origin", "u", "v", "w", "half_width", "half_height", "lens_radius",
        "focus_dist")]
    np.testing.assert_array_equal(camera_from_arrays(*leaves).pack().numpy(),
                                  packed)
    cam = TCamera.from_packed(packed)
    back = cam.unpack_cotangent(cam.pack())
    np.testing.assert_array_equal(back.pack().numpy(), packed)


def test_registry_order_and_errors():
    reg = MaterialRegistry()
    assert reg.lambertian("a", (0.1, 0.2, 0.3)) == 0
    assert reg.metallic("b", (0.5, 0.5, 0.5), fuzz=0.2) == 1
    assert reg.dielectric("c", ior=1.3) == 2
    assert reg.lambertian("a", (0.9, 0.9, 0.9)) == 0  # overwrite keeps slot
    m = reg.to_materials()
    assert m.kind.tolist() == [0, 1, 2] and m.count == 3
    np.testing.assert_array_equal(m.albedo[0].numpy(),
                                  np.float32([0.9, 0.9, 0.9]))
    assert "b" in reg and len(reg) == 3
    with pytest.raises(ValueError, match="empty"):
        MaterialRegistry().to_materials()
    with pytest.raises(ValueError, match="unknown material kind"):
        reg.insert("d", type(reg._materials["a"])("plastic"))
