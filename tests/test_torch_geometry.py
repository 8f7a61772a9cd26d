"""The port's intersection (`core/geometry.py`) and camera (`core/camera.py`)
on the reference's closed-form cases: `tests/test_geometry.py` (all but the
two tests of `gather_rows`, a TPU-only helper the port does not carry) and
`tests/test_camera.py`.  Each case asserts what the reference asserts, on
the port's output, and holds the port's output against the JAX package's
on the same numpy inputs: masks, faces and material indices exactly, floats
to 2e-6 absolute (values of O(1); the two packages round a few float32
operations differently, as test_torch_core.py's random rays show)."""

import jax.numpy as jnp
import numpy as np
import torch

from bevy_raytrace_tpu.core.camera import Camera as JCamera
from bevy_raytrace_tpu.core.geometry import intersect_scene as j_intersect
from bevy_raytrace_tpu.core.types import Ray as JRay
from bevy_raytrace_tpu.core.types import make_scene as j_make_scene
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.core.geometry import intersect_scene
from bevy_raytrace_tpu_torch.core.types import Ray, make_scene

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

T_MIN, T_MAX = 1e-3, 1e20
ATOL = 2e-6
_FIELDS = ("t", "point", "normal", "front_face", "material", "hit")


def _shoot(centers, radii, origins, dirs, mats=None):
    """The port's hits for rays (origins, dirs) against spheres (centers,
    radii) of materials `mats` (default 0), held against the reference's
    on the same inputs.  Returns the port's Hit as numpy arrays."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    n = len(radii)
    mats = np.zeros(n, np.int32) if mats is None else np.asarray(mats)
    m = max(int(mats.max()) + 1, 1)
    table = dict(albedo=np.ones((m, 3), np.float32),
                 kind=np.zeros(m, np.int32), fuzz=np.zeros(m, np.float32),
                 ior=np.ones(m, np.float32))
    o = np.asarray(origins, np.float32)
    d = np.asarray(dirs, np.float32)
    hit = intersect_scene(
        Ray(torch.from_numpy(o), torch.from_numpy(d)),
        make_scene(centers, radii, mats, **table), T_MIN, T_MAX)
    want = j_intersect(JRay(jnp.asarray(o), jnp.asarray(d)),
                       j_make_scene(centers, radii, mats, **table), T_MIN,
                       T_MAX)
    got = {f: getattr(hit, f).numpy() for f in _FIELDS}
    for f in _FIELDS:
        ref = np.asarray(getattr(want, f))
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got[f], ref, rtol=0, atol=ATOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], ref, err_msg=f)
    return got


def test_head_on_hit():
    h = _shoot([[0, 0, -2]], [0.5], [[0, 0, 0]], [[0, 0, -1]])
    assert h["hit"][0]
    np.testing.assert_allclose(h["t"][0], 1.5, rtol=1e-6)
    np.testing.assert_allclose(h["point"][0], [0, 0, -1.5], atol=1e-6)
    np.testing.assert_allclose(h["normal"][0], [0, 0, 1], atol=1e-6)
    assert h["front_face"][0]


def test_miss():
    h = _shoot([[0, 0, -2]], [0.5], [[0, 0, 0]], [[0, 1, 0]])
    assert not h["hit"][0]
    assert float(h["t"][0]) == float(np.float32(T_MAX))


def test_inside_sphere_back_face():
    """Origin inside the sphere: the near root is behind t_min, so the far
    root, front_face false, the normal flipped inward."""
    h = _shoot([[0, 0, 0]], [1.0], [[0, 0, 0]], [[0, 0, -1]])
    assert h["hit"][0]
    np.testing.assert_allclose(h["t"][0], 1.0, rtol=1e-6)
    assert not h["front_face"][0]
    np.testing.assert_allclose(h["normal"][0], [0, 0, 1], atol=1e-6)


def test_negative_radius_flips_normal():
    """RTiOW's hollow glass: a negative radius turns the outward normal in,
    so a ray from outside sees front_face false."""
    h = _shoot([[0, 0, -2]], [-0.5], [[0, 0, 0]], [[0, 0, -1]])
    assert h["hit"][0]
    assert not h["front_face"][0]
    np.testing.assert_allclose(h["normal"][0], [0, 0, 1], atol=1e-6)


def test_nearest_of_two():
    h = _shoot([[0, 0, -5], [0, 0, -2]], [0.5, 0.5], [[0, 0, 0]],
               [[0, 0, -1]], mats=[0, 0])
    np.testing.assert_allclose(h["t"][0], 1.5, rtol=1e-6)
    assert int(h["material"][0]) == 0


def test_material_id_carried():
    h = _shoot([[0, 0, -5], [0, 0, -2]], [0.5, 0.5], [[0, 0, 0]],
               [[0, 0, -1]], mats=[1, 2])
    assert int(h["material"][0]) == 2


def test_t_min_clipping():
    """A hit closer than t_min is rejected: the origin on the surface,
    pointing away (near root ~0, far root < 0)."""
    h = _shoot([[0, 0, -1]], [1.0], [[0, 0, 0]], [[0, 0, 1]])
    assert not h["hit"][0]


def test_tangent_ray_misses():
    """A grazing ray (disc == 0 in exact arithmetic, borderline in float32):
    no NaN, and the mask agrees with t."""
    h = _shoot([[0, 1, -2]], [1.0], [[0, 0, 0]], [[0, 0, -1]])
    assert np.isfinite(h["t"][0])
    assert bool(h["hit"][0]) == (h["t"][0] < T_MAX)


def test_oblique_hit_against_quadratic():
    center = np.array([0.3, -0.2, -3.0])
    radius = 0.7
    o = np.array([0.1, 0.2, 0.5])
    d = np.array([-0.05, -0.1, -1.0])
    d = d / np.linalg.norm(d)
    h = _shoot([center], [radius], [o], [d])
    oc = o - center
    a, hb, c = d @ d, oc @ d, oc @ oc - radius ** 2
    t_expect = (-hb - np.sqrt(hb * hb - a * c)) / a
    np.testing.assert_allclose(h["t"][0], t_expect, rtol=1e-5)
    p = o + t_expect * d
    np.testing.assert_allclose(h["point"][0], p, atol=1e-5)
    np.testing.assert_allclose(h["normal"][0], (p - center) / radius,
                               atol=1e-5)


def test_batched_rays():
    h = _shoot([[0, 0, -2]], [0.5], [[0, 0, 0], [10, 0, 0]],
               [[0, 0, -1], [0, 0, -1]])
    assert h["hit"][0] and not h["hit"][1]


# --- the camera -------------------------------------------------------------


def _rays(look_at_args, s, t, lu1=None, lu2=None, **kw):
    """The port's rays of Camera.look_at(*look_at_args, **kw) (or of
    `from_transform` when look_at_args is a 4x4 matrix) at image-plane
    points (s, t) and lens samples (lu1, lu2), held against the reference
    camera's on the same inputs.  Returns (camera, origins, dirs)."""
    s = np.asarray(s, np.float32).reshape(-1)
    t = np.asarray(t, np.float32).reshape(-1)
    lu1 = np.zeros_like(s) if lu1 is None else np.asarray(lu1, np.float32)
    lu2 = np.zeros_like(s) if lu2 is None else np.asarray(lu2, np.float32)
    if isinstance(look_at_args, np.ndarray):
        cam = Camera.from_transform(look_at_args, **kw)
        jcam = JCamera.from_transform(look_at_args, **kw)
    else:
        cam = Camera.look_at(*look_at_args, **kw)
        jcam = JCamera.look_at(*look_at_args, **kw)
    r = cam.generate_rays(*(torch.from_numpy(x) for x in (s, t, lu1, lu2)))
    jr = jcam.generate_rays(*(jnp.asarray(x) for x in (s, t, lu1, lu2)))
    got = r.origin.numpy(), r.dir.numpy()
    np.testing.assert_allclose(got[0], np.asarray(jr.origin), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got[1], np.asarray(jr.dir), rtol=0, atol=ATOL)
    for name in ("origin", "u", "v", "w", "half_width", "half_height",
                 "lens_radius", "focus_dist"):
        np.testing.assert_allclose(getattr(cam, name).numpy(),
                                   np.asarray(getattr(jcam, name)),
                                   rtol=1e-6, atol=ATOL, err_msg=name)
    return cam, got[0], got[1]


def test_center_pixel_points_forward():
    _, o, d = _rays(((0, 0, 0), (0, 0, -1)), [0.5], [0.5], vfov_deg=90.0,
                    aspect=2.0)
    np.testing.assert_allclose(d[0], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(o[0], [0, 0, 0], atol=1e-6)


def test_corner_pixel_fov():
    """vfov 90 degrees, aspect 2: at s = t = 1 the direction is (half_w,
    half_h, -1) = (2, 1, -1), normalized."""
    _, _, d = _rays(((0, 0, 0), (0, 0, -1)), [1.0], [1.0], vfov_deg=90.0,
                    aspect=2.0, focus_dist=1.0)
    expect = np.array([2.0, 1.0, -1.0])
    np.testing.assert_allclose(d[0], expect / np.linalg.norm(expect),
                               atol=1e-6)


def test_vertical_flip_convention():
    """t = 1 is the top of the image (+v side), t = 0 the bottom."""
    _, _, d = _rays(((0, 0, 0), (0, 0, -1)), [0.5, 0.5], [1.0, 0.0],
                    vfov_deg=90.0, aspect=1.0)
    assert d[0, 1] > 0 > d[1, 1]


def test_look_at_basis_orthonormal():
    cam, _, _ = _rays(((13, 2, 3), (0, 0, 0)), [0.5], [0.5], vfov_deg=20.0,
                      aspect=1.5)
    u, v, w = (x.numpy().astype(np.float64) for x in (cam.u, cam.v, cam.w))
    for a in (u, v, w):
        np.testing.assert_allclose(np.linalg.norm(a), 1.0, atol=1e-6)
    assert abs(u @ v) < 1e-6 and abs(u @ w) < 1e-6 and abs(v @ w) < 1e-6
    np.testing.assert_allclose(np.cross(u, v), w, atol=1e-6)  # right-handed
    # w points from lookat to lookfrom (backward).
    np.testing.assert_allclose(w, np.array([13, 2, 3]) / np.linalg.norm(
        [13, 2, 3]), atol=1e-6)


def test_thin_lens_rays_converge_at_focus_plane():
    """Two rays of one pixel through different lens points meet on the
    focus plane (z = -3), from origins that differ."""
    args = ((0, 0, 0), (0, 0, -1))
    kw = dict(vfov_deg=60.0, aspect=1.0, aperture=0.5, focus_dist=3.0)
    rays = [_rays(args, [0.3], [0.7], [a], [b], **kw)[1:]
            for a, b in ((0.9, 0.1), (0.2, 0.8))]
    p = [o[0] + (-3.0 - o[0, 2]) / d[0, 2] * d[0] for o, d in rays]
    np.testing.assert_allclose(p[0], p[1], atol=1e-5)
    assert np.linalg.norm(rays[0][0] - rays[1][0]) > 1e-3


def test_pinhole_origin_fixed():
    _, o, _ = _rays(((1, 2, 3), (0, 0, 0)), [0.1, 0.9], [0.2, 0.8],
                    [0.7, 0.3], [0.4, 0.6], vfov_deg=45.0, aspect=1.0,
                    aperture=0.0)
    np.testing.assert_allclose(o, np.broadcast_to([1, 2, 3], (2, 3)),
                               atol=1e-6)


def test_from_transform_matches_reference_lens_math():
    """The focus plane by the lens equation (d f) / (d - f), the aperture
    radius f / (2 fstop); -Z forward for the identity transform; a
    width-referenced fov."""
    cam, _, d = _rays(np.eye(4, dtype=np.float32), [0.5], [0.5], fov=1.5708,
                      aspect=16 / 9, image_plane_distance=10.0,
                      lens_focal_length=0.1, fstop=1 / 32)
    np.testing.assert_allclose(float(cam.focus_dist),
                               (10.0 * 0.1) / (10.0 - 0.1), rtol=1e-6)
    np.testing.assert_allclose(float(cam.lens_radius),
                               0.1 / (2.0 * (1 / 32)), rtol=1e-6)
    np.testing.assert_allclose(d[0], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(float(cam.half_width), np.tan(1.5708 / 2),
                               rtol=1e-6)
    np.testing.assert_allclose(float(cam.half_height),
                               np.tan(1.5708 / 2) / (16 / 9), rtol=1e-6)
