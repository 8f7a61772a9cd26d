"""Intersection, scatter and ray generation of the port against the JAX
package on the same random rays.

Winner indices and discrete masks are compared exactly.  Float outputs are
held at 2e-5 absolute: the two packages sum the K=3 inner products and the
transcendentals in different orders, a few float32 ulps on values of O(1)
to O(10)."""

import numpy as np
import jax.numpy as jnp
import torch

from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core import geometry as jgeo
from bevy_raytrace_tpu.core import materials as jmat
from bevy_raytrace_tpu.core.types import Ray as JRay
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch.core import geometry as tgeo
from bevy_raytrace_tpu_torch.core import materials as tmat
from bevy_raytrace_tpu_torch.core.types import Ray as TRay
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

ATOL = 2e-5


def _rays(n, seed):
    """Rays from random points around the rtiow field toward random
    directions (unit length)."""
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * [16, 4, 16] - [8, 0, 8]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def test_intersect_scene_fused_matches_reference():
    jscene, _ = jsc.rtiow_final_scene(seed=1, grid=4)
    tscene = scene_from_reference(jscene)
    o, d = _rays(4096, 0)
    jtab = jgeo.sphere_table(jscene.centers, jscene.radii, jscene.materials,
                             jscene.material_id)
    ttab = tgeo.sphere_table(tscene.centers, tscene.radii, tscene.materials,
                             tscene.material_id)
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    jout = jgeo.intersect_scene_fused(JRay(jnp.asarray(o), jnp.asarray(d)),
                                      jscene, 1e-3, 1e20, jtab,
                                      with_second=True)
    tout = tgeo.intersect_scene_fused(TRay(torch.from_numpy(o),
                                           torch.from_numpy(d)),
                                      tscene, 1e-3, 1e20, ttab,
                                      with_second=True)
    jhit, thit = jout[0], tout[0]
    assert 0.2 < float(np.asarray(jhit.hit).mean()) < 0.95
    # Every sphere of rtiow_final has a material of its own, so equal
    # material ids on hits are equal winner sphere indices.
    mid = np.asarray(jscene.material_id)
    assert len(np.unique(mid)) == len(mid)
    for f in ("hit", "front_face", "material"):
        np.testing.assert_array_equal(getattr(thit, f).numpy(),
                                      np.asarray(getattr(jhit, f)))
    h = np.asarray(jhit.hit)
    # rtol 1e-4: the expanded quadratic's c_q on the r = 1000 ground sphere
    # is a difference of ~1e6-sized terms, so t carries ~1e6 ulps of
    # cancellation noise that each package rounds its own way.
    np.testing.assert_allclose(thit.t.numpy()[h], np.asarray(jhit.t)[h],
                               rtol=1e-4, atol=ATOL)
    for f in ("point", "normal", "edge_m2"):
        np.testing.assert_allclose(getattr(thit, f).numpy(),
                                   np.asarray(getattr(jhit, f)), atol=1e-4)
    for g, w in zip(tout[1:5], jout[1:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # runner-up: the same sphere indices and attributes
    for g, w in zip(tout[5], jout[5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # intersect_scene is the fused form's hit
    np.testing.assert_array_equal(
        tgeo.intersect_scene(TRay(torch.from_numpy(o), torch.from_numpy(d)),
                             tscene, 1e-3, 1e20).t.numpy(), thit.t.numpy())


def test_scatter_matches_reference_all_kinds():
    n = 6144
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # shading normals face against the ray
    nrm = np.where((d * nrm).sum(1, keepdims=True) > 0, -nrm, nrm)
    front = rng.random(n) < 0.5
    albedo = rng.random((n, 3)).astype(np.float32)
    kind = np.repeat(np.arange(3, dtype=np.int32), n // 3)
    fuzz = (0.5 * rng.random(n)).astype(np.float32)
    ior = (1.0 + rng.random(n)).astype(np.float32)
    u = rng.random((4, n)).astype(np.float32)
    args = (d, nrm, front, albedo, kind, fuzz, ior)
    jd, ja, jok = jmat.scatter(*(jnp.asarray(a) for a in args),
                               tuple(jnp.asarray(x) for x in u))
    td, ta, tok = tmat.scatter(*(torch.from_numpy(a) for a in args),
                               tuple(torch.from_numpy(x) for x in u))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


def test_shading_helpers_match_reference():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c = rng.random(512).astype(np.float32)
    r = (0.5 + rng.random(512)).astype(np.float32)
    tv, tn, tc, tr = (torch.from_numpy(a) for a in (v, n, c, r))
    jv, jn, jc, jr = (jnp.asarray(a) for a in (v, n, c, r))
    pairs = [
        (tmat.sky_color(tv), jmat.sky_color(jv)),
        (tmat.reflect(tv, tn), jmat.reflect(jv, jn)),
        (tmat.refract(tv, tn, tr, tc), jmat.refract(jv, jn, jr, jc)),
        (tmat.schlick(tc, tr), jmat.schlick(jc, jr)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_generate_rays_matches_reference():
    jcam = jsc.rtiow_final_camera(1.5)
    tcam = camera_from_reference(jcam)
    rng = np.random.default_rng(5)
    s, t, u1, u2 = rng.random((4, 2048)).astype(np.float32)
    jr = jcam.generate_rays(*(jnp.asarray(a) for a in (s, t, u1, u2)))
    tr = tcam.generate_rays(*(torch.from_numpy(a) for a in (s, t, u1, u2)))
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin),
                               atol=ATOL)
    np.testing.assert_allclose(tr.dir.numpy(), np.asarray(jr.dir), atol=ATOL)
