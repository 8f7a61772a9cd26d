"""The port's scalar oracle (`wavefront/oracle.py`): equal to the
reference's oracle, and the independent check of the port's wavefront.

Both oracles are numpy scalar code in float64 on bit-exact PCG4D draws, so
they agree to 1e-6 (the port's scene arrays are the reference's bit for
bit).  The port's wavefront `render` is then held against the port's oracle
at tests/test_render.py's bounds: two formulations of the same light
transport, one in float32.
"""

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.wavefront.oracle import render_oracle as j_oracle
from bevy_raytrace_tpu_torch import RenderConfig, render, set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.wavefront.oracle import render_oracle

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

TINY = dict(width=40, height=24, samples_per_pixel=4, max_depth=4)
FINAL = dict(width=32, height=18, samples_per_pixel=2, max_depth=4)
CASES = {
    "config1": ("baseline_config1_scene", "baseline_config1_camera", {},
                TINY, 0.005),
    "config2": ("baseline_config2_scene", "baseline_config2_camera", {},
                TINY, 0.005),
    # Dielectrics and the aperture-0.1 defocus camera, at a small grid.
    "final_grid": ("rtiow_final_scene", "rtiow_final_camera",
                   dict(seed=3, grid=3), FINAL, 0.01),
    "final_grid2_tiny": ("rtiow_final_scene", "rtiow_final_camera",
                         dict(seed=0, grid=2), TINY, 0.01),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    scene_fn, cam_fn, kw, cfg_kw, bad_frac = CASES[request.param]
    cfg = RenderConfig(**cfg_kw)
    scene = getattr(tsc, scene_fn)(**kw)[0]
    cam = getattr(tsc, cam_fn)(cfg.aspect)
    jcfg = JConfig(**cfg_kw)
    jscene = getattr(jsc, scene_fn)(**kw)[0]
    jcam = getattr(jsc, cam_fn)(jcfg.aspect)
    return {"cfg": cfg, "scene": scene, "cam": cam, "bad_frac": bad_frac,
            "oracle": render_oracle(scene, cam, cfg),
            "reference": j_oracle(jscene, jcam, jcfg)}


def test_oracle_equals_the_reference_oracle(case):
    got, want = case["oracle"], case["reference"]
    assert got.shape == want.shape == (case["cfg"].height, case["cfg"].width,
                                       3)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_wavefront_matches_the_oracle(case):
    """Float32 against float64 can flip a discrete branch (Schlick against
    its uniform, the fuzz horizon) on a handful of paths: near-exact
    agreement on almost all pixels (tests/test_render.py:32-40)."""
    with torch.no_grad():
        img = render(case["scene"], case["cam"], case["cfg"]).numpy()
    err = np.abs(img - case["oracle"]).max(axis=-1)
    assert np.median(err) < 2e-4, f"median err {np.median(err)}"
    assert (err > 2e-2).mean() <= case["bad_frac"], (
        f"{(err > 2e-2).mean():.4%} pixels deviate more than 2e-2")


def test_oracle_frame_and_depth():
    """Another frame draws other samples; depth 0 is black."""
    cfg = RenderConfig(width=8, height=6, samples_per_pixel=1, max_depth=2)
    scene = tsc.baseline_config1_scene()[0]
    cam = tsc.baseline_config1_camera(cfg.aspect)
    a, b = render_oracle(scene, cam, cfg, 0), render_oracle(scene, cam, cfg, 1)
    assert np.abs(a - b).max() > 1e-3
    black = render_oracle(scene, cam, cfg.replace(max_depth=0))
    np.testing.assert_array_equal(black, np.zeros((6, 8, 3)))
