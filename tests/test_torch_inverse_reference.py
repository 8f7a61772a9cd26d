"""The port's fast gradient path against the benchmark's plain gradient
reference (`benchmark/brtbench/reference_grad.py`), on the CPU: K2's and
K3's plain twins through `make_fast_renderer` with a cluster plan, on a
seeded scene of 24 spheres of the three materials, 32 x 24, 4 samples,
depth 4, `edge_softness` 0.01.  Then the reference's own gradient against
central finite differences of its forward, and `optimize_step` against
`optimize`'s loop.

Tolerances, each with its reason:
  * the image against the reference's own sweep: median pixel error
    <= 1e-6 (float32 rounding), <= 1% of pixels off by more than 1e-3 and
    mean bias <= 1e-3 (K2's expanded quadratic and the reference's
    centered one round a grazing exit's re-hit of its own sphere apart,
    and such a path takes another sample; the recorded paths differ from
    the sweep's on <= 1% of paths; 0.13%, 1e-4 and 0.03% here);
  * the gradients on the recorded paths: rtol 1e-5 of the norm, centers
    and albedo (the same paths, in two arithmetics: K3's twin normalizes
    with a correctly rounded 1/sqrt, the reference with rsqrt; 8e-8 and
    6e-7 here).  One frame's loss takes the program's image as the loss's
    image (K2's twin records with the expanded quadratic, whose image is
    up to 9e-4 off the replay's on 18 of 768 pixels here: 3.5e-4 of the
    center gradient); the port's loss, the cross estimator of two frames,
    takes the reference's own images (6e-6 and 7e-7 here);
  * finite differences in float64 along random directions, events fixed
    (Richardson-extrapolated central differences): rtol 1e-6;
  * the losses of `optimize_step` and of `optimize`: bit for bit.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch import Camera, RenderConfig, set_default_device
from bevy_raytrace_tpu_torch.core.types import make_scene
from bevy_raytrace_tpu_torch.inverse import (
    InverseProblem,
    make_fast_renderer,
    optimize,
    optimize_step,
)
from bevy_raytrace_tpu_torch.inverse.optimize import adam, leaf_params
from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
from bevy_raytrace_tpu_torch.kernels.record import render_record

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(_BENCH) not in sys.path:
    sys.path.insert(0, str(_BENCH))

from brtbench import reference, reference_grad  # noqa: E402

W, H, SPP, DEPTH, EDGE = 32, 24, 4, 4, 0.01
SEED, FRAME = 2**31 + 23, 5
CAM = dict(lookfrom=[7.0, 2.5, 6.0], lookat=[0.0, 0.4, 0.0],
           vup=(0.0, 1.0, 0.0), vfov_deg=35.0, aperture=0.05,
           focus_dist=7.0)


def _arrays(seed=7, n=24):
    """A ground sphere and n - 1 spheres of every material, one material
    each, from the seed: on a jittered 5 x 5 grid, apart and clear of the
    ground, so that no path starts inside another sphere."""
    g = np.random.default_rng(seed)
    k = n - 1
    cell = g.permutation(25)[:k]
    radius = g.uniform(0.2, 0.45, k)
    centers = np.concatenate([[[0.0, -100.0, 0.0]], np.stack(
        [(cell % 5 - 2) * 1.3 + g.uniform(-0.1, 0.1, k),
         radius + g.uniform(0.0, 0.4, k),
         (cell // 5 - 2) * 1.3 + g.uniform(-0.1, 0.1, k)], 1)])
    radii = np.concatenate([[100.0], radius])
    kind = np.concatenate([[0], g.integers(0, 3, k)])
    albedo = g.uniform(0.1, 0.9, (n, 3))
    albedo[kind == 2] = 1.0
    fuzz = np.where(kind == 1, g.uniform(0.0, 0.3, n), 0.0)
    f32 = torch.float32
    return reference.SceneArrays(
        centers=torch.tensor(centers, dtype=f32),
        radii=torch.tensor(radii, dtype=f32),
        material_id=torch.arange(n, dtype=torch.int32),
        albedo=torch.tensor(albedo, dtype=f32),
        kind=torch.tensor(kind, dtype=torch.int32),
        fuzz=torch.tensor(fuzz, dtype=f32),
        ior=torch.full((n,), 1.5, dtype=f32))


def _port_scene(a):
    return make_scene(a.centers, a.radii, a.material_id, a.albedo, a.kind,
                      a.fuzz, a.ior, device="cpu")


def _cams(n):
    c = reference.look_at(torch.tensor([CAM["lookfrom"]]),
                          torch.tensor([CAM["lookat"]]), CAM["vup"],
                          CAM["vfov_deg"], W / H, CAM["aperture"],
                          CAM["focus_dist"])
    return c.expand(n, 16)


def _camera():
    kw = {k: v for k, v in CAM.items() if k not in ("lookfrom", "lookat")}
    return Camera.look_at(CAM["lookfrom"], CAM["lookat"], aspect=W / H,
                          device="cpu", **kw)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def problem():
    """The program's image and gradient of a pixel loss through the fast
    renderer with a cluster plan, its recorded paths, and the reference's
    sweep and gradient on those paths."""
    arrays = _arrays()
    scene = _port_scene(arrays)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, seed=SEED, edge_softness=EDGE)
    plan = cluster_scene(scene, 5)
    camera = _camera()
    target = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(3))
    weights = torch.full((W * H,), 1.0 / (W * H))
    c = scene.centers.clone().requires_grad_(True)
    a = scene.materials.albedo.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, centers=c, materials=dataclasses.replace(
        scene.materials, albedo=a))
    img = make_fast_renderer(cfg, clusters=plan)(sc, camera, FRAME)
    d = img.reshape(-1, 3) - target
    gc, ga = torch.autograd.grad((weights[:, None] * d * d).sum(), [c, a])
    _, res, res2 = render_record(scene, camera, cfg, FRAME,
                                 record_second=True, clusters=plan)
    pids = torch.arange(W * H)
    seeds = torch.full((W * H,), reference.frame_seed(SEED, FRAME),
                       dtype=torch.int64)
    args = (arrays, _cams(W * H), pids, seeds, SPP, DEPTH, W, H)
    sweep = reference_grad.trace_pixels(*args)
    recorded = reference_grad.events_of(res, res2, pids)
    _, rc, ra = reference_grad.loss_grad(
        *args, target, weights, EDGE, events=recorded,
        image=img.detach().reshape(-1, 3))
    return dict(img=img.detach().reshape(-1, 3), gc=gc, ga=ga, rc=rc, ra=ra,
                sweep=sweep, recorded=recorded, args=args, target=target,
                weights=weights, cfg=cfg, plan=plan, scene=scene,
                camera=camera)


def test_fast_renderer_image_against_the_reference(problem):
    err = (problem["img"] - problem["sweep"].image).abs().amax(1)
    assert float(err.median()) <= 1e-6
    assert float((err > 1e-3).float().mean()) <= 0.01
    bias = (problem["img"] - problem["sweep"].image).mean(0).abs().max()
    assert float(bias) <= 1e-3
    differ = reference_grad.paths_differ(problem["recorded"],
                                         problem["sweep"].events)
    assert float(differ.float().mean()) <= 0.01


@pytest.mark.parametrize("name,rtol", [("centers", 1e-5), ("albedo", 1e-5)])
def test_fast_renderer_gradient_against_the_reference(problem, name, rtol):
    prog, ref = ((problem["gc"], problem["rc"]) if name == "centers"
                 else (problem["ga"], problem["ra"]))
    assert float(ref.norm()) > 0
    assert _rel(prog, ref) <= rtol


@pytest.fixture(scope="module")
def cross(problem):
    """The gradient of the port's loss (`InverseProblem.loss_fn`: the cross
    estimator of frames 2 STEP and 2 STEP + 1) through the fast renderer,
    and the reference's on the paths the recorder took in those frames."""
    step = 3
    cfg, plan, scene = problem["cfg"], problem["plan"], problem["scene"]
    fast = make_fast_renderer(cfg, clusters=plan)
    target = problem["target"].reshape(H, W, 3)
    prob = InverseProblem(cfg, problem["camera"], target,
                          ("centers", "albedo"),
                          lambda s, c, config, f: fast(s, c, f))
    params = leaf_params(scene, prob.optimizable)
    loss = prob.loss_fn(params, scene, step)
    gc, ga = torch.autograd.grad(loss, [params["centers"], params["albedo"]])
    frames = (2 * step, 2 * step + 1)
    pids = torch.arange(W * H)
    events = []
    for f in frames:
        _, res, res2 = render_record(scene, problem["camera"], cfg, f,
                                     record_second=True, clusters=plan)
        events.append(reference_grad.events_of(res, res2, pids))
    seeds = tuple(torch.full((W * H,), reference.frame_seed(SEED, f),
                             dtype=torch.int64) for f in frames)
    _, _, rc, ra = reference_grad.cross_loss_grad(
        problem["args"][0], _cams(W * H), pids, seeds, SPP, DEPTH, W, H,
        problem["target"], torch.full((W * H,), 1.0 / (W * H * 3)), EDGE,
        events=tuple(events))
    return dict(gc=gc, ga=ga, rc=rc, ra=ra)


@pytest.mark.parametrize("name", ["centers", "albedo"])
def test_cross_estimator_gradient_against_the_reference(cross, name):
    prog, ref = ((cross["gc"], cross["rc"]) if name == "centers"
                 else (cross["ga"], cross["ra"]))
    assert float(ref.norm()) > 0
    assert _rel(prog, ref) <= 1e-5


def test_reference_sweep_is_the_plain_reference(problem):
    """The gradient reference's sweep traces `reference.render_pixels`'
    paths: the same image, bit for bit, and the same rounds."""
    arrays, cams, pids, seeds = problem["args"][:4]
    img, rounds = reference.render_pixels(arrays, cams, pids, seeds, SPP,
                                          DEPTH, W, H)
    assert torch.equal(problem["sweep"].image, img)
    assert torch.equal(problem["sweep"].rounds, rounds)


@pytest.mark.parametrize("name", ["centers", "albedo"])
def test_reference_gradient_against_finite_differences(problem, name):
    """edge_softness 0, float64, the sweep's events fixed: the gradient
    along three random directions against central differences of the
    reference's own forward."""
    arrays, cams, pids, seeds = problem["args"][:4]
    f64 = torch.float64
    a64 = dataclasses.replace(arrays, centers=arrays.centers.to(f64),
                              albedo=arrays.albedo.to(f64))
    events = problem["sweep"].events
    target, w = problem["target"].to(f64), problem["weights"].to(f64)
    dims = (SPP, DEPTH, W, H)
    _, dc, da = reference_grad.loss_grad(a64, cams, pids, seeds, *dims,
                                         target, w, 0.0, dtype=f64,
                                         events=events)
    grad = dc if name == "centers" else da
    assert float(grad.norm()) > 0

    def loss(scene):
        img = reference_grad.trace_pixels(scene, cams, pids, seeds, *dims,
                                          dtype=f64, events=events).image
        return float((w[:, None] * (img - target) ** 2).sum())

    def central(v, eps):
        base = getattr(a64, name)
        plus = dataclasses.replace(a64, **{name: base + eps * v})
        minus = dataclasses.replace(a64, **{name: base - eps * v})
        return (loss(plus) - loss(minus)) / (2 * eps)

    g = torch.Generator().manual_seed(11)
    for _ in range(3):
        v = torch.randn(grad.shape, generator=g, dtype=f64)
        # Richardson's extrapolation: a glass path's curvature leaves a
        # plain central difference at 1e-6 off by ~7e-5.
        fd = (4.0 * central(v, 1e-6) - central(v, 2e-6)) / 3.0
        assert fd == pytest.approx(float((grad * v).sum()), rel=1e-6)


@pytest.mark.parametrize("side", ["reference", "program"])
def test_masked_loss_is_the_gradient_of_its_pixels_alone(problem, side):
    """The loss over a seeded set of pixels has the gradient of the loss
    over every pixel with the others' weights zero."""
    n = W * H
    pick = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        n, 40, replace=False)))
    w_all = torch.zeros(n)
    w_all[pick] = 1.0 / 40
    target = problem["target"]
    if side == "reference":
        arrays, cams, pids, seeds = problem["args"][:4]
        dims = (SPP, DEPTH, W, H)
        events = problem["recorded"]
        lanes = (pick[:, None] * SPP + torch.arange(SPP)).reshape(-1)
        _, dc, da = reference_grad.loss_grad(
            arrays, cams[pick], pick, seeds[pick], *dims, target[pick],
            torch.full((40,), 1.0 / 40), EDGE, events=events[:, :, lanes],
            image=problem["img"][pick])
        _, fc, fa = reference_grad.loss_grad(
            arrays, cams, pids, seeds, *dims, target, w_all, EDGE,
            events=events, image=problem["img"])
    else:
        fast = make_fast_renderer(problem["cfg"], clusters=problem["plan"])
        scene = problem["scene"]

        def grads(loss_of):
            c = scene.centers.clone().requires_grad_(True)
            a = scene.materials.albedo.clone().requires_grad_(True)
            sc = dataclasses.replace(scene, centers=c,
                                     materials=dataclasses.replace(
                                         scene.materials, albedo=a))
            img = fast(sc, problem["camera"], FRAME).reshape(-1, 3)
            return torch.autograd.grad(loss_of(img), [c, a])

        dc, da = grads(lambda img: (((img[pick] - target[pick]) ** 2).sum(1)
                                    / 40).sum())
        fc, fa = grads(lambda img: (w_all[:, None] * (img - target) ** 2
                                    ).sum())
    assert float(dc.norm()) > 0 and float(da.norm()) > 0
    assert _rel(dc, fc) <= 1e-5 and _rel(da, fa) <= 1e-5


def test_optimize_step_gives_optimizes_losses_bit_for_bit():
    """`optimize`, a loop of `optimize_step` as a caller drives it, and the
    loop body `optimize` had before the step was split out give the same
    losses and parameters, bit for bit."""
    arrays = _arrays(seed=9, n=8)
    scene = _port_scene(arrays)
    cfg = RenderConfig(width=16, height=12, samples_per_pixel=2,
                       max_depth=3, seed=4, edge_softness=EDGE)
    fast = make_fast_renderer(cfg)
    target = fast(scene, _camera(), 99).detach()
    start = dataclasses.replace(scene, centers=scene.centers + 0.03)
    prob = InverseProblem(cfg, _camera(), target, ("centers", "albedo"),
                          lambda s, k, c, f: fast(s, k, f))
    steps, lr = 4, 1e-2
    got = optimize(start, prob, steps=steps, learning_rate=lr)

    def drive(body):
        params = leaf_params(start, prob.optimizable)
        opt = adam(lr)([params[n] for n in prob.optimizable])
        losses = [body(params, opt, k) for k in range(steps)]
        return losses, params

    def before_split(params, opt, k):
        opt.zero_grad(set_to_none=True)
        loss = prob.loss_fn(params, start, k)
        loss.backward()
        opt.step()
        return float(loss.detach())

    stepped, p1 = drive(lambda params, opt, k: float(optimize_step(
        prob, start, params, opt, k)))
    old, p0 = drive(before_split)
    assert got.losses == stepped == old
    assert torch.equal(got.scene.centers, p1["centers"].detach())
    assert torch.equal(p0["centers"], p1["centers"])
    assert torch.equal(got.scene.materials.albedo, p1["albedo"].detach())
