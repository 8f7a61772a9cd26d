"""The port's sharded paths (`shard/`, `inverse/shard_grad.py`): real
`torch.distributed` process groups on the CPU (gloo), and the single-process
forms.

The multi-process cases spawn `python -m bevy_raytrace_tpu_torch.shard.worker`
once per rank (the analog of tests/test_multihost.py's 2-process run, and a
2x2 mesh of 4 processes that exercises the hosts-major rank).  Every worker
holds, on baseline_config2 at 64x32, 2 spp, depth 3: gathered
`render_sharded`, `render_mxu_sharded` (with and without `balance`),
`make_fast_renderer_sharded` (K2 and K4 forward, edge_softness 0 and 0.01)
and sharded `Renderer` images bit-identical to the single-process ones;
all-reduced gradients of sum(img * w) within rtol 1e-4, atol 1e-5 of max-abs
of the single-process ones (tests/test_shard_grad.py:76-82: the sum runs in
another order); and counts the collectives by wrapping
`torch.distributed.all_reduce` / `all_gather`.  This file checks what they
report.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.inverse import (
    make_fast_renderer_sharded as j_fast_sharded,
)
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import (
    make_fast_renderer,
    make_fast_renderer_sharded,
)
from bevy_raytrace_tpu_torch.kernels.render_lanes import render_mxu
from bevy_raytrace_tpu_torch.parity import grad_close
from bevy_raytrace_tpu_torch.shard import (
    RAY_AXES,
    make_mesh,
    make_sharded_renderer,
    render_mxu_sharded,
    render_sharded,
)
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
from bevy_raytrace_tpu_torch.wavefront.render import render

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(width=64, height=32, samples_per_pixel=2, max_depth=3)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(world, hosts):
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bevy_raytrace_tpu_torch.shard.worker",
         "--rank", str(rank), "--world", str(world), "--hosts", str(hosts),
         "--addr", addr, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_REPO) for rank in range(world)]
    reports = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {rank} failed:\n{out}\n{err}"
            reports.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail("a sharded worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return reports


@pytest.mark.parametrize("world,hosts", [(2, 2), (4, 2)],
                         ids=["2_processes", "2x2_mesh"])
def test_process_group_matches_single_process(world, hosts):
    reports = _run_workers(world, hosts)
    chips = world // hosts
    local = KW["width"] * KW["height"] // world
    for rank, r in enumerate(reports):
        assert r["ok"] and r["backend"] == "gloo" and r["device"] == "cpu"
        # Hosts-major: consecutive ranks are the chips of one host.
        assert (r["rank"], r["host"], r["chip"]) == (rank, rank // chips,
                                                     rank % chips)
        assert (r["hosts"], r["chips"]) == (hosts, chips)
        assert r["stripe"] == [rank * local, (rank + 1) * local]
        # No collective in a forward without gather; one all-reduce in each
        # backward; the fast backward's payload is the [S, 11] table
        # cotangent and the 16 camera scalars in float32.
        assert r["forward_collectives"] == 0
        assert r["wavefront_backward_all_reduces"] == 1
        assert r["fast_backward_all_reduces"] == [1] * 8
        assert r["all_reduce_bytes"] == [(11 * r["spheres"] + 16) * 4]


def _torch_grads(render_fn, scene, cam, w):
    c = scene.centers.clone().requires_grad_(True)
    a = scene.materials.albedo.clone().requires_grad_(True)
    sc = dataclasses.replace(
        scene, centers=c,
        materials=dataclasses.replace(scene.materials, albedo=a))
    img = render_fn(sc, cam)
    torch.sum(img * torch.from_numpy(w)).backward()
    return img.detach(), {"centers": c.grad.numpy(), "albedo": a.grad.numpy()}


def test_world_size_one_is_the_single_process_path():
    """Without a process group `make_mesh()` is a 1x1 mesh, collectives are
    the identity, and every sharded entry point equals its unsharded one."""
    mesh = make_mesh()
    assert RAY_AXES == ("hosts", "chips")
    assert (mesh.hosts, mesh.chips, mesh.rank, mesh.world_size) == (1, 1, 0, 1)
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    cfg = RenderConfig(**KW, edge_softness=0.01)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    n = cfg.num_pixels
    want = render(scene, cam, cfg, 1)
    assert torch.equal(render_sharded(scene, cam, cfg, mesh, 1),
                       want.reshape(n, 3))
    assert torch.equal(make_sharded_renderer(cfg, mesh)(scene, cam, 1,
                                                        gather=True), want)
    assert torch.equal(
        render_mxu_sharded(scene, cam, cfg, mesh, 1, balance=True,
                           gather=True), render_mxu(scene, cam, cfg, 1))
    assert torch.equal(Renderer(cfg, backend="sharded").render_frame(
        scene, cam), render(scene, cam, cfg, 0))
    black = render_mxu_sharded(scene, cam, cfg.replace(max_depth=0), mesh)
    assert black.shape == (n, 3) and not bool(black.any())

    w = np.random.default_rng(2).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)
    single = make_fast_renderer(cfg)
    sharded = make_fast_renderer_sharded(cfg, mesh)
    want_img, want_g = _torch_grads(lambda s, c: single(s, c, 1), scene, cam, w)
    got_img, got_g = _torch_grads(lambda s, c: sharded(s, c, 1, gather=True),
                                  scene, cam, w)
    assert torch.equal(got_img, want_img)
    for name in want_g:
        np.testing.assert_array_equal(got_g[name], want_g[name])
    # No group: no all-reduce was called, and the payload is still reported.
    assert sharded.stats == {"all_reduces": 0,
                             "all_reduce_bytes": (11 * scene.count + 16) * 4}


def test_indivisible_shapes_raise():
    cfg = RenderConfig(width=7, height=3, samples_per_pixel=1, max_depth=1)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    two = dataclasses.replace(make_mesh(), chips=2, world_size=2)
    for call in (lambda: render_sharded(scene, cam, cfg, two),
                 lambda: render_mxu_sharded(scene, cam, cfg, two),
                 lambda: make_fast_renderer_sharded(cfg, two),
                 lambda: Renderer(cfg, backend="sharded", mesh=two)):
        with pytest.raises(ValueError, match="must divide over 2 devices"):
            call()
    with pytest.raises(ValueError, match="not divisible by 2 hosts"):
        make_mesh(hosts=2)
    with pytest.raises(TypeError, match="ClusterPlan"):
        make_fast_renderer_sharded(RenderConfig(**KW), make_mesh(),
                                   clusters=object())


def test_sharded_fast_gradient_takes_a_cluster_plan():
    """make_fast_renderer_sharded(clusters=plan) passes the plan to K2 on
    the rank's stripe: the image and the gradient of the renderer without
    a plan (the same recorded paths)."""
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene

    cfg = RenderConfig(**{**KW, "edge_softness": 0.01})
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    w = np.random.default_rng(6).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)
    plan = cluster_scene(scene, cluster_size=6)
    out = []
    for clusters in (plan, None):
        fast = make_fast_renderer_sharded(cfg, make_mesh(), clusters=clusters)
        c = scene.centers.clone().requires_grad_(True)
        img = fast(dataclasses.replace(scene, centers=c), cam, 1, gather=True)
        torch.sum(img * torch.from_numpy(w)).backward()
        out.append((img.detach(), c.grad))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    assert float(out[1][1].abs().max()) > 0.0
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)


def test_fast_gradient_matches_jax_sharded_on_virtual_devices():
    """The JAX package's sharded fast gradient on a 2x4 mesh of the
    conftest's 8 virtual CPU devices (interpret mode) against the port's
    fast gradient on the same inputs: parity.grad_close at rtol 2e-3, as
    test_torch_fast_grad.py holds the unsharded pair."""
    kw = {**KW, "edge_softness": 0.01}
    jscene, _ = jsc.baseline_config2_scene()
    jcam = jsc.baseline_config2_camera(kw["width"] / kw["height"])
    w = np.random.default_rng(4).standard_normal(
        (kw["height"], kw["width"], 3)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), RAY_AXES)
    jfast = j_fast_sharded(JConfig(**kw), jmesh, interpret=True)

    def loss(centers, albedo):
        mats = dataclasses.replace(jscene.materials, albedo=albedo)
        sc = dataclasses.replace(jscene, centers=centers, materials=mats)
        return jnp.sum(jfast(sc, jcam, 1) * jnp.asarray(w))

    want = dict(zip(("centers", "albedo"), (np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1))(jscene.centers, jscene.materials.albedo))))
    fast = make_fast_renderer_sharded(RenderConfig(**kw), make_mesh())
    _, got = _torch_grads(lambda s, c: fast(s, c, 1, gather=True),
                          scene_from_reference(jscene),
                          camera_from_reference(jcam), w)
    glob = max(float(np.abs(v).max()) for v in want.values())
    assert glob > 0.0
    for name in want:
        stats = grad_close(got[name], want[name], 2e-3, glob)
        assert stats["ok"], (name, stats)
