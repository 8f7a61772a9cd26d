"""One rank of a sharded self-check: the sharded renderers and gradients
against the single-process ones, over a real `torch.distributed` group.

    python -m bevy_raytrace_tpu_torch.shard.worker --rank R --world N \\
        --hosts H --addr HOST:PORT [--device cpu] \\
        [--step W H SPP DEPTH [--repeats N] [--trace-dir DIR]]

Start N of them (ranks 0..N-1, one per device; `--device cpu` runs them on
the CPU over gloo, as the tests do).  Every rank renders baseline_config2
at a small size both ways and holds:

  * the gathered images of `render_sharded`, `render_mxu_sharded` (with and
    without `balance`), `make_fast_renderer_sharded` (forward "pallas" and
    "sweep", edge_softness 0 and 0.01) and the sharded `Renderer` backends
    BIT-IDENTICAL to the single-process ones;
  * the all-reduced gradients of sum(img * w) equal to the single-process
    ones to rtol 1e-4, atol 1e-5 of max-abs (float32 summation order),
    whether the loss is taken on the gathered image or stripe by stripe;
  * no collective in a forward without `gather`, exactly one all-reduce in
    a backward, of (11 S + 16) * 4 bytes in the fast backward.

With `--step W H SPP DEPTH` it then times the sharded workload at that
shape on the RTiOW final scene (`timed_steps`: K1's sharded forward and the
sharded fast-gradient step, the best of `--repeats`; with `--trace-dir
DIR`, rank 0 writes a `trace_profile` trace of one more gradient step).
Prints one JSON line of what it counted and timed and exits 0, or raises.

`launch_ranks(world, device, args)` starts the ranks of one world and
collects their lines (`graft_entry.dryrun_multichip` and `tools.scaling`
use it).  With `--dryrun` a rank runs `dryrun_step` instead (`graft_entry.
dryrun_multichip` starts the ranks that way): one full training step and one
sharded fast-gradient step at tiny shapes, finite or an error.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time


def _close(got, want, what):
    import torch

    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and scale > 0.0):
        raise AssertionError(f"{what}: non-finite or all-zero gradient")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(
            f"{what}: sharded gradient off by "
            f"{float((got - want).abs().max()):.3e} of max-abs {scale:.3e}")


def dryrun_step(mesh) -> dict:
    """One training step and one fast-gradient step over `mesh` at tiny
    shapes (width 8 per rank, height 8, 2 spp, depth 3, edge_softness 0.01,
    rtiow_final_scene(0, grid=2)): the sharded render of the target, the
    two-sample cross loss on sharded renders, its gradient with respect to
    the replicated centers and albedo (summed over the ranks by the
    backward's all-reduce), one Adam update; then the gradient of an L2 loss
    through `make_fast_renderer_sharded` at the updated parameters.  Raises
    unless the loss and every gradient are finite -> what it measured."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.inverse import make_fast_renderer_sharded
    from bevy_raytrace_tpu_torch.shard import render_sharded

    config = RenderConfig(width=8 * mesh.world_size, height=8,
                          samples_per_pixel=2, max_depth=3,
                          edge_softness=0.01)
    scene, _ = scenes.rtiow_final_scene(seed=0, grid=2, device=mesh.device)
    camera = scenes.rtiow_final_camera(config.aspect, device=mesh.device)
    with torch.no_grad():
        target = render_sharded(scene, camera, config, mesh, gather=True)

    params = {"centers": scene.centers.clone().requires_grad_(True),
              "albedo": scene.materials.albedo.clone().requires_grad_(True)}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)

    def with_params():
        mats = dataclasses.replace(scene.materials, albedo=params["albedo"])
        return dataclasses.replace(scene, centers=params["centers"],
                                   materials=mats)

    # Two-sample cross estimator (an unbiased gradient under Monte-Carlo
    # noise); both renders are pixel-sharded over the whole mesh.
    frame = 0
    img_a = render_sharded(with_params(), camera, config, mesh, 2 * frame,
                           gather=True)
    img_b = render_sharded(with_params(), camera, config, mesh,
                           2 * frame + 1, gather=True)
    loss = torch.mean((img_a - target) * (img_b - target))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    train_grads = {k: v.grad.clone() for k, v in params.items()}
    opt.step()
    if not (bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in train_grads.values())):
        raise AssertionError(f"non-finite training step: loss {loss}")

    # The sharded fast gradient path: the recording forward and the replay
    # kernel per rank stripe, the table and camera cotangents summed over
    # the mesh; edge_softness exercises the runner-up residual stream too.
    fast = make_fast_renderer_sharded(config, mesh)
    img = fast(with_params(), camera, 1, gather=True)
    g_fast = torch.autograd.grad(torch.mean((img - target) ** 2),
                                 list(params.values()))
    if not all(bool(torch.isfinite(g).all()) for g in g_fast):
        raise AssertionError("non-finite sharded fast-grad")
    return {"loss": float(loss), "width": config.width,
            "height": config.height, "spheres": scene.count,
            "moved": float((params["centers"].detach()
                            - scene.centers).abs().max()),
            "train_grad_max": {k: float(g.abs().max())
                               for k, g in train_grads.items()},
            "fast_grad_max": {k: float(g.abs().max())
                              for k, g in zip(params, g_fast)},
            "fast_all_reduces": fast.stats["all_reduces"]}


def timed_steps(mesh, shape, repeats: int, trace_dir=None) -> dict:
    """The sharded workload on this rank, timed: the RTiOW final scene
    (seed 0, 486 spheres) at `shape` = (width, height, spp, depth).  K1's
    sharded forward (`render_mxu_sharded`, the stripe only) and one sharded
    fast-gradient step of d mean(img^2) / d centers at frame 1 (K2 culled
    by a plan at cluster size 12, then K3 and the one all-reduce), as the
    bench's `grad_flagship` leg takes it single-process.  Each runs once
    warm, then `repeats` times, every run begun after a barrier and ended at
    the device's end (host clock).  With `trace_dir`, rank 0 writes a
    `trace_profile` trace of one more gradient step (every rank takes it:
    its backward is a collective).  -> {"shape", "paths", "spheres",
    "all_reduce_bytes" (the gradient's payload), "frame_s", "step_s" (the
    times of this rank's runs)}.  Raises on a black or non-finite frame or
    a non-finite gradient."""
    import torch
    import torch.distributed as dist

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.inverse import make_fast_renderer_sharded
    from bevy_raytrace_tpu_torch.kernels import cluster_scene
    from bevy_raytrace_tpu_torch.shard import render_mxu_sharded
    from bevy_raytrace_tpu_torch.utils.metrics import trace_profile

    width, height, spp, depth = shape
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth)
    scene, _ = scenes.rtiow_final_scene(seed=0)
    cam = scenes.rtiow_final_camera(cfg.aspect)
    fast = make_fast_renderer_sharded(
        cfg, mesh, clusters=cluster_scene(scene, cluster_size=12))

    def sync(out):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return out

    def frame():
        with torch.no_grad():
            return sync(render_mxu_sharded(scene, cam, cfg, mesh, 1))

    def step():
        c = scene.centers.clone().requires_grad_(True)
        stripe = fast(dataclasses.replace(scene, centers=c), cam, 1)
        loss = torch.sum(stripe ** 2) / (cfg.num_pixels * 3)
        (grad,) = torch.autograd.grad(loss, c)
        return sync(grad)

    def timed(fn):
        out = fn()
        times = []
        for _ in range(repeats):
            dist.barrier()
            sync(None)
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, times

    img, frame_s = timed(frame)
    mean = float(img.mean())
    if not (math.isfinite(mean) and mean > 0.0):
        raise AssertionError(f"sharded frame mean {mean}: not a render")
    grad, step_s = timed(step)
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError("sharded fast gradient: non-finite")
    if trace_dir:
        with (trace_profile(trace_dir) if mesh.rank == 0
              else contextlib.nullcontext()):
            step()
    return {"shape": [width, height, spp, depth],
            "paths": cfg.rays_per_frame, "spheres": scene.count,
            "all_reduce_bytes": fast.stats["all_reduce_bytes"],
            "frame_s": frame_s, "step_s": step_s}


def launch_ranks(world: int, device, args=(), hosts: int = 1,
                 timeout: float = 600.0) -> list:
    """Start `world` ranks of this worker on a free local port, with `args`
    added to each command line -> their JSON lines, in rank order.  On a
    CUDA `device` the ranks take nccl, one card each; otherwise they get
    `--device` (gloo).  Raises RuntimeError with a failing rank's output;
    every process has ended when it returns or raises."""
    import os
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "bevy_raytrace_tpu_torch.shard.worker",
           "--world", str(world), "--hosts", str(hosts), "--addr",
           f"127.0.0.1:{port}", *args]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    procs = [subprocess.Popen(cmd + ["--rank", str(rank)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(world)]
    reports = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {rank} of {world} failed:\n{out}\n{err}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--addr", required=True, help="HOST:PORT of rank 0")
    ap.add_argument("--device", default=None,
                    help='"cpu" runs on the CPU over gloo; default: CUDA')
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--step", type=int, nargs=4, default=None,
                    metavar=("W", "H", "SPP", "DEPTH"),
                    help="time the sharded workload at this shape on the "
                         "RTiOW final scene (timed_steps)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of each, after a warm one")
    ap.add_argument("--trace-dir", default=None,
                    help="with --step, rank 0 writes a torch.profiler "
                         "trace of one sharded fast-gradient step to "
                         "DIR/trace.json")
    ap.add_argument("--dryrun", action="store_true",
                    help="run one tiny training step and one fast-gradient "
                         "step instead of the self-check")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.core.camera import Camera
    from bevy_raytrace_tpu_torch.device import set_default_device
    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        make_fast_renderer_sharded,
    )
    from bevy_raytrace_tpu_torch.kernels.render_lanes import render_mxu
    from bevy_raytrace_tpu_torch.shard import (
        initialize_multihost,
        make_mesh,
        render_mxu_sharded,
        render_sharded,
    )
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
    from bevy_raytrace_tpu_torch.wavefront.render import render

    if args.device is not None:
        set_default_device(args.device)
    torch.set_num_threads(1)
    initialize_multihost(args.addr, args.world, args.rank)
    mesh = make_mesh(hosts=args.hosts)
    if mesh.rank != dist.get_rank() or mesh.rank != (
            mesh.host * mesh.chips + mesh.chip):
        raise AssertionError(f"rank arithmetic: {mesh}")
    if args.dryrun:
        report = dryrun_step(mesh)
        dist.barrier()
        dist.destroy_process_group()
        print(json.dumps({
            "ok": True, "rank": mesh.rank, "hosts": mesh.hosts,
            "chips": mesh.chips, "device": str(mesh.device),
            "backend": "nccl" if mesh.device.type == "cuda" else "gloo",
            **report}), flush=True)
        return 0

    # Count the collectives the package calls.
    calls = {"all_reduce": 0, "all_gather": 0}
    real = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    for name in calls:
        setattr(dist, name, counted(name))

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=2, max_depth=3)
    n = cfg.num_pixels
    local = n // mesh.world_size
    lo = mesh.rank * local
    scene, _ = scenes.baseline_config2_scene()
    cam = scenes.baseline_config2_camera(cfg.aspect)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((cfg.height, cfg.width, 3), generator=gen).to(mesh.device)
    w_stripe = w.reshape(n, 3)[lo:lo + local]

    def grads(render_fn, weights):
        """d sum(img * weights) / d (centers, albedo, camera)."""
        c = scene.centers.clone().requires_grad_(True)
        a = scene.materials.albedo.clone().requires_grad_(True)
        k = cam.pack().clone().requires_grad_(True)
        sc = dataclasses.replace(
            scene, centers=c,
            materials=dataclasses.replace(scene.materials, albedo=a))
        img = render_fn(sc, Camera.from_packed(k))
        torch.sum(img * weights).backward()
        return img.detach(), (c.grad, a.grad, k.grad)

    def collectives():
        return calls["all_reduce"] + calls["all_gather"]

    # ---- the wavefront, sharded ------------------------------------------
    want = render(scene, cam, cfg, 1)
    before = collectives()
    stripe = render_sharded(scene, cam, cfg, mesh, 1)
    forward_collectives = collectives() - before
    if not torch.equal(stripe, want.reshape(n, 3)[lo:lo + local]):
        raise AssertionError("render_sharded stripe differs")
    if not torch.equal(render_sharded(scene, cam, cfg, mesh, 1, gather=True),
                       want):
        raise AssertionError("render_sharded gathered image differs")
    _, want_g = grads(lambda s, c: render(s, c, cfg, 1), w)
    before = calls["all_reduce"]
    _, got_g = grads(lambda s, c: render_sharded(s, c, cfg, mesh, 1,
                                                 gather=True), w)
    wavefront_all_reduces = calls["all_reduce"] - before
    for got, ref, what in zip(got_g, want_g, ("centers", "albedo", "camera")):
        _close(got, ref, f"render_sharded {what}")

    # ---- K1, sharded ------------------------------------------------------
    want = render_mxu(scene, cam, cfg, 1)
    for balance in (False, True):
        before = collectives()
        stripe = render_mxu_sharded(scene, cam, cfg, mesh, 1, balance=balance)
        forward_collectives += collectives() - before
        got = render_mxu_sharded(scene, cam, cfg, mesh, 1, balance=balance,
                                 gather=True)
        if not (torch.equal(got, want) and torch.equal(
                stripe, want.reshape(n, 3)[lo:lo + local])):
            raise AssertionError(f"render_mxu_sharded(balance={balance}) "
                                 "differs")

    # ---- the fast gradient path, sharded ----------------------------------
    fast_all_reduces, payload = [], set()
    for forward in ("pallas", "sweep"):
        for edge in (0.0, 0.01):
            ecfg = cfg.replace(edge_softness=edge)
            single = make_fast_renderer(ecfg, forward=forward)
            sharded = make_fast_renderer_sharded(ecfg, mesh, forward=forward)
            want, want_g = grads(lambda s, c: single(s, c, 1), w)
            before = collectives()
            stripe = sharded(scene, cam, 1)
            forward_collectives += collectives() - before
            if not torch.equal(stripe, want.reshape(n, 3)[lo:lo + local]):
                raise AssertionError(f"fast {forward} stripe differs")
            for label, fn, weights in (
                    ("gathered", lambda s, c: sharded(s, c, 1, gather=True),
                     w),
                    ("stripe", lambda s, c: sharded(s, c, 1), w_stripe)):
                before = calls["all_reduce"]
                img, got_g = grads(fn, weights)
                fast_all_reduces.append(calls["all_reduce"] - before)
                if label == "gathered" and not torch.equal(img, want):
                    raise AssertionError(f"fast {forward} image differs")
                for got, ref, what in zip(got_g, want_g,
                                          ("centers", "albedo", "camera")):
                    _close(got, ref, f"fast {forward} edge {edge} {label} "
                                     f"{what}")
            payload.add(sharded.stats["all_reduce_bytes"])

    # ---- the Renderer backends --------------------------------------------
    for backend, ref in (("sharded", render), ("cuda-sharded", render_mxu)):
        r = Renderer(cfg, backend=backend, mesh=mesh)
        for frame in range(2):
            if not torch.equal(r.render_frame(scene, cam),
                               ref(scene, cam, cfg, frame)):
                raise AssertionError(f'Renderer("{backend}") frame {frame}')

    timed = {}
    if args.step:
        timed["timed"] = timed_steps(mesh, args.step, args.repeats,
                                     args.trace_dir)

    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({
        "ok": True, "rank": mesh.rank, "host": mesh.host, "chip": mesh.chip,
        "hosts": mesh.hosts, "chips": mesh.chips, "device": str(mesh.device),
        "backend": "nccl" if mesh.device.type == "cuda" else "gloo",
        "stripe": [lo, lo + local], "spheres": scene.count,
        "forward_collectives": forward_collectives,
        "wavefront_backward_all_reduces": wavefront_all_reduces,
        "fast_backward_all_reduces": fast_all_reduces,
        "all_reduce_bytes": sorted(payload), **timed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
