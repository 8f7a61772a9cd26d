#!/usr/bin/env python
"""The port's benchmark: rays/s on the card, headlined by the reference's
own frame, with a compiled parity gate in front.  The port of `bench.py`,
with its functions, sizes, keys and gate.

HEADLINE (value / vs_baseline): rays/s on the REFERENCE'S OWN frame: its
scene variant (14x14 grid, no dielectrics, 197 spheres,
`scenes.reference_scene`), 1920x1080, depth 3, spp-amortized at 256 spp.
vs_baseline is over the reference's implied rate at 60 FPS: 2,073,600
rays/frame x 60 = 124.4M rays/s (BASELINE.md).

NAMED FIELDS: the flagship (RTiOW final scene, 486 spheres, 1200x800,
256 spp, depth 8; `flagship_rays_per_s`) and gradient-step throughput
(`grad_*`, paths/s of one d mean(img^2) / d centers step).

Backends (--backend):
  cuda   - K1 (`kernels/render_lanes.py`), cost-balanced; the reference's
           `mxu`.  The default.
  pallas - K2 (`kernels/record.py`), cluster-culled at --cluster-size.
  torch  - the differentiable wavefront (`wavefront/render.py`); the
           reference's `xla`.
There is no `auto`: nothing falls back to another backend or device.

Unless --no-verify, the compiled parity gate runs first, on the device the
bench runs on: 240x160, 8 spp, depth 8 on the RTiOW final scene, the
`pallas` (culled at --cluster-size), `cuda`, K4 (`render_sweep_record`,
the recorder of `grad_flagship_sweep`) and the headline session's
(`Renderer` of --backend, its second frame) images against `torch`, under
`parity.COMPILED` (bench.py's VERIFY_* thresholds).  A failure prints a
`"verify": "fail"` line and exits 1.

Divergences from bench.py: the gate, the gradient legs and the reference
workload run on every device, not only on one platform; nothing is caught
(no fallback backend, no chunked retry of the flagship gradient, no empty
result for a failed leg: a failure is a traceback and a nonzero exit); the
reference workload runs with --backend (`Renderer("cuda")` refuses the CPU,
so a CPU run takes `pallas` or `torch`); `grad_xla_paths_per_s` is
`grad_torch_paths_per_s`; `grad_flagship_sweep_paths_per_s` (the flagship
gradient recorded by K4) and `device` (the card's name and power limit from
nvidia-smi, null on the CPU) are new.

Prints ONE JSON line to stdout; everything else goes to stderr.

Usage:
    python bench_torch.py                  # full run on the card
    python bench_torch.py --quick          # flagship at 16 spp
    python bench_torch.py --backend cuda|pallas|torch
    python bench_torch.py --device cpu ... # the plain PyTorch versions
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time

import numpy as np

REFERENCE_IMPLIED_RAYS_PER_SEC = 2_073_600 * 60.0  # see module docstring

# The gate's config (bench.py's): small enough to be cheap, big enough to
# cover every material and the defocus blur.
VERIFY_W, VERIFY_H, VERIFY_SPP, VERIFY_DEPTH = 240, 160, 8, 8
# Gradient legs: (width, height, spp, depth).  GRAD_SHAPE is the historical
# comparison config, GRAD_FLAGSHIP_SHAPE the flagship frame, recorded
# unchunked.
GRAD_SHAPE = (400, 300, 16, 8)
GRAD_FLAGSHIP_SHAPE = (1200, 800, 256, 8)
GRAD_CLUSTER_SIZE = 12  # the K2-recorded legs' plan
# The reference's own frame: (width, height, depth) and its samples.
REFERENCE_SHAPE = (1920, 1080, 3)
REFERENCE_SPP = 256


# The keys of the line: bench.py's (bench.py:228, 236, 477-493) with
# grad_xla_paths_per_s renamed, plus the K4-recorded flagship gradient and
# the card.  Without the gradient legs no grad_* key is printed.
KEYS = frozenset({
    "metric", "value", "unit", "vs_baseline", "verify",
    "grad_fast_paths_per_s", "grad_torch_paths_per_s", "grad_fast_speedup",
    "grad_flagship_paths_per_s", "grad_flagship_sweep_paths_per_s",
    "flagship_rays_per_s", "flagship_vs_baseline", "device"})


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def pallas_only(backend, cluster_size):
    """A session's cluster size: --cluster-size is the "pallas" session's;
    every other backend's session stays unculled (0), as the bench has
    always measured the "cuda" one."""
    return cluster_size if backend == "pallas" else 0


def make_render_fn(backend, scene, cluster_size):
    """backend name -> render(scene, camera, config, frame)."""
    if backend == "cuda":
        from bevy_raytrace_tpu_torch.kernels.render_lanes import (
            render_mxu_balanced,
        )

        return render_mxu_balanced
    if backend == "pallas":
        from bevy_raytrace_tpu_torch.kernels import (
            cluster_scene,
            render_pallas,
        )

        clusters = None
        if cluster_size:
            clusters = cluster_scene(scene, cluster_size=cluster_size)
            log(f"cluster culling: {clusters.n_clusters} clusters x "
                f"{clusters.cluster_size}")
        return functools.partial(render_pallas, clusters=clusters)
    if backend == "torch":
        from bevy_raytrace_tpu_torch.wavefront.render import render

        return render
    raise ValueError(f"unknown backend {backend!r}")


def run_verify(scene, camera_fn, cluster_size, device, backend):
    """The compiled parity gate on a small config -> "pass" (or exits 1).

    Kernels built for the card round differently from the wavefront (fma
    contraction), so only a compiled-vs-compiled check on the device the
    bench runs on catches a wrong kernel there.  Besides the three render
    functions it holds the headline's own path: the second frame of a
    `Renderer(cfg, backend)` session (the "cuda" backend's cached
    permutation), rendered at frame 0 again."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.kernels.sweep_record import (
        render_sweep_record,
    )
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare
    from bevy_raytrace_tpu_torch.utils.metrics import synchronize
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

    cfg = RenderConfig(width=VERIFY_W, height=VERIFY_H,
                       samples_per_pixel=VERIFY_SPP, max_depth=VERIFY_DEPTH,
                       spp_chunk=VERIFY_SPP)
    camera = camera_fn(cfg.aspect, device=device)
    fns = {b: make_render_fn(b, scene, cluster_size)
           for b in ("torch", "pallas", "cuda")}
    fns["sweep"] = lambda s, c, k, f: render_sweep_record(s, c, k, f)[0]
    session = Renderer(cfg, backend=backend, device=device,
                       cluster_size=pallas_only(backend, cluster_size))

    def session_frame(s, c, k, f):
        session.frame = f
        session.render_frame(s, c)  # the probe frame
        session.frame = f
        return session.render_frame(s, c)

    fns["session"] = session_frame
    images = {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        with torch.no_grad():
            img = synchronize(fn(scene, camera, cfg, 0))
        images[name] = img.cpu().numpy()
        log(f"verify: {name} rendered {VERIFY_W}x{VERIFY_H} "
            f"in {time.perf_counter() - t0:.1f}s (build incl.)")
    for name in ("pallas", "cuda", "sweep", "session"):
        # bench.py's statistics: a pixel's error is its largest channel's.
        s = compare(images[name], images["torch"], COMPILED)
        log(f"verify: {name} vs torch: median={s['median']:.2e} "
            f"frac>{COMPILED.bad_tol}={s['bad_frac']:.4f} "
            f"mean_bias={s['mean_bias']:.2e} -> "
            f"{'ok' if s['ok'] else 'FAIL'}")
        if not s["ok"]:
            log(f"VERIFY FAILED: {name} disagrees with torch")
            print(json.dumps({
                "metric": "verify failure", "value": s["median"],
                "unit": "median_abs_err", "vs_baseline": 0.0,
                "verify": "fail",
            }), flush=True)
            sys.exit(1)
    return "pass"


def run_grad_bench(scene, camera_fn, device):
    """Gradient-step throughput: paths/s of one forward + backward of
    d mean(img^2) / d centers at frame 1.

      grad_fast           K2 (culled by a plan at GRAD_CLUSTER_SIZE) + K3,
                          at GRAD_SHAPE;
      grad_torch          autograd through the wavefront at the same shape;
      grad_flagship       K2 (the same plan) + K3 on the flagship frame,
                          unchunked;
      grad_flagship_sweep K4 + K3 on the flagship frame.

    Each leg takes one warm step, then the best of two timed steps (host
    clock to torch.cuda.synchronize()).  A non-finite gradient raises."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.inverse import make_fast_renderer
    from bevy_raytrace_tpu_torch.kernels import cluster_scene
    from bevy_raytrace_tpu_torch.utils.metrics import synchronize
    from bevy_raytrace_tpu_torch.wavefront.render import render

    def config(width, height, spp, depth):
        return RenderConfig(width=width, height=height,
                            samples_per_pixel=spp, max_depth=depth,
                            spp_chunk=min(4, spp))

    plan = cluster_scene(scene, cluster_size=GRAD_CLUSTER_SIZE)
    cfg = config(*GRAD_SHAPE)
    camera = camera_fn(cfg.aspect, device=device)
    cfg_big = config(*GRAD_FLAGSHIP_SHAPE)
    camera_big = camera_fn(cfg_big.aspect, device=device)
    fast = make_fast_renderer(cfg, backward="kernel", clusters=plan)
    fast_big = make_fast_renderer(cfg_big, backward="kernel", clusters=plan)
    sweep_big = make_fast_renderer(cfg_big, backward="kernel",
                                   forward="sweep")
    legs = [
        ("fast", cfg, lambda sc: fast(sc, camera, 1)),
        ("torch", cfg, lambda sc: render(sc, camera, cfg, 1)),
        ("flagship", cfg_big, lambda sc: fast_big(sc, camera_big, 1)),
        ("flagship_sweep", cfg_big, lambda sc: sweep_big(sc, camera_big, 1)),
    ]

    def step(render_fn):
        centers = scene.centers.clone().requires_grad_(True)
        img = render_fn(dataclasses.replace(scene, centers=centers))
        (grad,) = torch.autograd.grad(torch.mean(img ** 2), centers)
        return synchronize(grad)

    out = {}
    for name, c, render_fn in legs:
        if not bool(torch.isfinite(step(render_fn)).all()):
            raise ValueError(f"grad_{name}: non-finite gradients")
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            step(render_fn)
            times.append(time.perf_counter() - t0)
        pps = c.rays_per_frame / min(times)
        out[f"grad_{name}_paths_per_s"] = pps
        log(f"grad bench ({name}): {min(times):.3f}s/step, {pps:,.0f} "
            f"paths/s fwd+bwd ({c.width}x{c.height}x{c.samples_per_pixel}"
            f"spp depth {c.max_depth})")
    out["grad_fast_speedup"] = (out["grad_fast_paths_per_s"]
                                / out["grad_torch_paths_per_s"])
    return out


def run_reference_workload(backend, device, cluster_size=12):
    """The HEADLINE: rays/s on the reference's own frame (REFERENCE_SHAPE,
    `reference_scene(0)`, `rtiow_final_camera`) through a
    `Renderer(cfg, backend)` session: frame 0 (the "cuda" backend's probe)
    and frame 1 (its cached permutation) untimed, then the best of two
    timed frames, at REFERENCE_SPP samples: per-sample throughput does not
    depend on it, and many samples amortize each frame's fixed cost.  A
    timed frame that is not finite or is black raises.
    Unlike bench.py, which takes it with its default backend only, this
    runs with the bench's backend (`cluster_size`: the "pallas" session's
    culling)."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.scenes import (
        reference_scene,
        rtiow_final_camera,
    )
    from bevy_raytrace_tpu_torch.utils.metrics import synchronize
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

    width, height, depth = REFERENCE_SHAPE
    cfg = RenderConfig(width=width, height=height,
                       samples_per_pixel=REFERENCE_SPP,
                       max_depth=depth)
    scene, _ = reference_scene(seed=0, device=device)
    cam = rtiow_final_camera(cfg.aspect, device=device)
    r = Renderer(cfg, backend=backend, device=device,
                 cluster_size=pallas_only(backend, cluster_size))

    def frame(i):
        r.frame = i
        with torch.no_grad():
            return synchronize(r.render_frame(scene, cam))

    frame(0)
    frame(1)
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        img = frame(i + 2)
        times.append(time.perf_counter() - t0)
        mean_px = float(img.mean())
        if not (np.isfinite(mean_px) and mean_px > 0):
            raise ValueError(f"reference workload frame {i + 2} mean "
                             f"{mean_px}: not a render")
    rps = cfg.rays_per_frame / min(times)
    log(f"reference-equivalent workload ({width}x{height}x"
        f"{cfg.samples_per_pixel}spp depth {depth}, {scene.count} spheres, "
        f"backend={backend}): {min(times):.3f}s/frame -> {rps / 1e6:.1f}M "
        f"rays/s ({rps / REFERENCE_IMPLIED_RAYS_PER_SEC:.2f}x the implied "
        f"bar)")
    return {"reference_workload_rays_per_s": rps,
            "reference_workload_vs_baseline":
                rps / REFERENCE_IMPLIED_RAYS_PER_SEC,
            "reference_workload_spheres": scene.count}


def device_info(device):
    """{"name", "power_limit_w"} of the card from nvidia-smi; None on the
    CPU."""
    if device.type != "cuda":
        return None
    from bevy_raytrace_tpu_torch.device import smi_line

    name, limit = (f.strip() for f in smi_line().rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--quick", action="store_true", help="16 spp variant")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--backend", choices=["cuda", "pallas", "torch"],
                   default="cuda")
    p.add_argument("--ray-chunk", type=int, default=0)
    p.add_argument("--spp-chunk", type=int, default=0)
    p.add_argument("--cluster-size", type=int, default=12,
                   help="cluster-culled traversal (pallas; 0 = brute force)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the compiled cross-backend parity gate")
    p.add_argument("--no-grad", action="store_true",
                   help="skip the gradient-step throughput measurement")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of one timed frame "
                        "to DIR/trace.json (open with Perfetto)")
    p.add_argument("--device", default=None,
                   help="where to run: the CUDA device by default; 'cpu' "
                        "runs the plain PyTorch versions on the CPU")
    args = p.parse_args(argv)
    if args.quick:
        args.spp = 16

    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.scenes import (
        rtiow_final_camera,
        rtiow_final_scene,
    )
    from bevy_raytrace_tpu_torch.utils.metrics import (
        synchronize,
        trace_profile,
    )
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

    device = resolve(args.device)
    if args.backend == "cuda" and device.type != "cuda":
        p.error(f"--backend cuda runs on the card, not on {device}")
    # The wavefront is the gate's oracle: its matmuls stay float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    info = device_info(device)
    log(f"device: {device}" + (f" ({info['name']}, "
                               f"{info['power_limit_w']} W)" if info else ""))

    num_pixels = args.width * args.height
    spp_chunk = args.spp_chunk or min(args.spp, 4)
    ray_chunk = args.ray_chunk
    if ray_chunk == 0:
        # Bound the torch backend's [rays, spheres] workspace: the largest
        # divisor of the pixel count up to ~120,000 rays.
        target = 120_000 // spp_chunk * spp_chunk
        ray_chunk = num_pixels
        for cand in range(target, 0, -1):
            if num_pixels % cand == 0:
                ray_chunk = cand
                break

    config = RenderConfig(width=args.width, height=args.height,
                          samples_per_pixel=args.spp, max_depth=args.depth,
                          spp_chunk=spp_chunk, ray_chunk=ray_chunk)
    scene, _ = rtiow_final_scene(seed=0, device=device)
    camera = rtiow_final_camera(config.aspect, device=device)
    log(f"config: {args.width}x{args.height} x {args.spp}spp depth "
        f"{args.depth}, {scene.count} spheres, ray_chunk={ray_chunk}, "
        f"spp_chunk={spp_chunk}, backend={args.backend}")

    verify = "skipped"
    if not args.no_verify:
        verify = run_verify(scene, rtiow_final_camera, args.cluster_size,
                            device, args.backend)
    fields = {}
    if not args.no_grad:
        fields = run_grad_bench(scene, rtiow_final_camera, device)
    ref = run_reference_workload(args.backend, device,
                                 cluster_size=args.cluster_size)

    if args.backend == "cuda":
        # The steady-state session: the Renderer probes the cost map on
        # frame 0 and renders later frames on the cached permutation.
        renderer = Renderer(config, backend="cuda", device=device)

        def step(scene, camera, config, frame):
            renderer.frame = frame
            return renderer.render_frame(scene, camera)
    else:
        step = make_render_fn(args.backend, scene, args.cluster_size)

    def run_frame(i):
        t0 = time.perf_counter()
        with torch.no_grad():
            img = synchronize(step(scene, camera, config, i))
        return img, time.perf_counter() - t0

    img, first = run_frame(0)
    log(f"build + first frame: {first:.1f}s")
    if args.backend == "cuda":
        _, dt = run_frame(1)
        log(f"warm cached-perm frame: {dt:.3f}s (untimed)")
    times = []
    for i in range(args.repeats):
        img, dt = run_frame(i + 2)
        times.append(dt)
        log(f"frame {i + 2}: {dt:.3f}s")
    if args.trace:
        with trace_profile(args.trace):
            run_frame(args.repeats + 5)
        log(f"frame trace captured to {args.trace}/trace.json")

    frame_time = min(times)
    rays_per_sec = config.rays_per_frame / frame_time
    mean_px = float(img.mean())
    log(f"flagship paths/frame={config.rays_per_frame:,} "
        f"frame_time={frame_time:.3f}s rays/s={rays_per_sec:,.0f} "
        f"mean_pixel={mean_px:.4f}")
    if not (np.isfinite(mean_px) and mean_px > 0):
        raise ValueError(f"flagship image mean {mean_px}: not a render")

    rw, rh, rd = REFERENCE_SHAPE
    metric = (f"camera rays (paths)/sec/chip on the reference's own frame "
              f"({rw}x{rh}, depth {rd}, {ref['reference_workload_spheres']}"
              f"-sphere reference scene variant, spp-amortized), "
              f"backend={args.backend}; flagship_* = RTiOW final "
              f"{args.width}x{args.height}x{args.spp}spp depth {args.depth}")
    print(json.dumps({
        "metric": metric,
        "value": ref["reference_workload_rays_per_s"],
        "unit": "rays/s",
        "vs_baseline": ref["reference_workload_vs_baseline"],
        "verify": verify,
        **fields,
        "flagship_rays_per_s": rays_per_sec,
        "flagship_vs_baseline": rays_per_sec / REFERENCE_IMPLIED_RAYS_PER_SEC,
        "device": info,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
