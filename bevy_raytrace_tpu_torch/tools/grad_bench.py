"""Time one gradient step (forward + backward) of the renderers.

    python -m bevy_raytrace_tpu_torch.tools.grad_bench [W] [H] [spp] [depth]
        [paths] [--forward pallas|sweep] [--device cpu]

Counterpart of `tools/grad_bench.py`: the same positional arguments and
defaults (400 300 16 8) on `rtiow_final_scene(0)`; `paths` is a comma list
of

  kernel     `make_fast_renderer(cfg, backward="kernel")`: the recording
             forward (K2, or K4 with --forward sweep) and K3's replay;
  torch      `make_fast_renderer(cfg, backward="torch")`: the same forward,
             the replay in PyTorch under autograd (the reference's `xla`);
  wavefront  autograd through the wavefront `render`

(default: kernel,torch).  A step is d mean(img^2) / d centers at frame 1.
Each path runs a first step (which builds the kernels it needs and warms the
allocator), then three more; the line gives the first step's seconds, the
best of the three and its paths per second, host clock to
`torch.cuda.synchronize()`.  A non-finite gradient is reported and makes the
exit code 1.  `STEPS` holds the rows of the last run for a caller in this
process.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

PATHS = ("kernel", "torch", "wavefront")
STEPS: list = []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("width", type=int, nargs="?", default=400)
    ap.add_argument("height", type=int, nargs="?", default=300)
    ap.add_argument("spp", type=int, nargs="?", default=16)
    ap.add_argument("depth", type=int, nargs="?", default=8)
    ap.add_argument("paths", nargs="?", default="kernel,torch",
                    help="comma list of " + ", ".join(PATHS))
    ap.add_argument("--forward", choices=("pallas", "sweep"),
                    default="pallas",
                    help="the fast paths' recorder: K2 (pallas) or K4 (sweep)")
    ap.add_argument("--device", default=None,
                    help="where to run: the CUDA device by default; 'cpu' "
                         "runs the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    unknown = [p for p in paths if p not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}; choose from {PATHS}")

    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.inverse import make_fast_renderer
    from bevy_raytrace_tpu_torch.scenes import (
        rtiow_final_camera,
        rtiow_final_scene,
    )
    from bevy_raytrace_tpu_torch.wavefront.render import render

    device = resolve(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth,
                       spp_chunk=min(4, args.spp))
    scene, _ = rtiow_final_scene(seed=0, device=device)
    camera = rtiow_final_camera(cfg.aspect, device=device)

    def step(render_fn):
        """One forward + backward -> the gradient, finished."""
        centers = scene.centers.clone().requires_grad_(True)
        img = render_fn(dataclasses.replace(scene, centers=centers))
        (grad,) = torch.autograd.grad(torch.mean(img ** 2), centers)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return grad

    del STEPS[:]
    bad = 0
    for path in paths:
        if path == "wavefront":
            def render_fn(sc):
                return render(sc, camera, cfg, 1)
        else:
            fast = make_fast_renderer(cfg, backward=path,
                                      forward=args.forward)

            def render_fn(sc, fast=fast):
                return fast(sc, camera, 1)
        name = path if path == "wavefront" else f"{path}/{args.forward}"
        t0 = time.perf_counter()
        grad = step(render_fn)
        first_s = time.perf_counter() - t0
        if not bool(torch.isfinite(grad).all()):
            print(f"{name:14s} NON-FINITE GRADS", flush=True)
            bad += 1
            continue
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(render_fn)
            times.append(time.perf_counter() - t0)
        best = min(times)
        STEPS.append({"path": path, "forward": args.forward,
                      "first_s": first_s, "step_s": best,
                      "paths_per_s": cfg.rays_per_frame / best,
                      "device": str(device)})
        print(f"{name:14s} first={first_s:6.2f}s step={best:.4f}s "
              f"paths/s={cfg.rays_per_frame / best / 1e6:7.2f}M on {device}",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
