"""Time the rate probes V1-V3: the dense sweep's arithmetic on its own.

    python -m bevy_raytrace_tpu_torch.tools.fp32_probe [--device cpu]
        [--spheres S --rays R --iters N] [--seed K]

Counterpart of `tools/vpu_probe.py`'s `run` and main.  Every row launches
one kernel of `kernels/fp32_probe.py` (a warm-up, then the best of 3, CUDA
events) and prints its milliseconds, its TFLOP/s (operations counted from
the CUDA source, a fused multiply-add as two: `kernels.fp32_probe.OPS`),
that rate's share of the card's published peak outside the tensor cores
(float32 67 TFLOP/s, bfloat16 133.8 TFLOP/s, H100 SXM), and 10^9 ray-sphere
tests (V2: elements) per second.

With no shape given it runs two:

  * the reference's shape, (S, R) = (256, 1024), 4000 rounds, on the
    reference's inputs (g = rand + 1, r = rand, seeded): 8 blocks of 128
    threads, so it fills 8 of the card's 132 SMs.  This is the shape the
    kernels are held against their plain versions and the TPU tool at; its
    rates say little about the card;
  * a card-filling shape, R = 132 x 2048 = 270,336 rays (every SM's 2,048
    thread slots), 400 rounds: every kernel and V3 variant at S = 256 on the
    reference's inputs, and V3 "prod" and "k1" on two scenes' own sphere
    tables and camera rays, reference_scene (197 spheres, 1920x1080) and
    rtiow_final (486 spheres, 1200x800), with the rays three ways: in raster
    order (a warp's rays are neighbours, as K1's primary rays), one ray for
    all 32 lanes of a warp (no divergence at all), and shuffled (as after a
    few bounces); "smem" in raster order.  These are the rates.
It also times V1 and V3 at twice the rounds: a ratio near 2 shows that the
compiler neither hoisted nor dropped the inner loop.  Every row carries a
SHA-256 of its outputs (`sha256`): "prod", "smem" and "k1" must agree on
each input, bit for bit.

On the CPU (`--device cpu`) the plain versions run and only host
milliseconds are printed: a rate of the card is measured on the card.
`ROWS` holds the rows of the last run for a caller in this process.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np

PEAK = {"float32": 67e12, "bfloat16": 133.8e12}
REFERENCE_SHAPE = (256, 1024, 4000)
CARD_RAYS, CARD_ITERS = 132 * 2048, 400
SCENES = {"reference_scene": (1920, 1080), "rtiow_final": (1200, 800)}
WARP = 32

ROWS: list = []


def reference_inputs(spheres: int, rays: int, seed: int = 0):
    """The reference tool's operands: g = rand(S, 8) + 1, r = rand(8, R)."""
    rs = np.random.RandomState(seed)
    return ((rs.rand(spheres, 8) + 1.0).astype(np.float32),
            rs.rand(8, rays).astype(np.float32))


def scene_inputs(name: str, rays: int, device, seed: int = 0):
    """A scene's own operands -> (g [S, 8], r [8, rays]) on `device`: K1's
    geometry table, and the camera rays (sample `seed` of frame 0) of `rays`
    consecutive pixels from the middle of the scene's frame."""
    import torch

    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.kernels.common import _plain_camera
    from bevy_raytrace_tpu_torch.kernels.render_lanes import _scene_tables

    width, height = SCENES[name]
    build = {"reference_scene": scenes.reference_scene,
             "rtiow_final": scenes.rtiow_final_scene}[name]
    scene = build(0, device=device)[0]
    cam = scenes.rtiow_final_camera(width / height, device=device)
    geom, _ = _scene_tables(scene)
    g = torch.zeros((geom.shape[0], 8), dtype=torch.float32, device=device)
    g[:, :4] = geom
    first = max(0, (width * height - rays) // 2 // width * width)
    pid = (first + torch.arange(rays, dtype=torch.int64, device=device)) % (
        width * height)
    r = torch.zeros((8, rays), dtype=torch.float32, device=device)
    r[:6] = torch.stack(_plain_camera(cam.pack(), pid, seed, 0, width,
                                      height))
    return g, r


def warp_uniform(r):
    """Every lane of a warp gets its warp's first ray."""
    import torch

    lead = torch.arange(r.shape[1], device=r.device) // WARP * WARP
    return r[:, lead].contiguous()


def shuffled(r, seed: int):
    import torch

    perm = torch.from_numpy(np.random.RandomState(seed).permutation(
        r.shape[1])).to(r.device)
    return r[:, perm].contiguous()


def _time_ms(fn, device):
    """Best of 3 after a warm-up -> (ms, the last result): CUDA events on
    the card, the host clock on the CPU."""
    import torch

    out = fn()
    times = []
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times), out


def measure(name, kind, fn, device, spheres, rays, iters, dtype="float32",
            rays_as="reference"):
    """One row: `fn()` timed, with its rate where it ran on the card."""
    from bevy_raytrace_tpu_torch.kernels.fp32_probe import OPS

    ms, out = _time_ms(fn, device)
    tests = spheres * rays * iters
    sha = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        sha.update(t.cpu().numpy().tobytes())
    row = {"name": name, "kind": kind, "dtype": dtype, "spheres": spheres,
           "rays": rays, "iters": iters, "rays_as": rays_as, "ms": ms,
           "device": str(device), "sha256": sha.hexdigest()[:16]}
    line = (f"{name:14s} S={spheres:<4d} R={rays:<7d} x{iters:<5d} "
            f"{rays_as:22s} {ms:9.3f} ms  sha256 {row['sha256']}")
    if device.type == "cuda":
        flops = tests * OPS[kind] / (ms * 1e-3)
        row.update(tflops=flops / 1e12, share_of_peak=flops / PEAK[dtype],
                   gtests_per_s=tests / (ms * 1e-3) / 1e9)
        line += (f"  {row['tflops']:7.3f} TFLOP/s  "
                 f"{row['share_of_peak']:7.2%} of {PEAK[dtype] / 1e12:g}  "
                 f"{row['gtests_per_s']:8.2f} Gtests/s")
    else:
        line += "  (plain version on the CPU: no rate of the card)"
    print(line, flush=True)
    ROWS.append(row)
    return row


def run_shape(device, g, r, iters, label, variants, twice=False):
    """Every kernel (V1, V2 in both types, V3 in `variants`) on (g, r)."""
    import torch

    from bevy_raytrace_tpu_torch.kernels import fp32_probe as vp

    s, n = g.shape[0], r.shape[1]
    g16, r16 = g.to(torch.bfloat16), r.to(torch.bfloat16)
    rows = [
        measure("v1 sweep", "v1", lambda: vp.v1_sweep(g, r, iters), device,
                s, n, iters, rays_as=label),
        measure("v2 fma f32", "v2", lambda: vp.v2_fma(g, r, iters), device,
                s, n, iters, rays_as=label),
        measure("v2 fma bf16", "v2", lambda: vp.v2_fma(g16, r16, iters),
                device, s, n, iters, dtype="bfloat16", rays_as=label)]
    for variant in variants:
        rows.append(measure(
            f"v3 {variant}", "v3",
            lambda variant=variant: vp.v3_sweep(g, r, iters, variant),
            device, s, n, iters, rays_as=label))
    if twice:
        for name, kind, fn in (
                ("v1 sweep", "v1", lambda: vp.v1_sweep(g, r, 2 * iters)),
                ("v3 prod", "v3", lambda: vp.v3_sweep(g, r, 2 * iters))):
            once = next(x for x in rows if x["name"] == name)
            row = measure(name, kind, fn, device, s, n, 2 * iters,
                          rays_as=label)
            ratio = row["ms"] / once["ms"]
            print(f"{name:14s} twice the rounds take {ratio:.3f}x the time",
                  flush=True)
            if device.type == "cuda" and not 1.7 <= ratio <= 2.3:
                raise RuntimeError(
                    f"{name}: 2 x {iters} rounds take {ratio:.3f}x the time "
                    f"of {iters}: the inner loop was hoisted or dropped, or "
                    f"the run is too short to time")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where to run: the CUDA device by default; 'cpu' "
                         "runs the plain PyTorch versions on the CPU")
    ap.add_argument("--spheres", type=int, default=None)
    ap.add_argument("--rays", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.kernels import fp32_probe as vp

    device = resolve(args.device)
    del ROWS[:]

    def on_device(spheres, rays):
        return tuple(torch.from_numpy(v).to(device)
                     for v in reference_inputs(spheres, rays, args.seed))

    custom = (args.spheres, args.rays, args.iters)
    if any(v is not None for v in custom):
        if any(v is None for v in custom):
            ap.error("--spheres, --rays and --iters go together")
        print(f"probe: (S,R)=({args.spheres},{args.rays}) x {args.iters} "
              f"rounds on {device}", flush=True)
        run_shape(device, *on_device(args.spheres, args.rays), args.iters,
                  "reference", vp.VARIANTS)
        return 0

    s, n, iters = REFERENCE_SHAPE
    print(f"probe: the reference's shape (S,R)=({s},{n}) x {iters} rounds "
          f"on {device}", flush=True)
    run_shape(device, *on_device(s, n), iters, "reference", vp.VARIANTS)

    print(f"probe: the card-filling shape R={CARD_RAYS} x {CARD_ITERS} "
          f"rounds on {device}", flush=True)
    g, r = on_device(s, CARD_RAYS)
    run_shape(device, g, r, CARD_ITERS, "reference", vp.VARIANTS, twice=True)
    r_uniform = warp_uniform(r)
    for variant in ("prod", "k1"):
        measure(f"v3 {variant}", "v3",
                lambda variant=variant: vp.v3_sweep(g, r_uniform, CARD_ITERS,
                                                    variant),
                device, s, CARD_RAYS, CARD_ITERS, rays_as="warp-uniform")
    for scene in SCENES:
        g, r = scene_inputs(scene, CARD_RAYS, device, args.seed)
        for label, rays in (("raster", r), ("warp-uniform", warp_uniform(r)),
                            ("shuffled", shuffled(r, args.seed))):
            variants = ("prod", "k1") + (("smem",) if label == "raster"
                                         else ())
            for variant in variants:
                measure(f"v3 {variant}", "v3",
                        lambda rays=rays, variant=variant: vp.v3_sweep(
                            g, rays, CARD_ITERS, variant),
                        device, g.shape[0], CARD_RAYS, CARD_ITERS,
                        rays_as=f"{scene.split('_')[0]} {label}")
    over = [x for x in ROWS if x.get("share_of_peak", 0.0) > 1.0]
    if over:
        raise RuntimeError(f"a rate above the card's peak: the operation "
                           f"count is wrong: {over}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
