"""Command-line entry points: render one frame, an orbit sequence, a live
HTTP viewer, and the inverse-rendering demo.

Mirror of `bevy_raytrace_tpu/cli.py`, with the same subcommands, flags and
defaults, on the port's backends:

    --backend cuda    (the default) the K1 kernel through the `Renderer`
                      session with cost-balanced scheduling: the
                      reference's `mxu`; dense unless `--cluster-size` is
                      given, then K1's chunk-culled traversal (the same
                      image);
    --backend pallas  the K2 kernel with the cluster-culled traversal
                      (`--cluster-size`, 12 unless given, 0 = brute
                      force);
    --backend torch   the differentiable wavefront: the reference's `xla`.

Every command runs on the CUDA device and raises where there is none;
`--device cpu` is the only way onto the CPU, where `torch` runs the
wavefront, `pallas` K2's plain twin, and `cuda` is refused.

Usage:
    python -m bevy_raytrace_tpu_torch.cli render  --scene rtiow -o out.png
    python -m bevy_raytrace_tpu_torch.cli render  --scene reference \
        --width 1920 --height 1080 --spp 1 --depth 3 -o frame.png
    python -m bevy_raytrace_tpu_torch.cli render  --scene sphereflake \
        --width 512 --height 512 --spp 256 --cluster-size 12 -o flake.png
    python -m bevy_raytrace_tpu_torch.cli animate --frames 24 -o frames/
    python -m bevy_raytrace_tpu_torch.cli serve   --spp 4    # live viewer
    python -m bevy_raytrace_tpu_torch.cli inverse --steps 200 -o recovered.png

Deliberate divergences from the reference's CLI: `--device` is new;
`--backend` defaults to `cuda` (an entry point of the port runs on the
card unless asked otherwise); `--interpret` does not exist (there is no
interpreter mode: the CPU runs the kernels' plain twins); `--cluster-size`
takes any integer >= 0 (the Hopper kernel has no unroll to divide); the
time of the first-use nvcc build is reported apart from the frame's;
`serve` renders under a lock; `--sharded` is one process per device: a
lone process opens a `torch.distributed` group of world size 1 (nccl on
CUDA, gloo with `--device cpu`), under `torchrun` rank and world size come
from the environment, and only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def _cluster_size(v):
    v = int(v)
    if v < 0:
        raise argparse.ArgumentTypeError(
            f"--cluster-size must be >= 0 (0 = brute force); got {v}")
    return v


def _add_render_args(p):
    p.add_argument("--scene", default="rtiow",
                   choices=["config1", "config2", "rtiow", "reference",
                            "sphereflake"])
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--spp-chunk", type=int, default=0)
    p.add_argument("--ray-chunk", type=int, default=0)
    p.add_argument("--lookfrom", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--vfov", type=float, default=None)
    p.add_argument("--aperture", type=float, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over the processes of the "
                        "torch.distributed group (one per device)")
    p.add_argument("--backend", choices=["torch", "pallas", "cuda"],
                   default="cuda",
                   help="compute path (cuda = the K1 kernel, fastest; "
                        "pallas = the K2 kernel; torch = the wavefront)")
    p.add_argument("--cluster-size", type=_cluster_size, default=None,
                   help="cluster-culled traversal granularity: pallas "
                        "backend 12 unless given, cuda backend culls only "
                        "when given; 0 = brute force")
    p.add_argument("--device", default=None,
                   help="where to run: the CUDA device by default; 'cpu' "
                        "runs the plain PyTorch paths on the CPU")
    p.add_argument("-o", "--output", default="render.png")


def _device(args):
    from bevy_raytrace_tpu_torch.device import resolve

    return resolve(args.device)


def _build(args, device):
    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch import scenes

    spp_chunk = args.spp_chunk or (1 if args.spp == 1 else
                                   min(4, args.spp))
    while args.spp % spp_chunk:
        spp_chunk -= 1
    config = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_depth=args.depth, seed=args.seed, spp_chunk=spp_chunk,
        ray_chunk=args.ray_chunk,
    )
    makers = {
        "config1": (scenes.baseline_config1_scene,
                    scenes.baseline_config1_camera),
        "config2": (scenes.baseline_config2_scene,
                    scenes.baseline_config2_camera),
        "rtiow": (lambda device: scenes.rtiow_final_scene(
            args.seed, device=device), scenes.rtiow_final_camera),
        "reference": (lambda device: scenes.reference_scene(
            args.seed, device=device), scenes.rtiow_final_camera),
        "sphereflake": (scenes.sphereflake_scene,
                        scenes.sphereflake_camera),
    }
    scene_fn, cam_fn = makers[args.scene]
    scene, registry = scene_fn(device=device)
    camera = cam_fn(config.aspect, device=device)
    if any(v is not None for v in (args.lookfrom, args.lookat, args.vfov,
                                   args.aperture)):
        from bevy_raytrace_tpu_torch.core.camera import Camera

        camera = Camera.look_at(
            lookfrom=args.lookfrom or (13.0, 2.0, 3.0),
            lookat=args.lookat or (0.0, 0.0, 0.0),
            vfov_deg=args.vfov if args.vfov is not None else 20.0,
            aspect=config.aspect,
            aperture=args.aperture if args.aperture is not None else 0.0,
            device=device,
        )
    return config, scene, camera, registry


@contextlib.contextmanager
def _mesh(args, device):
    """The `--sharded` mesh, or None without the flag.  A process that has
    no `torch.distributed` group opens one: from RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT when a launcher set them, else a world of
    one on a free local port; a group opened here is destroyed on exit."""
    if not args.sharded:
        yield None
        return
    import torch.distributed as dist

    from bevy_raytrace_tpu_torch.shard import initialize_multihost, make_mesh

    opened = not dist.is_initialized()
    if opened:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            address = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        elif world == 1:
            import socket

            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                address = f"127.0.0.1:{sock.getsockname()[1]}"
        else:
            raise SystemExit("--sharded with WORLD_SIZE > 1 needs "
                             "MASTER_ADDR and MASTER_PORT")
        initialize_multihost(address, world, rank, device=device)
    try:
        mesh = make_mesh(device=device if device.type == "cpu" else None)
        print(f"mesh: {mesh.hosts}x{mesh.chips} (hosts x chips), rank "
              f"{mesh.rank} of {mesh.world_size}, device {mesh.device}",
              file=sys.stderr)
        yield mesh
    finally:
        if opened:
            dist.destroy_process_group()


def _build_kernels(names, device) -> float:
    """Build (first use only) the CUDA libraries `names`; the seconds it
    took, 0.0 on the CPU.  Done before any frame is timed, so that a frame
    time is a frame time."""
    if device.type != "cuda" or not names:
        return 0.0
    from bevy_raytrace_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_all(names)
    return time.perf_counter() - t0


def _make_step(config, args, device, mesh):
    """(step(scene, camera, frame) -> image [H, W, 3] on `device`, seconds
    spent building its CUDA kernel)."""
    import torch

    backend = args.backend
    if backend == "cuda" and device.type != "cuda":
        raise SystemExit(
            f"--backend cuda needs a CUDA device, got --device {device}; "
            f"on the CPU use --backend torch or pallas")
    build_s = _build_kernels({"cuda": ["k1_render"], "pallas": ["k2_record"],
                              "torch": []}[backend], device)
    if mesh is not None:
        from bevy_raytrace_tpu_torch.shard import (
            render_mxu_sharded,
            render_sharded,
        )

        if backend == "pallas":
            # The K2 forward has no sharded render; reject instead of
            # quietly rendering through another path.
            raise SystemExit(
                "--sharded supports --backend torch or cuda (the pallas "
                "backend has no sharded render)")
        if backend == "cuda":
            def step(scene, camera, frame):
                return render_mxu_sharded(scene, camera, config, mesh, frame,
                                          gather=True)
        else:
            def step(scene, camera, frame):
                with torch.no_grad():
                    return render_sharded(scene, camera, config, mesh, frame,
                                          gather=True)
        return step, build_s
    if backend in ("cuda", "pallas"):
        # The Renderer session.  cuda: frame 0 probes the cost map once,
        # later frames reuse the cached permutation (re-probed every
        # --replan-interval frames).  pallas, and cuda given
        # --cluster-size: the session plans the clusters from the first
        # scene it is given (scenes of at least
        # `engine.MIN_CLUSTERED_SPHERES` spheres; a smaller one runs the
        # unculled loop, which gives the same image) and keeps the plan.
        from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

        renderer = Renderer(
            config, backend=backend, device=device,
            replan_interval=getattr(args, "replan_interval", 0),
            cluster_size=args.cluster_size)

        def step(scene, camera, frame):
            renderer.frame = frame
            return renderer.render_frame(scene, camera)

        return step, build_s
    from bevy_raytrace_tpu_torch.wavefront.render import render

    def step(scene, camera, frame):
        with torch.no_grad():
            return render(scene, camera, config, frame)

    return step, build_s


def _tonemap_u8(img):
    """Gamma-2 tone-map on the image's device -> uint8: 3 bytes per pixel
    cross to the host instead of 12 (PNG and PPM quantize to 8 bits
    anyway)."""
    import torch

    return (torch.sqrt(torch.clamp(img, 0.0, 1.0)) * 255.0 + 0.5).to(
        torch.uint8)


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _built(build_s: float) -> str:
    return (f" (after {build_s:.2f}s building the CUDA kernel)"
            if build_s > 0.05 else "")


def cmd_render(args):
    from bevy_raytrace_tpu_torch.io import write_image

    device = _device(args)
    with _mesh(args, device) as mesh:
        config, scene, camera, _ = _build(args, device)
        step, build_s = _make_step(config, args, device, mesh)
        # EXR keeps the linear floats; PNG/PPM are tone-mapped on the device.
        to_u8 = os.path.splitext(args.output)[1].lower() != ".exr"
        _sync(device)
        t0 = time.perf_counter()
        out = step(scene, camera, args.frame)
        if to_u8:
            out = _tonemap_u8(out)
        img = out.cpu().numpy()  # waits for the frame
        dt = time.perf_counter() - t0
        rays = config.rays_per_frame
        print(
            f"rendered {config.width}x{config.height} x "
            f"{config.samples_per_pixel}spp in {dt:.3f}s{_built(build_s)} — "
            f"{rays / dt:,.0f} rays/s",
            file=sys.stderr,
        )
        if mesh is None or mesh.rank == 0:
            write_image(args.output, img)
    print(args.output)


def cmd_animate(args):
    """Render an orbiting-camera sequence: the camera changes every frame
    and goes through the same step (and, on the cuda backend, the same
    `Renderer` session)."""
    from bevy_raytrace_tpu_torch.core.camera import Camera
    from bevy_raytrace_tpu_torch.io import FrameWriter

    device = _device(args)

    def orbit_cam(i, config):
        ang = 2.0 * np.pi * i / args.frames
        return Camera.look_at(
            lookfrom=(13.0 * np.cos(ang), 2.0, 13.0 * np.sin(ang)),
            lookat=(0.0, 0.0, 0.0),
            vfov_deg=20.0,
            aspect=config.aspect,
            aperture=0.1,
            focus_dist=10.0,
            device=device,
        )

    with _mesh(args, device) as mesh:
        config, scene, _, _ = _build(args, device)
        step, build_s = _make_step(config, args, device, mesh)
        writes = mesh is None or mesh.rank == 0
        if writes:
            os.makedirs(args.output, exist_ok=True)
        t_first = t_rest = 0.0
        # Each frame is tone-mapped on the device and copied to the host
        # synchronously (the copy has landed when `.cpu()` returns, so the
        # writer never encodes a frame that is still in flight); the
        # writer's worker pool then encodes and writes frame i while the
        # device renders frame i + 1.
        with FrameWriter() as fw:
            _sync(device)
            t0 = time.perf_counter()
            for i in range(args.frames):
                u8 = _tonemap_u8(step(scene, orbit_cam(i, config), i)).cpu()
                if i == 0:
                    t_first = time.perf_counter() - t0
                    t0 = time.perf_counter()
                if writes:
                    fw.submit(os.path.join(args.output, f"frame_{i:04d}.png"),
                              u8)
            t_rest = time.perf_counter() - t0
    if args.frames > 1:
        print(
            f"first frame {t_first:.3f}s{_built(build_s)}, then "
            f"{t_rest / (args.frames - 1):.3f}s/frame "
            f"({(args.frames - 1) * config.rays_per_frame / t_rest:,.0f} "
            f"rays/s)",
            file=sys.stderr,
        )
    print(args.output)


_SERVE_PAGE = """<!DOCTYPE html>
<html><head><title>bevy_raytrace_tpu_torch</title><style>
body {{ background: #111; color: #ccc; font: 13px monospace; margin: 0; }}
#v {{ display: block; margin: 8px auto; image-rendering: pixelated; }}
#hud {{ text-align: center; }}
</style></head><body>
<img id="v" width="{w2}" height="{h2}">
<div id="hud">WASD / arrows: orbit+dolly &nbsp; QE: pitch &nbsp;
Esc: quit server</div>
<script>
let yaw = {yaw}, pitch = {pitch}, dist = {dist}, busy = false, dirty = true;
async function refresh() {{
  if (busy) {{ dirty = true; return; }}
  busy = true; dirty = false;
  const r = await fetch(`/frame.png?yaw=${{yaw}}&pitch=${{pitch}}&dist=${{dist}}`);
  const b = await r.blob();
  document.getElementById('v').src = URL.createObjectURL(b);
  busy = false;
  if (dirty) refresh();
}}
document.addEventListener('keydown', (e) => {{
  const s = 0.15;
  if (e.key === 'a' || e.key === 'ArrowLeft') yaw -= s;
  else if (e.key === 'd' || e.key === 'ArrowRight') yaw += s;
  else if (e.key === 'w' || e.key === 'ArrowUp') dist = Math.max(2, dist - 1);
  else if (e.key === 's' || e.key === 'ArrowDown') dist += 1;
  else if (e.key === 'q') pitch = Math.min(1.3, pitch + s);
  else if (e.key === 'e') pitch = Math.max(-1.3, pitch - s);
  else if (e.key === 'Escape') {{ fetch('/quit', {{method: 'POST'}}); return; }}
  else return;
  refresh();
}});
refresh();
</script></body></html>"""


def cmd_serve(args):
    """Live interactive viewer over HTTP: the browser page shows the frame,
    WASD/arrow keys fly the camera by re-rendering through the SAME step
    with a new camera, and Escape shuts the session down.

    Endpoints: GET / (viewer page), GET /frame.png?yaw=&pitch=&dist= (one
    rendered frame), POST /quit.  All requests share one session step (on
    the cuda backend one `Renderer`, whose cost-map permutation is reused
    across frames as in `animate`); the render and the frame counter are
    under a lock, so concurrent requests cannot interleave inside the
    session."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    from bevy_raytrace_tpu_torch.core.camera import Camera
    from bevy_raytrace_tpu_torch.io import png_bytes

    device = _device(args)
    with _mesh(args, device) as mesh:
        config, scene, _, _ = _build(args, device)
        step, build_s = _make_step(config, args, device, mesh)
        if build_s > 0.05:
            print(f"serve: built the CUDA kernel in {build_s:.2f}s",
                  file=sys.stderr)
        lock = threading.Lock()
        state = {"frame": int(args.frame)}

        def render_frame(yaw, pitch, dist):
            cam = Camera.look_at(
                lookfrom=(dist * np.cos(pitch) * np.cos(yaw),
                          dist * np.sin(pitch) + 2.0,
                          dist * np.cos(pitch) * np.sin(yaw)),
                lookat=(0.0, 0.0, 0.0), vfov_deg=20.0, aspect=config.aspect,
                aperture=args.aperture if args.aperture is not None else 0.0,
                focus_dist=dist, device=device,
            )
            with lock:
                t0 = time.perf_counter()
                frame = state["frame"]
                u8 = _tonemap_u8(step(scene, cam, frame)).cpu().numpy()
                state["frame"] = frame + 1
                t1 = time.perf_counter()
            body = png_bytes(u8)
            print(f"serve: frame {frame} rendered in {(t1 - t0) * 1e3:.1f} "
                  f"ms, encoded in {(time.perf_counter() - t1) * 1e3:.1f} ms",
                  file=sys.stderr)
            return body

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):  # quiet
                print(f"serve: {fmt % a}", file=sys.stderr)

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    page = _SERVE_PAGE.format(
                        w2=config.width * 2, h2=config.height * 2,
                        yaw=0.23, pitch=0.15, dist=13.0)
                    self._send(200, "text/html", page.encode())
                elif u.path == "/frame.png":
                    q = parse_qs(u.query)

                    def f(name, default):
                        try:
                            return float(q[name][0])
                        except (KeyError, ValueError, IndexError):
                            return default

                    body = render_frame(f("yaw", 0.23), f("pitch", 0.15),
                                        max(f("dist", 13.0), 1.0))
                    self._send(200, "image/png", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/quit":
                    self._send(200, "text/plain", b"bye")
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                else:
                    self._send(404, "text/plain", b"not found")

        server = HTTPServer((args.host, args.port), Handler)
        try:
            print(f"serving on http://{args.host}:{server.server_address[1]}/"
                  f" (Esc in the page, or POST /quit, to stop)",
                  file=sys.stderr)
            # The port, alone on a line of stdout: callers read it.
            print(f"{server.server_address[1]}", flush=True)
            server.serve_forever()
        finally:
            server.server_close()


def cmd_inverse(args):
    """The inverse-rendering demo: perturb the config1 scene (the ball's
    center and albedo, inverse/recovery.py), recover it by gradient descent
    on the image."""
    import torch

    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        make_fast_renderer_sharded,
        optimize,
    )
    from bevy_raytrace_tpu_torch.inverse.recovery import (
        ball_errors,
        perturbed_problem,
    )
    from bevy_raytrace_tpu_torch.io import write_image
    from bevy_raytrace_tpu_torch.wavefront.render import render

    args.scene = "config1"
    device = _device(args)
    backend = args.backend
    with _mesh(args, device) as mesh:
        config, _, camera, _ = _build(args, device)

        # --backend torch: differentiate the wavefront (the sphere sweep is
        # paid in both directions).  --backend pallas/cuda: the fast path:
        # K2 records each bounce's winner, K3 replays them backward with no
        # sphere sweep (inverse/fast_grad.py; both take the default
        # recorder).  --sharded composes with both: each rank renders its
        # pixel stripe, cotangents are summed in one all-reduce.
        build_s = 0.0
        if backend != "torch":
            build_s = _build_kernels(["k2_record", "k3_replay_grad"], device)

        def renderer(opt_config):
            if backend == "torch":
                if mesh is None:
                    return None
                from bevy_raytrace_tpu_torch.shard import render_sharded

                return (lambda sc, cam, cfg, fr:  # noqa: E731
                        render_sharded(sc, cam, cfg, mesh, fr, gather=True))
            if mesh is None:
                fast = make_fast_renderer(opt_config)
                return lambda sc, cam, cfg, fr: fast(sc, cam, fr)  # noqa: E731
            fast = make_fast_renderer_sharded(opt_config, mesh)
            return (lambda sc, cam, cfg, fr:  # noqa: E731
                    fast(sc, cam, fr, gather=True))

        scene_bad, scene_true, problem = perturbed_problem(
            config, device, renderer, camera)
        writes = mesh is None or mesh.rank == 0
        _sync(device)
        t0 = time.perf_counter()
        result = optimize(
            scene_bad, problem, steps=args.steps, learning_rate=args.lr,
            checkpoint_path=args.checkpoint,
            # Every rank resumes from the checkpoint; only rank 0 writes it.
            checkpoint_every=args.checkpoint_every if writes else 2**62,
            callback=lambda s, l: print(f"step {s}: loss {l:.5f}",
                                        file=sys.stderr)
            if s % 20 == 0 else None,
        )
        _sync(device)
        print(f"optimized {args.steps} steps in "
              f"{time.perf_counter() - t0:.1f}s{_built(build_s)}",
              file=sys.stderr)
        print(f"recovered center: "
              f"{result.scene.centers[1].detach().cpu().numpy()} "
              f"(true {scene_true.centers[1].cpu().numpy()})",
              file=sys.stderr)
        print(f"recovered albedo: "
              f"{result.scene.materials.albedo[1].detach().cpu().numpy()} "
              f"(true {scene_true.materials.albedo[1].cpu().numpy()})",
              file=sys.stderr)
        # One line for scripts: the last loss of this run (nan when it
        # resumed at its end), the ball's errors at the end and the start.
        c1, a1 = ball_errors(result.scene, scene_true)
        c0, a0 = ball_errors(scene_bad, scene_true)
        last = result.losses[-1] if result.losses else float("nan")
        print(f"final loss={last:.6g} center_error={c1:.6g} "
              f"albedo_error={a1:.6g} center_error_start={c0:.6g} "
              f"albedo_error_start={a0:.6g}", file=sys.stderr)
        with torch.no_grad():
            img = render(result.scene, camera, config, 0)
        if writes:
            write_image(args.output, img)
    print(args.output)


def main(argv=None):
    p = argparse.ArgumentParser(prog="bevy_raytrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to an image file")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render an orbit sequence")
    _add_render_args(pa)
    pa.add_argument("--frames", type=int, default=8)
    pa.add_argument(
        "--replan-interval", type=int, default=8,
        help="cuda backend: re-probe the cost-balancing permutation every "
             "N frames so scheduling tracks the orbiting camera (0 = "
             "probe once on frame 0 and never again)")
    pa.set_defaults(fn=cmd_animate)

    ps = sub.add_parser(
        "serve", help="live interactive viewer over HTTP (fly camera)")
    _add_render_args(ps)
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (printed to stdout)")
    ps.set_defaults(fn=cmd_serve)

    pi = sub.add_parser("inverse", help="inverse-rendering recovery demo")
    _add_render_args(pi)
    pi.add_argument("--steps", type=int, default=120)
    pi.add_argument("--lr", type=float, default=1.5e-2)
    pi.add_argument("--checkpoint", default=None)
    pi.add_argument("--checkpoint-every", type=int, default=50)
    pi.set_defaults(fn=cmd_inverse)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
