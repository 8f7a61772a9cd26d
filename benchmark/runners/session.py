"""Runner "session": a closed loop of frames through a `Renderer` session.

One client requests a frame, waits for its image to be complete on the
device, and requests the next: the frame counter advances every frame (new
Monte-Carlo samples), and a mix with a moving camera hands the session a
new `Camera` each frame.  A frame's latency runs from its request (the
camera handed over, or the call for a fixed camera) to its image being
complete on the device.

Set-up builds the scene on the device from the seed, opens the session
(`Renderer(config, backend="cuda")`: its first frame is a probe that also
builds K1 on a checkout's first run; then a cached cost-balanced
permutation) and renders `warmup_frames` frames.  The window then renders
until `--seconds` have passed, and keeps a seeded uniform sample of the
frames for the check.  After the window has closed, the peak memory read
and the session freed, the plain reference renders a seeded sample of each
kept frame's pixels from the benchmark's own scene arrays and poses.

A mix for this runner holds `runner`, `samples_per_pixel`,
`warmup_frames` and `camera` (see brtbench/traffic.py), and nothing else:
a key it does not read is refused, so that no mix asks for traffic (other
clients, an open loop) that this runner would not send.  Its check is the
image comparison of brtbench/compare.py, its faults those of
brtbench/faults.py, its CPU rehearsal benchmark/tests/rehearse_session.py.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from brtbench import compare, faults, reference, scene_gen, traffic
from brtbench.tracing import launch_marker, profiler, reduce

# The host steps of a frame, in order; a frame's marks are when each began
# and when the last ended (tracing.reduce labels the idle gaps by them).
STEPS = ("camera", "render_frame", "synchronize")
NUMBERS = compare.NUMBERS
FAULTS = faults.FAULTS
MIX_KEYS = {"runner", "samples_per_pixel", "warmup_frames", "camera"}


@dataclasses.dataclass
class Record:
    """What one run measured and checked; the metric readers read it."""

    setup_s: float
    window_s: float
    frames: int
    paths_per_frame: int
    latencies_s: list
    n_spheres: int
    n_pix: int
    spp: int
    depth: int
    rounds_per_path: float  # the checked paths' mean (reference count)
    memory_peak_bytes: int
    trace: object  # tracing.Trace or None
    stats: dict
    checks: list  # [(name, value, limit)]
    correct: bool
    attempted: int
    failed: int
    control_stats: dict = None  # the control's numbers, when asked for
    setup_parts: dict = None  # seconds from the start to each set-up step
    marks: object = None  # int64 [frames, len(STEPS) + 1] host ns
    reduce_s: float = 0.0  # seconds the trace's reduction took
    check_s: float = 0.0  # seconds the reference took


def validate(cell) -> None:
    """Raise ValueError on a cell this runner cannot run: a mix key it does
    not read, limits other than the image check's numbers, no sample or
    bounce a path, or more checked pixels than a frame has."""
    config, mix, check = cell.config, cell.traffic, cell.check
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"traffic mix {cell.traffic_name!r}: the session "
                         f"runner reads no {sorted(unknown)}")
    if set(check["limits"]) != set(NUMBERS):
        raise ValueError(f"cell {cell.name!r}: limits "
                         f"{sorted(check['limits'])}, the image check "
                         f"compares {list(NUMBERS)}")
    if traffic.samples_per_pixel(mix, config) < 1 or config["max_depth"] < 1:
        raise ValueError(f"cell {cell.name!r}: a path needs a sample and a "
                         "bounce")
    if check["pixels"] > config["width"] * config["height"]:
        raise ValueError(f"cell {cell.name!r}: {check['pixels']} checked "
                         "pixels, more than a frame has")


def default_session(cfg, device):
    from bevy_raytrace_tpu_torch.wavefront import Renderer

    return Renderer(cfg, backend="cuda", device=device)


def _camera_args(config):
    cam = config["camera"]
    return dict(vup=tuple(cam["vup"]), vfov_deg=float(cam["vfov_deg"]),
                aspect=config["width"] / config["height"],
                aperture=float(cam["aperture"]),
                focus_dist=cam.get("focus_dist"))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_session=None, sync=None, control: bool = False) -> Record:
    """One run of `cell`; `make_session(cfg, device)` defaults to the
    program's CUDA session, `sync()` to `torch.cuda.synchronize`.  With
    `control` the record also holds the control's numbers: the reference
    at bfloat16 put in the program's place on the same pixels."""
    from bevy_raytrace_tpu_torch import Camera, RenderConfig
    from bevy_raytrace_tpu_torch.core.types import make_scene

    validate(cell)
    config, mix = cell.config, cell.traffic
    device = torch.device(device)
    parts = {"imports": time.perf_counter() - t_start}
    sync = sync or (lambda: torch.cuda.synchronize(device))
    make_session = make_session or default_session
    spp = traffic.samples_per_pixel(mix, config)
    base = int(seed) & reference.MASK32
    cfg = RenderConfig(width=int(config["width"]),
                       height=int(config["height"]), samples_per_pixel=spp,
                       max_depth=int(config["max_depth"]), seed=base)
    arrays = scene_gen.build(config["scene"], seed, device)
    scene = make_scene(arrays.centers, arrays.radii, arrays.material_id,
                       arrays.albedo, arrays.kind, arrays.fuzz, arrays.ior,
                       device=device)
    sync()
    parts["scene"] = time.perf_counter() - t_start
    path = traffic.CameraPath(mix, config, seed)
    cam_args = _camera_args(config)
    moving = path.motion != "fixed"
    block = 4096
    poses = {}

    def pose(k):
        lo = k - k % block
        if lo not in poses:
            poses.clear()
            poses[lo] = path.poses(np.arange(lo, lo + block))
        f, a = poses[lo]
        return f[k - lo].tolist(), a[k - lo].tolist()

    def camera(k):
        f, a = pose(k)
        return Camera.look_at(f, a, device=device, **cam_args)

    session = make_session(cfg, device)
    fixed_cam = camera(0)
    warm = int(mix["warmup_frames"])
    for k in range(warm):
        session.render_frame(scene, camera(k) if moving else fixed_cam)
        sync()
        parts[f"frame{k}"] = time.perf_counter() - t_start

    keep = traffic.Reservoir(int(cell.check["frames"]), seed)
    marks = []  # per frame: request, camera built, render_frame back, done
    clock = time.perf_counter_ns
    prof = profiler() if trace else None
    marker_ns = 0
    if prof is not None:
        prof.start()
        marker_ns = launch_marker(device)
    setup_s = time.perf_counter() - t_start
    t0 = clock()
    limit = t0 + int(seconds * 1e9)
    k = warm - 1  # the harness's own count: a session must advance a frame
    while True:
        k += 1
        t_req = clock()
        cam = camera(k) if moving else fixed_cam
        t_cam = clock()
        img = session.render_frame(scene, cam)
        t_ren = clock()
        sync()
        t_done = clock()
        marks.append((t_req, t_cam, t_ren, t_done))
        keep.offer((k, img))
        if t_done >= limit:
            break
    if prof is not None:
        prof.stop()
    marks = np.array(marks, np.int64)
    window_s = (t_done - t0) * 1e-9
    lat = ((marks[:, 3] - marks[:, 0]) * 1e-9).tolist()
    frames = len(lat)
    t_red = time.perf_counter()
    tr = reduce(prof, marker_ns, marks, STEPS) if prof is not None else None
    reduce_s = time.perf_counter() - t_red
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)

    # The program's checked pixels; then its state goes before the reference.
    n_pix = cfg.num_pixels
    px = int(cell.check["pixels"])
    checked = []
    for k, img in sorted(keep.items, key=lambda t: t[0]):
        pids = torch.from_numpy(traffic.checked_pixels(seed, k, n_pix, px)
                                ).to(device)
        checked.append((k, pids, img.reshape(-1, 3)[pids].float().clone()))
    del keep, img, session, scene, fixed_cam
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    prog, ref, ctl, rounds = [], [], [], []
    for k, pids, vals in checked:
        f, a = path.poses(np.array([k]))
        cams = reference.look_at(
            torch.tensor(f, dtype=torch.float32, device=device),
            torch.tensor(a, dtype=torch.float32, device=device),
            cam_args["vup"], cam_args["vfov_deg"], cam_args["aspect"],
            cam_args["aperture"], cam_args["focus_dist"])
        seeds = torch.full(pids.shape, reference.frame_seed(base, k),
                           dtype=torch.int64, device=device)
        r_vals, r_rounds = reference.render_pixels(
            arrays, cams.expand(pids.shape[0], 16), pids, seeds, spp,
            cfg.max_depth, cfg.width, cfg.height)
        prog.append(vals)
        ref.append(r_vals)
        rounds.append(r_rounds)
        if control:
            ctl.append(reference.render_pixels(
                arrays, cams.expand(pids.shape[0], 16), pids, seeds, spp,
                cfg.max_depth, cfg.width, cfg.height,
                dtype=torch.bfloat16)[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    check_s = time.perf_counter() - t_check
    bad_tol = float(cell.check["bad_tol"])
    stats = compare.image_stats(torch.cat(prog), torch.cat(ref), bad_tol)
    correct, rows = compare.judge(stats, cell.check["limits"])
    return Record(
        setup_s=setup_s, window_s=window_s, frames=frames,
        paths_per_frame=n_pix * spp, latencies_s=lat,
        n_spheres=arrays.count, n_pix=n_pix, spp=spp, depth=cfg.max_depth,
        rounds_per_path=float(torch.cat(rounds).sum()) / (
            sum(p.shape[0] for _, p, _ in checked) * spp),
        memory_peak_bytes=peak, trace=tr, stats=stats, checks=rows,
        correct=correct, attempted=frames, failed=0, reduce_s=reduce_s,
        setup_parts=parts, marks=marks,
        check_s=check_s,
        control_stats=(compare.image_stats(torch.cat(ctl), torch.cat(ref),
                                           bad_tol) if control else None))
