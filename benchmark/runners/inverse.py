"""Runner "inverse": closed-loop optimizer steps of the port's inverse
rendering path, checked against the plain gradient reference.

The work is the port's normal inverse path, the one `cli inverse` runs: an
`InverseProblem` over the scene's `optimizable` parameters whose render
function is `make_fast_renderer(config, clusters=cluster_scene(scene, L))`
(the culled K2 records each render's paths, K3 replays them backward), the
loss `render_loss` (two renders a step, frames 2k and 2k + 1), and Adam at
`optimize`'s betas and eps, each step through `inverse.optimize_step`, the
step `optimize` takes (frame == step).  One client takes a step, waits for
it to be complete on the device and takes the next.

Set-up builds the configuration's scene on the device from the seed (the
true scene: its layout fixed, its colours the seed's), renders the target
from it with the session's render function (frame TARGET_FRAME), and draws
the start from the mix's fixed `perturb_seed`: every center moved by a
uniform draw in +-`center_noise` per axis, every albedo by one in
+-`albedo_noise` (clipped to [0, 1]), the same for every `--seed`, so that
every run does the same work.  The session builds the cluster plan from
the start and takes `warmup_steps` steps.  The window then steps until
`--seconds` have passed, and keeps a seeded uniform sample of `steps`
steps (the cell file): the parameters before and after, Adam's state
before, the gradient the step's backward left on the parameters (read by a
hook as it lands, before the update), and the step's two images.  An item
is one step; `paths_per_frame` is width x height x spp, the paths of one
render (a step traces two, so `rays_per_s` counts half the paths a step
traces); the record keeps every step's loss.

The check, after the window has closed and the peak memory was read, on
`pixels` seeded pixels (the same in both frames) of each kept step, at the
kept parameters and step:

- the timed step's own loss, taken again: `InverseProblem.loss_fn` and
  its gradient through the session's problem must give the step's loss
  and its two images bit for bit, and its gradient (the one the hook
  kept) to TIMED_RTOL of its norm, or the run is not correct;
- `median_err`, `bad_frac`, `mean_bias` (brtbench/compare.py): the kept
  images against the plain reference's (brtbench/reference_grad.py, its
  own sweep);
- `path_diff_frac`: the share of the checked paths of both frames whose
  recorded winner or runner-up (the program's recorder, as the render
  function runs it; it must give the kept images bit for bit) differs at
  some bounce from the reference's sweep;
- `grad_rel_err`: the largest, over the kept steps and over centers and
  albedo, of ||G - R|| / ||R||.  G is the program's gradient of its own
  loss, `InverseProblem.loss_fn` through the session's problem, masked to
  the checked pixels (each render's other pixels take the target's value)
  with the target there the plain reference's render of the true scene;
  R is the reference's gradient of the same loss, the cross estimator of
  both frames, on the recorded paths with the kept images as the loss's
  images (why those paths and those images: brtbench/reference_grad.py);
- `update_max_rel`: the largest, over the kept steps, of
  ||dP - dR|| / ||dR|| over centers and albedo together, where dP is the
  step's change of the parameters and dR that of a plain Adam update
  (float64; betas 0.9, 0.999, eps 1e-8, the mix's rate) of the kept
  gradient from the kept state, its step count the runner's own count of
  steps taken, and dR rounded as the float32 parameters round it.

The control, in the program's place on the same inputs: the reference at
bfloat16 (its images, its own paths and its gradient on them, held to the
float32 reference's gradient on the same paths), and the Adam update in
bfloat16.

A mix holds `runner`, `samples_per_pixel`, `edge_softness`,
`cluster_size`, `optimizable` (of centers and albedo: what the reference
differentiates), `perturb_seed`, `center_noise`, `albedo_noise`, `lr` (a
number: one Adam group, as `optimize` builds it) and `warmup_steps`, and
nothing else.  Its CPU rehearsal is benchmark/tests/rehearse_inverse.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from brtbench import compare, reference, reference_grad, scene_gen, traffic
from brtbench.tracing import launch_marker, profiler, reduce

STEPS = ("step", "synchronize")
NUMBERS = ("median_err", "bad_frac", "mean_bias", "path_diff_frac",
           "grad_rel_err", "update_max_rel")
MIX_KEYS = {"runner", "samples_per_pixel", "edge_softness", "cluster_size",
            "optimizable", "perturb_seed", "center_noise", "albedo_noise",
            "lr", "warmup_steps"}
PARAMS = ("centers", "albedo")
# The target's frame: far from any step's (steps render frames 2k, 2k + 1).
TARGET_FRAME = 1 << 24
# The plain Adam of the check (the values `optimize` states).
BETAS = (0.9, 0.999)
EPS = 1e-8
# The timed step's gradient against the same loss's taken again: K3 adds
# a frame's cotangents in float64 atomics, in another order each launch,
# and rounds them to float32, so that a few entries may differ by an ulp.
TIMED_RTOL = 1e-6


@dataclasses.dataclass
class Problem:
    """What a session is made from."""

    config: object  # RenderConfig
    scene_true: object  # the port's Scene the target is rendered from
    scene: object  # the start
    camera: object
    names: tuple
    lr: float
    cluster_size: int


class Session:
    """The program: the port's inverse problem, stepped by
    `optimize_step`."""

    def __init__(self, problem: Problem, device):
        from bevy_raytrace_tpu_torch.inverse import (
            InverseProblem,
            make_fast_renderer,
        )
        from bevy_raytrace_tpu_torch.inverse.optimize import adam, leaf_params
        from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene

        cfg = self.config = problem.config
        self.names = problem.names
        self.scene, self.camera = problem.scene, problem.camera
        self.plan = cluster_scene(problem.scene, problem.cluster_size)
        self.render = make_fast_renderer(cfg, clusters=self.plan)
        with torch.no_grad():
            self.target = self.render(problem.scene_true, problem.camera,
                                      TARGET_FRAME)
        self.images = []

        def render_fn(scene, camera, config, frame):
            img = self.render(scene, camera, frame)
            self.images.append(img.detach())
            return img

        self.problem = InverseProblem(cfg, problem.camera, self.target,
                                      self.names, render_fn=render_fn)
        self.params = leaf_params(problem.scene, self.names)
        self.opt = adam(problem.lr)([self.params[n] for n in self.names])
        self.capture = False
        self.grads = {}
        for n, p in self.params.items():
            p.register_post_accumulate_grad_hook(self._hook(n))

    def _hook(self, name):
        def keep(p):
            if self.capture:
                self.grads[name] = p.grad.detach().clone()

        return keep

    def step(self, k: int):
        from bevy_raytrace_tpu_torch.inverse import optimize_step

        self.images = []
        return optimize_step(self.problem, self.scene, self.params, self.opt,
                             k)

    def snapshot(self, with_state: bool):
        """Copies of the parameters (and of Adam's state of each)."""
        out = {n: p.detach().clone() for n, p in self.params.items()}
        if with_state:
            for n, p in self.params.items():
                st = self.opt.state[p]
                out[f"exp_avg.{n}"] = (st["exp_avg"].clone() if st else
                                       torch.zeros_like(p))
                out[f"exp_avg_sq.{n}"] = (st["exp_avg_sq"].clone() if st
                                          else torch.zeros_like(p))
        return out

    def _scene(self, values: dict):
        mats = self.scene.materials
        if "albedo" in values:
            mats = dataclasses.replace(mats, albedo=values["albedo"])
        return dataclasses.replace(
            self.scene, centers=values.get("centers", self.scene.centers),
            materials=mats)

    def record(self, values: dict, frame: int):
        """The program's recorder as the render function runs it (K2 with
        the session's plan), at parameter values `values`, frame `frame`,
        with both residual streams -> (image, res, res2)."""
        from bevy_raytrace_tpu_torch.core.geometry import sphere_table
        from bevy_raytrace_tpu_torch.kernels.record import record_frame

        scene = self._scene(values)
        table = sphere_table(scene.centers, scene.radii, scene.materials,
                             scene.material_id)
        return record_frame(table.detach().contiguous(),
                            self.camera.pack().detach().contiguous(),
                            self.config, frame, record_second=True,
                            clusters=self.plan)

    def loss(self, values: dict, step: int, problem=None):
        """The loss of `problem` (None: the session's own,
        `InverseProblem.loss_fn`, the timed step's) at parameter values
        `values` and step `step`, and its gradient -> (loss, the two
        images, {name: grad})."""
        problem = problem or self.problem
        params = {n: values[n].clone().requires_grad_(True)
                  for n in self.names}
        self.images = []
        loss = problem.loss_fn(params, self.scene, step)
        grads = torch.autograd.grad(loss, [params[n] for n in self.names])
        return loss.detach(), list(self.images), dict(zip(self.names, grads))

    def masked(self, pids, target):
        """The session's problem with its loss masked to pixels `pids`,
        whose target values are `target` [n, 3]: each render's other pixels
        take the target's value, so that they add nothing to the loss or
        to its gradient."""
        shape = self.problem.target.shape
        tgt = self.problem.target.reshape(-1, 3).clone()
        tgt[pids] = target
        mask = torch.zeros((tgt.shape[0], 1), dtype=torch.bool,
                           device=tgt.device)
        mask[pids] = True
        tgt, mask = tgt.reshape(shape), mask.reshape(shape[0], shape[1], 1)
        render = self.problem.render_fn

        def render_masked(scene, camera, config, frame):
            return torch.where(mask, render(scene, camera, config, frame),
                               tgt)

        return dataclasses.replace(self.problem, target=tgt,
                                   render_fn=render_masked)


def default_session(problem, device):
    return Session(problem, device)


# --- faults --------------------------------------------------------------


class _OptProxy:
    """An optimizer in the session's place that passes everything on."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]


class _StaleGrad(_OptProxy):
    """Every step applies the first step's gradient."""

    first = None

    def step(self):
        ps = self._params()
        if self.first is None:
            self.first = [p.grad.detach().clone() for p in ps]
        else:
            for p, g in zip(ps, self.first):
                p.grad = g.clone()
        self.inner.step()


class _SkipUpdate(_OptProxy):
    """Every other step skips Adam (the second, the fourth, ...)."""

    calls = 0

    def step(self):
        self.calls += 1
        if self.calls % 2:
            self.inner.step()


def _wrap_opt(kind):
    def plant(make_session):
        def make(problem, device):
            s = make_session(problem, device)
            s.opt = kind(s.opt)
            return s

        return make

    return plant


def _with_config(**change):
    def plant(make_session):
        def make(problem, device):
            cfg = problem.config
            change_now = {k: (v(cfg) if callable(v) else v)
                          for k, v in change.items()}
            return make_session(dataclasses.replace(
                problem, config=cfg.replace(**change_now)), device)

        return make

    return plant


def _half_batch(make_session):
    """The backward through frame 2k alone: frame 2k + 1's image enters
    the loss detached."""
    def make(problem, device):
        s = make_session(problem, device)
        render = s.problem.render_fn

        def first_only(scene, camera, config, frame):
            img = render(scene, camera, config, frame)
            return img.detach() if frame % 2 else img

        s.problem = dataclasses.replace(s.problem, render_fn=first_only)
        return s

    return make


# One lane in MISROUTE_EVERY (by pixel and sample) is misrouted: 3%.
MISROUTE_EVERY = 33


def _misrouted(record_frame):
    """`record_frame` whose residuals send a fixed 3% of the paths, at
    every bounce that hit, to the next sphere: the image stays the
    recorder's own, the paths the replay (and the check) read do not."""
    def record(table, *args, **kw):
        img, res, res2 = record_frame(table, *args, **kw)
        if res is not None:
            spp, _, n = res.shape
            lane = (torch.arange(n, device=res.device)[None, :] * 7
                    + torch.arange(spp, device=res.device)[:, None] * 13)
            pick = (lane % MISROUTE_EVERY == 0)[:, None, :] & (res >= 0)
            res = torch.where(pick, (res + 1) % table.shape[0], res
                              ).to(res.dtype)
        return img, res, res2

    return record


def _misroute(make_session):
    """A recorder that misroutes 3% of its paths (`_misrouted`), in the
    session's renders and in the recorder its check calls."""
    @contextlib.contextmanager
    def swapped():
        from bevy_raytrace_tpu_torch.kernels import record

        sound = record.record_frame
        record.record_frame = _misrouted(sound)
        try:
            yield
        finally:
            record.record_frame = sound

    def within(fn):
        def call(*args, **kw):
            with swapped():
                return fn(*args, **kw)

        return call

    def make(problem, device):
        s = make_session(problem, device)
        s.render, s.record = within(s.render), within(s.record)
        return s

    return make


FAULTS = {
    "stale_grad": _wrap_opt(_StaleGrad),
    # The backward without the silhouette term: the renderer of a config
    # whose edge_softness is 0 (its images are the same).
    "no_edge": _with_config(edge_softness=0.0),
    "half_spp": _with_config(
        samples_per_pixel=lambda c: max(c.samples_per_pixel // 2, 1)),
    "skip_update": _wrap_opt(_SkipUpdate),
    "half_batch": _half_batch,
    "misroute": _misroute,
}


# --- the cell ------------------------------------------------------------


def validate(cell) -> None:
    """Raise ValueError on a cell this runner cannot run: a mix key it does
    not read, limits other than its check's numbers, a parameter the
    reference does not differentiate, a rate that is not a number, no
    sample or bounce a path, deeper
    paths than K3 replays, no kept step, or more checked pixels than a
    frame has."""
    config, mix, check = cell.config, cell.traffic, cell.check
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"traffic mix {cell.traffic_name!r}: the inverse "
                         f"runner reads no {sorted(unknown)}")
    if set(check["limits"]) != set(NUMBERS):
        raise ValueError(f"cell {cell.name!r}: limits "
                         f"{sorted(check['limits'])}, the inverse check "
                         f"compares {list(NUMBERS)}")
    names = list(mix["optimizable"])
    if not names or not set(names) <= set(PARAMS) or (
            len(set(names)) != len(names)):
        raise ValueError(f"traffic mix {cell.traffic_name!r}: optimizable "
                         f"{names}; the reference differentiates "
                         f"{list(PARAMS)}")
    if not isinstance(mix["lr"], (int, float)) or isinstance(mix["lr"],
                                                             bool):
        raise ValueError(f"traffic mix {cell.traffic_name!r}: lr "
                         f"{mix['lr']!r} is not a number")
    if traffic.samples_per_pixel(mix, config) < 1 or config["max_depth"] < 1:
        raise ValueError(f"cell {cell.name!r}: a path needs a sample and a "
                         "bounce")
    if config["max_depth"] > 16:
        raise ValueError(f"cell {cell.name!r}: max_depth "
                         f"{config['max_depth']}, K3 replays 16 at most")
    if int(check["steps"]) < 1:
        raise ValueError(f"cell {cell.name!r}: the check keeps no step")
    if check["pixels"] > config["width"] * config["height"]:
        raise ValueError(f"cell {cell.name!r}: {check['pixels']} checked "
                         "pixels, more than a frame has")


@dataclasses.dataclass
class Record:
    """What one run measured and checked; the metric readers read it."""

    setup_s: float
    window_s: float
    frames: int  # steps, as `rays_per_s` counts items
    paths_per_frame: int  # width x height x spp: the paths of one render
    latencies_s: list
    n_spheres: int
    n_pix: int
    spp: int
    depth: int
    rounds_per_path: float  # the checked paths' mean (reference count)
    hits_per_path: float  # their bounces that hit a sphere, a path
    memory_peak_bytes: int
    trace: object
    stats: dict
    checks: list
    correct: bool
    attempted: int
    failed: int
    losses: list  # every step of the window
    control_stats: dict = None
    setup_parts: dict = None
    marks: object = None
    reduce_s: float = 0.0
    check_s: float = 0.0


def _start(arrays, mix: dict):
    """The start's centers and albedo, from the mix's fixed seed."""
    rng = np.random.default_rng([int(mix["perturb_seed"]), 0x1E5])
    n, m = arrays.centers.shape[0], arrays.albedo.shape[0]
    dc = rng.uniform(-1.0, 1.0, (n, 3)) * float(mix["center_noise"])
    da = rng.uniform(-1.0, 1.0, (m, 3)) * float(mix["albedo_noise"])
    dev = arrays.centers.device
    centers = arrays.centers + torch.tensor(dc, dtype=torch.float32,
                                            device=dev)
    albedo = torch.clamp(arrays.albedo + torch.tensor(
        da, dtype=torch.float32, device=dev), 0.0, 1.0)
    return centers, albedo


def _adam(before: dict, grads: dict, names, lr: float, t: int, dtype):
    """The change of a plain Adam step of `grads` from the kept state,
    step count t, computed in `dtype` -> {name: change, float64}."""
    b1, b2 = BETAS
    out = {}
    for n in names:
        g = grads[n].to(dtype)
        m = b1 * before[f"exp_avg.{n}"].to(dtype) + (1.0 - b1) * g
        v = b2 * before[f"exp_avg_sq.{n}"].to(dtype) + (1.0 - b2) * g * g
        denom = torch.sqrt(v) / math.sqrt(1.0 - b2 ** t) + EPS
        out[n] = (-(lr / (1.0 - b1 ** t)) * m / denom).to(torch.float64)
    return out


def _update_rel(before, after, change, names) -> float:
    """||dP - dR|| / ||dR||, dR rounded as the float32 parameters round
    it."""
    num = den = 0.0
    for n in names:
        p0 = before[n].to(torch.float64)
        d_prog = after[n].to(torch.float64) - p0
        d_ref = (p0 + change[n]).to(torch.float32).to(torch.float64) - p0
        num += float(((d_prog - d_ref) ** 2).sum())
        den += float((change[n] ** 2).sum())
    return math.sqrt(num) / math.sqrt(den) if den > 0 else (
        0.0 if num == 0 else math.inf)


def _grad_rel(prog: dict, ref: dict, names) -> float:
    out = 0.0
    for n in names:
        num = float(torch.linalg.vector_norm(
            prog[n].to(torch.float64) - ref[n].to(torch.float64)))
        den = float(torch.linalg.vector_norm(ref[n].to(torch.float64)))
        out = max(out, num / den if den > 0 else (0.0 if num == 0
                                                  else math.inf))
    return out


def _camera_args(config):
    cam = config["camera"]
    return dict(vup=tuple(cam["vup"]), vfov_deg=float(cam["vfov_deg"]),
                aspect=config["width"] / config["height"],
                aperture=float(cam["aperture"]),
                focus_dist=cam.get("focus_dist"))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_session=None, sync=None, control: bool = False) -> Record:
    """One run of `cell`; `make_session(problem, device)` defaults to the
    program's session, `sync()` to `torch.cuda.synchronize`.  With
    `control` the record also holds the control's numbers."""
    from bevy_raytrace_tpu_torch import Camera, RenderConfig
    from bevy_raytrace_tpu_torch.core.types import make_scene

    validate(cell)
    config, mix = cell.config, cell.traffic
    device = torch.device(device)
    parts = {"imports": time.perf_counter() - t_start}
    sync = sync or (lambda: torch.cuda.synchronize(device))
    make_session = make_session or default_session
    names = tuple(mix["optimizable"])
    lr = float(mix["lr"])
    spp = traffic.samples_per_pixel(mix, config)
    base = int(seed) & reference.MASK32
    cfg = RenderConfig(width=int(config["width"]),
                       height=int(config["height"]), samples_per_pixel=spp,
                       max_depth=int(config["max_depth"]), seed=base,
                       edge_softness=float(mix["edge_softness"]))
    arrays = scene_gen.build(config["scene"], seed, device)
    centers0, albedo0 = _start(arrays, mix)

    def port_scene(centers, albedo):
        return make_scene(centers, arrays.radii, arrays.material_id, albedo,
                          arrays.kind, arrays.fuzz, arrays.ior, device=device)

    cam_args = _camera_args(config)
    cam_conf = config["camera"]
    camera = Camera.look_at(list(map(float, cam_conf["lookfrom"])),
                            list(map(float, cam_conf["lookat"])),
                            device=device, **cam_args)
    problem = Problem(cfg, port_scene(arrays.centers, arrays.albedo),
                      port_scene(centers0, albedo0), camera, names, lr,
                      int(mix["cluster_size"]))
    session = make_session(problem, device)
    sync()
    parts["session"] = time.perf_counter() - t_start
    warm = int(mix["warmup_steps"])
    for k in range(warm):
        session.step(k)
        sync()
        parts[f"step{k}"] = time.perf_counter() - t_start

    sample = traffic.Reservoir(int(cell.check["steps"]), seed)
    kept = {}
    marks, losses = [], []
    clock = time.perf_counter_ns
    prof = profiler() if trace else None
    marker_ns = 0
    if prof is not None:
        prof.start()
        marker_ns = launch_marker(device)
    setup_s = time.perf_counter() - t_start
    t0 = clock()
    limit = t0 + int(seconds * 1e9)
    k = warm - 1  # frame == step, as in `optimize`
    while True:
        k += 1
        t_req = clock()
        # Decided before the step, so that only a kept step pays for its
        # copies; a step the sample drops goes at once.
        sample.offer(k)
        keep = k in sample.items
        if keep:
            for j in [j for j in kept if j not in sample.items]:
                del kept[j]
            before = session.snapshot(with_state=True)
            session.capture = True
        loss = session.step(k)
        t_step = clock()
        sync()
        t_done = clock()
        marks.append((t_req, t_step, t_done))
        losses.append(loss)
        if keep:
            session.capture = False
            kept[k] = (before, session.snapshot(with_state=False),
                       dict(session.grads), list(session.images), loss)
        if t_done >= limit:
            break
    if prof is not None:
        prof.stop()
    marks = np.array(marks, np.int64)
    window_s = (t_done - t0) * 1e-9
    lat = ((marks[:, -1] - marks[:, 0]) * 1e-9).tolist()
    t_red = time.perf_counter()
    tr = reduce(prof, marker_ns, marks, STEPS) if prof is not None else None
    reduce_s = time.perf_counter() - t_red
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    losses = torch.stack(losses).float().cpu().tolist()

    t_check = time.perf_counter()
    cams = reference.look_at(
        torch.tensor([cam_conf["lookfrom"]], dtype=torch.float32,
                     device=device),
        torch.tensor([cam_conf["lookat"]], dtype=torch.float32,
                     device=device),
        cam_args["vup"], cam_args["vfov_deg"], cam_args["aspect"],
        cam_args["aperture"], cam_args["focus_dist"])
    dims = (spp, cfg.max_depth, cfg.width, cfg.height)
    n_pix = cfg.num_pixels
    px = int(cell.check["pixels"])

    def seeds_of(pids, frame):
        return torch.full(pids.shape, reference.frame_seed(base, frame),
                          dtype=torch.int64, device=device)

    # The program's side of the check; then its state goes.
    steps = []
    timed_equal = True
    timed_rel = 0.0
    for k in sorted(kept):
        before, after, grads, images, loss = kept.pop(k)
        frames = (2 * k, 2 * k + 1)
        pids = torch.from_numpy(traffic.checked_pixels(
            seed, frames[0], n_pix, px)).to(device)
        c = cams.expand(pids.shape[0], 16)
        target = reference_grad.trace_pixels(
            arrays, c, pids, seeds_of(pids, TARGET_FRAME), *dims).image
        again, imgs, g_again = session.loss(before, k)
        timed_equal = timed_equal and torch.equal(again, loss)
        timed_rel = max(timed_rel, _grad_rel(grads, g_again, names))
        _, imgs_m, g_prog = session.loss(before, k,
                                         session.masked(pids, target))
        recorded = []
        for i, frame in enumerate(frames):
            img_r, res, res2 = session.record(before, frame)
            timed_equal = timed_equal and all(
                torch.equal(im[i], images[i]) for im in (imgs, imgs_m))
            timed_equal = timed_equal and torch.equal(img_r, images[i])
            recorded.append(reference_grad.events_of(res, res2, pids)
                            if res.shape[0] == spp else None)
            del img_r, res, res2
        steps.append(dict(
            k=k, before=before, after=after, grads=grads, pids=pids,
            g_prog=g_prog, recorded=recorded, target=target,
            vals=[im.reshape(-1, 3)[pids].float().clone() for im in images]))
        del imgs, imgs_m, images
    del kept, session, problem
    if device.type == "cuda":
        torch.cuda.empty_cache()

    edge = cfg.edge_softness
    # The program's loss is the mean over pixels and channels.
    weights = torch.full((px,), 1.0 / (n_pix * 3), dtype=torch.float32,
                         device=device)
    num = {n: 0.0 for n in ("grad_rel_err", "update_max_rel")}
    ctl_num = dict(num)
    prog, ref, ctl = [], [], []
    differ = ctl_differ = lanes = 0
    rounds = hits = 0.0
    for s in steps:
        k, before, pids = s["k"], s["before"], s["pids"]
        scene_k = dataclasses.replace(
            arrays, centers=before.get("centers", arrays.centers),
            albedo=before.get("albedo", arrays.albedo))
        c = cams.expand(pids.shape[0], 16)
        seeds = tuple(seeds_of(pids, f) for f in (2 * k, 2 * k + 1))
        sweeps = [reference_grad.trace_pixels(scene_k, c, pids, sd, *dims)
                  for sd in seeds]
        events = []
        for sweep, rec in zip(sweeps, s["recorded"]):
            ref.append(sweep.image)
            rounds += float(sweep.rounds.sum())
            hits += float(sweep.hits.sum())
            lanes += sweep.events.shape[2]
            if rec is None:  # another sample count than the cell's
                differ += sweep.events.shape[2]
                events.append(sweep.events)
            else:
                differ += int(reference_grad.paths_differ(
                    rec, sweep.events).sum())
                events.append(rec)
        prog += s["vals"]
        grad_args = (scene_k, c, pids, seeds, *dims, s["target"], weights,
                     edge)
        _, _, dc, da = reference_grad.cross_loss_grad(
            *grad_args, events=tuple(events), images=tuple(s["vals"]))
        num["grad_rel_err"] = max(num["grad_rel_err"], _grad_rel(
            s["g_prog"], {"centers": dc, "albedo": da}, names))
        change = _adam(before, s["grads"], names, lr, k + 1, torch.float64)
        num["update_max_rel"] = max(num["update_max_rel"], _update_rel(
            before, s["after"], change, names))
        if control:
            # The control in the program's place: it takes its own paths
            # at bfloat16 and its gradient on them.
            own_a, own_b, dc, da = reference_grad.cross_loss_grad(
                *grad_args, dtype=torch.bfloat16)
            for own, sweep in zip((own_a, own_b), sweeps):
                ctl.append(own.image)
                ctl_differ += int(reference_grad.paths_differ(
                    own.events, sweep.events).sum())
            _, _, rc, ra = reference_grad.cross_loss_grad(
                *grad_args, events=(own_a.events, own_b.events),
                images=(own_a.image, own_b.image))
            ctl_num["grad_rel_err"] = max(ctl_num["grad_rel_err"], _grad_rel(
                {"centers": dc, "albedo": da},
                {"centers": rc, "albedo": ra}, names))
            change_bf = _adam(before, s["grads"], names, lr, k + 1,
                              torch.bfloat16)
            after_bf = {n: (before[n].to(torch.float64) + change_bf[n]
                            ).to(torch.float32) for n in names}
            ctl_num["update_max_rel"] = max(
                ctl_num["update_max_rel"],
                _update_rel(before, after_bf, change, names))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    check_s = time.perf_counter() - t_check
    bad_tol = float(cell.check["bad_tol"])
    stats = compare.image_stats(torch.cat(prog), torch.cat(ref), bad_tol)
    timed_equal = timed_equal and timed_rel <= TIMED_RTOL
    stats.update(num, path_diff_frac=differ / lanes, timed_grad_rel=timed_rel,
                 timed_equal=bool(timed_equal))
    limits = cell.check["limits"]
    rows = [(n, stats[n], float(limits[n])) for n in NUMBERS]
    correct = bool(stats["finite"] and timed_equal and all(
        math.isfinite(v) and v <= lim for _, v, lim in rows))
    control_stats = None
    if control:
        control_stats = compare.image_stats(torch.cat(ctl), torch.cat(ref),
                                            bad_tol)
        control_stats.update(ctl_num, path_diff_frac=ctl_differ / lanes)
    return Record(
        setup_s=setup_s, window_s=window_s, frames=len(lat),
        paths_per_frame=n_pix * spp, latencies_s=lat,
        n_spheres=arrays.count, n_pix=n_pix, spp=spp, depth=cfg.max_depth,
        rounds_per_path=rounds / lanes, hits_per_path=hits / lanes,
        memory_peak_bytes=peak, trace=tr, stats=stats, checks=rows,
        correct=correct, attempted=len(lat), failed=0, losses=losses,
        control_stats=control_stats, setup_parts=parts, marks=marks,
        reduce_s=reduce_s, check_s=check_s)
