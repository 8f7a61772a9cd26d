"""Runner "session_culled": the `session` runner's closed loop of frames,
through a session that culls K1 by chunks of the mix's `cluster_size`.

The window, the kept frames and the check are the `session` runner's
(`runners/session.py`, imported, not copied): one client, a frame's latency
from its request to its image complete on the device, and after the window
the plain reference on a seeded sample of each kept frame's pixels.  What
this runner adds:

- the session: `Renderer(config, backend="cuda", cluster_size=L)`, which
  plans the chunks once (span `k1.plan`, set-up) and renders its probe
  frame and every later frame through the culled K1 (`k1_culled_kernel`);
  a session whose probe frame launches K1 dense is refused in set-up
  (`_Culls`), so that a program without the culled session fails the cell
  rather than timing the dense sweep under its name;
- the scene: a configuration's `scene` block with a `flake` is built by
  brtbench/scene_flake.py (the SPD sphereflake), any other by
  brtbench/scene_gen.py;
- the fault `drop_chunks`: the program's plan with every eighth chunk,
  from the first, never swept;
- in a traced run, the yardstick of `k1_culled_roofline_pct`: the least
  work a one-level cull of the plan must do on the checked pixels' paths
  (brtbench/yardstick/culled_sweep.py), as `culled_rounds_per_path`,
  `culled_members_per_path` and `culled_chunks` on the record.

A mix for this runner holds the `session` runner's keys and `cluster_size`,
which must be CLUSTER_SIZE, and nothing else.  Its CPU rehearsal is
benchmark/tests/rehearse_session_culled.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import torch

from brtbench import reference, scene_flake, scene_gen, spec, traffic
from brtbench.yardstick import culled_sweep

_session = spec.runner("session")

STEPS = _session.STEPS
NUMBERS = _session.NUMBERS
MIX_KEYS = _session.MIX_KEYS | {"cluster_size"}
# Pixels of one frame the yardstick traces in a traced run (at most the
# cell's checked pixels): its counts are means over their paths.
YARDSTICK_PIXELS = 2048
# The cluster size of the session this runner opens.  The contract's
# `default_session(config, device)` is given no mix, so a mix asks for this
# one and `validate` refuses another.
CLUSTER_SIZE = 12


def validate(cell) -> None:
    """The `session` runner's refusals, with `cluster_size` read: raise
    ValueError on a mix key this runner does not read, on a cluster size
    other than CLUSTER_SIZE, and on what the `session` runner cannot
    run."""
    mix = cell.traffic
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"traffic mix {cell.traffic_name!r}: the "
                         f"session_culled runner reads no {sorted(unknown)}")
    if mix.get("cluster_size") != CLUSTER_SIZE:
        raise ValueError(f"traffic mix {cell.traffic_name!r}: the session "
                         f"culls at cluster_size {CLUSTER_SIZE}, the mix "
                         f"asks for {mix.get('cluster_size')!r}")
    _session.validate(_plain(cell))


def _plain(cell):
    """`cell` as the `session` runner reads it: its mix without
    `cluster_size`."""
    mix = {k: v for k, v in cell.traffic.items() if k != "cluster_size"}
    return dataclasses.replace(cell, traffic=mix)


def build_scene(block: dict, seed: int, device):
    """The scene arrays of a configuration's `scene` block."""
    if "flake" in block:
        return scene_flake.build(block, seed, device)
    return scene_gen.build(block, seed, device)


def default_session(cfg, device):
    from bevy_raytrace_tpu_torch.wavefront import Renderer

    return _Culls(Renderer(cfg, backend="cuda", device=device,
                           cluster_size=CLUSTER_SIZE))


class _Culls:
    """The card's session held to the path this runner measures: its first
    frame (the probe, which plans the chunks) has to launch K1 and launch
    it only as the culled kernel (the port's counters `k1.launches` and
    `k1.launches_culled`).  A session that renders that frame dense, as a
    "cuda" session does that does not know how to cull, is refused there,
    in set-up, with a RuntimeError: its run would time the dense sweep
    under a culled cell's name.  Later frames pass straight through."""

    def __init__(self, inner):
        self.inner = inner
        self.checked = False

    def render_frame(self, scene, camera):
        if self.checked:
            return self.inner.render_frame(scene, camera)
        from bevy_raytrace_tpu_torch.utils.spans import counter

        k1, culled = counter("k1.launches"), counter("k1.launches_culled")
        img = self.inner.render_frame(scene, camera)
        k1 = counter("k1.launches") - k1
        culled = counter("k1.launches_culled") - culled
        if k1 == 0 or culled != k1:
            raise RuntimeError(
                f"the session's first frame launched K1 {k1} time(s), "
                f"{culled} of them culled: it does not cull K1 at "
                f"cluster_size {CLUSTER_SIZE}, so it cannot run this cell")
        self.checked = True
        return img


class _DropChunks:
    """The fault `drop_chunks`: while a frame renders, K1's culled tables
    are built with every eighth chunk's bound never live (br^2 = -inf,
    factor 0), so those chunks' members are never swept.  The table cache
    is emptied around each frame, so no table outlives the fault."""

    def __init__(self, inner):
        self.inner = inner

    def render_frame(self, scene, camera):
        from bevy_raytrace_tpu_torch.kernels import render_lanes

        build = render_lanes._scene_tables

        def faulty(scene, plan=None):
            tables = build(scene, plan)
            if plan is None:
                return tables
            geom, attr, cull = tables
            bounds, factor = cull.bounds.clone(), cull.factor.clone()
            bounds[::8, 3] = -float("inf")
            factor[::8] = 0.0
            return geom, attr, cull._replace(bounds=bounds, factor=factor)

        render_lanes._tables.clear()
        render_lanes._scene_tables = faulty
        try:
            return self.inner.render_frame(scene, camera)
        finally:
            render_lanes._scene_tables = build
            render_lanes._tables.clear()


def _drop_chunks(make_session):
    return lambda config, device: _DropChunks(make_session(config, device))


FAULTS = dict(_session.FAULTS, drop_chunks=_drop_chunks)


@contextlib.contextmanager
def _scenes_from(builder):
    """The `session` runner's scenes built by `builder` for a while."""
    was = _session.scene_gen
    _session.scene_gen = types.SimpleNamespace(build=builder)
    try:
        yield
    finally:
        _session.scene_gen = was


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_session=None, sync=None, control: bool = False):
    """One run of `cell` (see the module's docstring): the `session`
    runner's record, with the yardstick's counts in a traced run."""
    validate(cell)
    with _scenes_from(build_scene):
        rec = _session.run(_plain(cell), seed, seconds, trace, device,
                           t_start, make_session=make_session or
                           default_session, sync=sync, control=control)
    if trace:
        rounds, members, chunks = _yardstick(cell, seed, device)
        rec.culled_rounds_per_path = rounds
        rec.culled_members_per_path = members
        rec.culled_chunks = chunks
    return rec


def _yardstick(cell, seed: int, device):
    """(rounds, members a path, chunks) of culled_sweep on the fixed
    camera's first frame, at most YARDSTICK_PIXELS of its checked pixels."""
    config, mix = cell.config, cell.traffic
    device = torch.device(device)
    arrays = build_scene(config["scene"], seed, device)
    width, height = int(config["width"]), int(config["height"])
    spp = traffic.samples_per_pixel(mix, config)
    n_pix = width * height
    px = min(int(cell.check["pixels"]), YARDSTICK_PIXELS)
    pids = torch.from_numpy(traffic.checked_pixels(seed, 0, n_pix, px)).to(
        device)
    f, a = traffic.CameraPath(mix, config, seed).poses(np.array([0]))
    cam = config["camera"]
    cams = reference.look_at(
        torch.tensor(f, dtype=torch.float32, device=device),
        torch.tensor(a, dtype=torch.float32, device=device),
        tuple(cam["vup"]), float(cam["vfov_deg"]), width / height,
        float(cam["aperture"]), cam.get("focus_dist"))
    base = int(seed) & reference.MASK32
    seeds = torch.full(pids.shape, reference.frame_seed(base, 0),
                       dtype=torch.int64, device=device)
    size = int(mix["cluster_size"])
    rounds, members = culled_sweep.count_paths(
        arrays, cams.expand(pids.shape[0], 16), pids, seeds, spp,
        int(config["max_depth"]), width, height, size)
    paths = pids.shape[0] * spp
    return (float(rounds.sum()) / paths, float(members.sum()) / paths,
            -(-arrays.count // size))
