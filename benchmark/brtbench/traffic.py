"""The general traffic generator: a traffic mix's parameters and a seed ->
what each frame of a session asks for.

A mix (`benchmark/traffic/<name>.json`) names its runner, the samples a
frame takes (a number, or "config" for the configuration's own), and its
camera motion:

- "fixed": every frame sees the configuration's camera pose;
- "orbit": a fly path at the configuration's start pose.  The camera moves
  `speed` units a second over `frame_dt` seconds a frame on a circle about
  the look-at point through the start pose (so it stays over the scene),
  its height wobbling, and looks at the target turned by seeded yaw and
  pitch swings.  The seed picks the starting angle, the sense of travel and
  the phases of the swings: every seed flies the same loop, from another
  point of it.
"""

from __future__ import annotations

import math

import numpy as np


def samples_per_pixel(mix: dict, config: dict) -> int:
    spp = mix["samples_per_pixel"]
    return int(config["samples_per_pixel"] if spp == "config" else spp)


class CameraPath:
    """Camera poses (lookfrom, lookat) by absolute frame index."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.motion = mix["camera"]["motion"]
        cam = config["camera"]
        self.start = np.asarray(cam["lookfrom"], np.float64)
        self.target = np.asarray(cam["lookat"], np.float64)
        if self.motion == "fixed":
            return
        if self.motion != "orbit":
            raise ValueError(f"unknown camera motion {self.motion!r}")
        p = mix["camera"]
        rng = np.random.default_rng([int(seed), 0xCA3E])
        rel = self.start - self.target
        self.radius = math.hypot(rel[0], rel[2])
        self.step = float(p["speed"]) * float(p["frame_dt"]) / self.radius
        self.angle0 = math.atan2(rel[2], rel[0]) + rng.uniform(0, 2 * math.pi)
        self.sense = 1.0 if rng.random() < 0.5 else -1.0
        self.height_amp = float(p["height_amplitude"])
        self.height_period = float(p["height_period_frames"])
        self.yaw = math.radians(float(p["yaw_deg"]))
        self.yaw_period = float(p["yaw_period_frames"])
        self.pitch = math.radians(float(p["pitch_deg"]))
        self.pitch_period = float(p["pitch_period_frames"])
        self.phases = rng.uniform(0, 2 * math.pi, size=3)

    def poses(self, frames):
        """frames: int array [k] -> (lookfrom [k, 3], lookat [k, 3]) float64."""
        k = np.asarray(frames, np.float64)
        if self.motion == "fixed":
            return (np.broadcast_to(self.start, (k.size, 3)).copy(),
                    np.broadcast_to(self.target, (k.size, 3)).copy())
        ang = self.angle0 + self.sense * self.step * k
        ph_h, ph_y, ph_p = self.phases
        y = self.start[1] + self.height_amp * np.sin(
            2 * math.pi * k / self.height_period + ph_h)
        eye = np.stack([self.target[0] + self.radius * np.cos(ang), y,
                        self.target[2] + self.radius * np.sin(ang)], axis=1)
        fwd = self.target - eye
        dist = np.linalg.norm(fwd, axis=1)
        yaw = self.yaw * np.sin(2 * math.pi * k / self.yaw_period + ph_y)
        pitch = self.pitch * np.sin(2 * math.pi * k / self.pitch_period + ph_p)
        heading = np.arctan2(fwd[:, 2], fwd[:, 0]) + yaw
        elev = np.arcsin(np.clip(fwd[:, 1] / dist, -1, 1)) + pitch
        look = np.stack([np.cos(elev) * np.cos(heading), np.sin(elev),
                         np.cos(elev) * np.sin(heading)], axis=1)
        return eye, eye + look * dist[:, None]


def checked_pixels(seed: int, frame: int, n_pix: int, count: int):
    """The pixels of `frame` whose values are compared: `count` distinct
    absolute pixel ids drawn from (seed, frame), sorted."""
    rng = np.random.default_rng([int(seed), int(frame), 0x91C5])
    return np.sort(rng.choice(n_pix, size=min(count, n_pix), replace=False))


class Reservoir:
    """A uniform sample of `size` items of a stream of unknown length
    (Algorithm R), drawn from the seed."""

    _BLOCK = 1 << 16

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items = []
        self.seen = 0
        self._rng = np.random.default_rng([int(seed), 0x5E1])
        self._u = self._rng.random(self._BLOCK).tolist()

    def offer(self, item):
        """Keep `item` with the chance that leaves the sample uniform; cheap
        enough for a timed loop (the uniforms are drawn in blocks)."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        if self.seen > len(self._u):
            self._u.extend(self._rng.random(self._BLOCK).tolist())
        j = int(self._u[self.seen - 1] * self.seen)
        if j < self.size:
            self.items[j] = item
