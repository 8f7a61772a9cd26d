"""Faults that a render cell's timed path can have, planted in the program:
the `session` runner's FAULTS.

Each wraps the session that the window drives, so that the run measures
and checks it as it would the program: the CPU tests plant them in the
port's plain twin, and `readings.py --fault <name>` in the card's session
at the cell's own size.  Each has to come out not correct.

- "stale": a step that returns its state unchanged: every frame is the
  first frame's image;
- "half": half of the batch left out, the mean over the rest: half the
  samples of each pixel, or at one sample every other pixel's neighbour's;
- "bright": an answer altered where it is produced: the image 2% too
  bright;
- "block": a tile of the image wrong with no net bias, as a bad warp or
  thread block would leave it: a band of rows, a twentieth of the image
  (rounded up), each pixel moved by +DELTA or -DELTA in a checkerboard, so
  that neither the median error nor the mean bias moves.
"""

from __future__ import annotations

import torch

DELTA = 0.05


class _Stale:
    def __init__(self, inner):
        self.inner = inner
        self.image = None

    def render_frame(self, scene, camera):
        if self.image is None:
            self.image = self.inner.render_frame(scene, camera)
        return self.image


class _EveryOther:
    def __init__(self, inner):
        self.inner = inner

    def render_frame(self, scene, camera):
        img = self.inner.render_frame(scene, camera).clone()
        flat = img.reshape(-1, 3)
        flat[1::2] = flat[0::2][: flat[1::2].shape[0]]
        return img


class _Bright:
    def __init__(self, inner):
        self.inner = inner

    def render_frame(self, scene, camera):
        return self.inner.render_frame(scene, camera) * 1.02


class _Block:
    def __init__(self, inner):
        self.inner = inner

    def render_frame(self, scene, camera):
        img = self.inner.render_frame(scene, camera).clone()
        h, w = img.shape[:2]
        band = -(-h // 20)
        r0 = (h - band) // 2
        rows = torch.arange(band, device=img.device)[:, None]
        cols = torch.arange(w, device=img.device)[None, :]
        sign = 1.0 - 2.0 * ((rows + cols) % 2).to(img.dtype)
        img[r0:r0 + band] += DELTA * sign[..., None]
        return img


def _half(make_session):
    def make(config, device):
        spp = config.samples_per_pixel
        if spp > 1:
            return make_session(config.replace(samples_per_pixel=spp // 2),
                                device)
        return _EveryOther(make_session(config, device))

    return make


def _wrap(kind):
    def plant(make_session):
        return lambda config, device: kind(make_session(config, device))

    return plant


# The session runner's FAULTS: name -> plant(make_session) -> make_session.
FAULTS = {"stale": _wrap(_Stale), "half": _half, "bright": _wrap(_Bright),
          "block": _wrap(_Block)}
