"""Render configuration (mirror of `bevy_raytrace_tpu/config.py`).

The fields, defaults and validation are the reference's, so a config built
for one package describes the same frame in the other.  This module is a
copy rather than an import: importing `bevy_raytrace_tpu.config` would run
`bevy_raytrace_tpu/__init__.py`, which imports JAX.
"""

from __future__ import annotations

import dataclasses

VERY_FAR = 1.0e20  # "dead ray" / no-hit sentinel distance
EPSILON = 1.0e-3  # minimum ray t: the RTiOW shadow-acne guard
DEFAULT_FOV = 1.5708  # 90 degrees


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable).

    Attributes:
      width, height: framebuffer resolution in pixels.
      samples_per_pixel: Monte-Carlo samples per pixel per frame.
      max_depth: number of path segments (scatter events + the final miss).
      seed: base RNG seed folded into every PCG4D counter.
      ray_chunk: rays per inner step of the wavefront; bounds the transient
        [rays, spheres] intersection workspace.  0 = whole wavefront.
      spp_chunk: samples traced per wavefront step (spp must divide by it).
      t_min / t_max: valid hit interval.
      edge_softness: soft-silhouette gradient width (0 = off) of the
        differentiable renderers.  It changes gradients only: pixel values
        never depend on it.
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 16
    max_depth: int = 8
    seed: int = 0
    ray_chunk: int = 0
    spp_chunk: int = 1
    t_min: float = EPSILON
    t_max: float = VERY_FAR
    edge_softness: float = 0.0

    def __post_init__(self):
        if self.samples_per_pixel % max(self.spp_chunk, 1) != 0:
            raise ValueError(
                f"samples_per_pixel={self.samples_per_pixel} must be divisible "
                f"by spp_chunk={self.spp_chunk}"
            )
        if self.ray_chunk:
            if (self.width * self.height) % self.ray_chunk != 0:
                raise ValueError(
                    f"width*height={self.width * self.height} must be divisible "
                    f"by ray_chunk={self.ray_chunk}"
                )

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def rays_per_frame(self) -> int:
        """Camera rays per rendered frame (paths)."""
        return self.num_pixels * self.samples_per_pixel

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
