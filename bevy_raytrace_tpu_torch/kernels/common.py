"""Scalar helpers shared by the kernel's plain PyTorch twin.

Mirror of the helpers `bevy_raytrace_tpu/kernels/pallas_render.py` gives
its kernels (`_pcg4d`, `_to_unit`, `_rsqrt_guard`, `_cbrt`, `_TWO_PI`).
Their CUDA counterparts live in `csrc/common.cuh`; keep the two in step.
"""

from __future__ import annotations

import torch

from bevy_raytrace_tpu_torch.rng.pcg import TWO_PI as _TWO_PI
from bevy_raytrace_tpu_torch.rng.pcg import _to_unit_float as _to_unit
from bevy_raytrace_tpu_torch.rng.pcg import pcg4d as _pcg4d

__all__ = ["_pcg4d", "_to_unit", "_rsqrt_guard", "_cbrt", "_TWO_PI"]


def _rsqrt_guard(n2):
    return torch.rsqrt(torch.clamp(n2, min=1e-20))


def _cbrt(v):
    """Positive-domain cube root as exp(log(v)/3): the kernels' form."""
    return torch.where(
        v < 1e-30, 0.0,
        torch.exp(torch.log(torch.clamp(v, min=1e-30)) * (1.0 / 3.0)))
