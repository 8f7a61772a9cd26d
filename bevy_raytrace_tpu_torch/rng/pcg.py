"""Counter-based RNG (PCG4D), bit-exact with `bevy_raytrace_tpu/rng/pcg.py`.

Every draw is a pure function of a 4D counter (pixel, sample, stream, seed),
so any layout of the work (lane permutation, stripes, chunks) draws the same
numbers, and the CUDA kernel's native `uint32_t` version
(`csrc/common.cuh`) draws them too.

torch on the CPU has no uint32 `+` or `>>`, so counters here are int64
tensors that hold values in [0, 2^32) and every step masks back to 32 bits.
A product of two 32-bit values does not fit in int64, so `_mul32` splits one
factor into 16-bit halves; every intermediate stays below 2^49.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_INV_2POW24 = 1.0 / 16777216.0  # 2**-24, exact in float32
# float32(2*pi), the constant the reference kernels multiply by.
TWO_PI = 6.2831854820251465


def as_u32(v, device=None) -> torch.Tensor:
    """int or integer tensor -> int64 tensor holding v mod 2^32."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK32
    return torch.tensor(int(v) & MASK32, dtype=torch.int64, device=device)


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors in [0, 2^32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def pcg4d(x, y, z, w):
    """PCG4D hash: four 32-bit counters -> four decorrelated 32-bit values.

    Arguments broadcast; ints are taken mod 2^32.  Returns int64 tensors in
    [0, 2^32) on the device of the first tensor argument."""
    device = next((v.device for v in (x, y, z, w)
                   if isinstance(v, torch.Tensor)), None)
    x, y, z, w = (as_u32(v, device) for v in (x, y, z, w))

    x = (x * _MUL + _ADD) & MASK32
    y = (y * _MUL + _ADD) & MASK32
    z = (z * _MUL + _ADD) & MASK32
    w = (w * _MUL + _ADD) & MASK32

    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32
    return x, y, z, w


def _to_unit_float(bits):
    """32-bit value -> float32 uniform in [0, 1) from its top 24 bits."""
    return (bits >> 8).to(torch.float32) * _INV_2POW24


def uniform4(pixel_id, sample_id, stream, seed):
    """Four uniforms in [0,1) for counter (pixel, sample, stream, seed)."""
    return tuple(_to_unit_float(v)
                 for v in pcg4d(pixel_id, sample_id, stream, seed))


# --- geometric sampling primitives (RTiOW samplers, reparameterized) -------


def random_unit_vector(u1, u2):
    """Uniform direction on the unit sphere from two uniforms -> [..., 3]."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cbrt(v):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(v) * torch.abs(v).pow(1.0 / 3.0)


def random_in_unit_sphere(u1, u2, u3):
    """Uniform point inside the unit sphere (metal fuzz)."""
    return random_unit_vector(u1, u2) * cbrt(u3)[..., None]


def random_in_unit_disk(u1, u2):
    """Uniform point in the unit disk (thin-lens aperture sampling)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi)
