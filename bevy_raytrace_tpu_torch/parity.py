"""Image parity thresholds and the comparison both the tests and
`chip_smoke.py` use (numpy only).

Two renders of the same paths agree to float32 noise on almost every pixel.
Where two implementations round differently (fma contraction, a
transcendental's last ulp), a borderline DISCRETE choice (hit or miss at a
tangency, a near-tie between spheres, the Schlick coin) flips on a rare
pixel and swaps in another valid Monte-Carlo sample.  So the checks bound
the typical pixel, the share of pixels off by more than a tolerance, and the
mean bias; a wrong kernel fails all three by orders of magnitude.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Thresholds:
    median: float  # the median pixel error is at most this
    bad_tol: float  # a pixel is "off" when its error exceeds this ...
    bad_frac: float  # ... and at most this share of pixels may be off
    mean_bias: float  # |mean(a - b)| per channel is at most this


# The bench's compiled-parity gate (bench.py VERIFY_*): for two compiled
# implementations, which round differently.
COMPILED = Thresholds(median=1e-5, bad_tol=1e-2, bad_frac=0.02,
                      mean_bias=5e-4)
# The JAX package's interpret-mode kernel tests (tests/test_mxu.py): for
# two implementations of the same arithmetic on one CPU.
INTERPRET = Thresholds(median=1e-6, bad_tol=1e-4, bad_frac=0.0005,
                       mean_bias=5e-4)


def compare(a, b, th: Thresholds) -> dict:
    """Compare images [..., 3] -> stats and `ok` under `th`.

    A pixel's error is its largest channel error."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = a - b
    err = np.abs(d).max(axis=-1)
    stats = {
        "median": float(np.median(err)),
        "bad_frac": float((err > th.bad_tol).mean()),
        "mean_bias": float(np.abs(d.reshape(-1, d.shape[-1]).mean(axis=0)).max()),
        "max_abs_err": float(err.max()),
        "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
    }
    stats["ok"] = (stats["finite"] and stats["median"] <= th.median
                   and stats["bad_frac"] <= th.bad_frac
                   and stats["mean_bias"] <= th.mean_bias)
    return stats
