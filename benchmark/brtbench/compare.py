"""The comparison that decides `correct` for rendered frames.

Two renders of the same paths agree to float32 rounding on almost every
pixel; where two implementations round differently, a borderline discrete
choice (a grazing hit, a near tie, the Schlick coin) flips on a rare path
and swaps in another valid sample.  So a run is judged on the checked
pixels' median error, the share of pixels off by more than `bad_tol`, and
the mean bias per channel.  A pixel's error is its largest channel error.
Each number has its own limit, in the cell's file.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("median_err", "bad_frac", "mean_bias")


def image_stats(prog: torch.Tensor, ref: torch.Tensor, bad_tol: float):
    """prog, ref: [n, 3] pixel values -> {median_err, bad_frac, mean_bias,
    max_err, finite}."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    d = prog - ref
    err = d.abs().amax(dim=1)
    return {
        "median_err": float(err.median()),
        "bad_frac": float((err > bad_tol).to(torch.float64).mean()),
        "mean_bias": float(d.mean(dim=0).abs().max()),
        "max_err": float(err.max()),
        "finite": bool(torch.isfinite(prog).all()),
    }


def judge(stats: dict, limits: dict) -> tuple:
    """-> (correct, [(name, value, limit)]) for each number compared.  A
    non-finite output or value fails."""
    rows = [(k, stats[k], float(limits[k])) for k in NUMBERS]
    ok = stats["finite"] and all(
        math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
