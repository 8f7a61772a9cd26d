"""The check that the process measured nothing of the JAX package.

A loaded module counts by its top-level name (the part before the first
dot), compared whole: `bevy_raytrace_tpu_torch` is the port and passes,
`bevy_raytrace_tpu` is the JAX package and does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bevy_raytrace_tpu"})


def forbidden_modules(names=None) -> list:
    """The sorted top-level names among `names` (default: `sys.modules`)
    that are in FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
