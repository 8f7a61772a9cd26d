"""Named, insertion-ordered material registry.

Mirror of `bevy_raytrace_tpu/scenes/registry.py`: insertion order defines
the material index, and `to_materials()` lowers the registry to the SoA
`Materials` table with the integer kind encoding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from bevy_raytrace_tpu_torch.core.types import (
    DIELECTRIC,
    LAMBERTIAN,
    METALLIC,
    Materials,
)
from bevy_raytrace_tpu_torch.device import resolve

_KINDS = {"lambertian": LAMBERTIAN, "metallic": METALLIC, "dielectric": DIELECTRIC}


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description."""

    kind: str  # "lambertian" | "metallic" | "dielectric"
    color: tuple = (1.0, 1.0, 1.0)
    fuzz: float = 0.0
    ior: float = 1.5

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown material kind {self.kind!r}")


class MaterialRegistry:
    """Insertion-ordered name -> MaterialSpec registry."""

    def __init__(self):
        self._materials: Dict[str, MaterialSpec] = {}

    def insert(self, name: str, spec: MaterialSpec) -> int:
        """Insert (or overwrite) a named material; returns its index."""
        self._materials[name] = spec
        return self.get_index_of(name)

    def lambertian(self, name, color) -> int:
        return self.insert(name, MaterialSpec("lambertian", tuple(color)))

    def metallic(self, name, color, fuzz=0.0) -> int:
        return self.insert(name, MaterialSpec("metallic", tuple(color), fuzz=fuzz))

    def dielectric(self, name, ior=1.5) -> int:
        return self.insert(name, MaterialSpec("dielectric", ior=ior))

    def get_index_of(self, name: str) -> int:
        """Index = insertion order."""
        return list(self._materials).index(name)

    def __len__(self):
        return len(self._materials)

    def __contains__(self, name):
        return name in self._materials

    def names(self):
        return list(self._materials)

    def to_materials(self, device=None) -> Materials:
        """Lower to the SoA table on `device` (None: the default device)."""
        device = resolve(device)
        specs = list(self._materials.values())
        if not specs:
            raise ValueError("empty material registry")
        arrays = (
            np.array([s.color for s in specs], np.float32),
            np.array([_KINDS[s.kind] for s in specs], np.int32),
            np.array([s.fuzz for s in specs], np.float32),
            np.array([s.ior for s in specs], np.float32),
        )
        return Materials(*(torch.from_numpy(a).to(device) for a in arrays))
