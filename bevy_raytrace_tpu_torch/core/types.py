"""Rays, hits, materials and scenes as dataclasses of tensors.

Mirror of `bevy_raytrace_tpu/core/types.py`: the same fields, shapes and
dtypes (float32 / int32, batched on the leading axis), as plain dataclasses
with a `.to(device)` in place of JAX pytrees.
"""

from __future__ import annotations

import dataclasses

import torch

from bevy_raytrace_tpu_torch.device import resolve

# Material kind encoding (the reference's integer encoding).
LAMBERTIAN = 0
METALLIC = 1
DIELECTRIC = 2


class _TensorFields:
    """`.to(device)` for a dataclass whose fields are tensors or such
    dataclasses."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Ray(_TensorFields):
    """A batch of rays, SoA: origin [R,3], dir [R,3] (unit length)."""

    origin: torch.Tensor
    dir: torch.Tensor


@dataclasses.dataclass
class Hit(_TensorFields):
    """A batch of nearest-hit records.

    t [R] (t_max on miss), point [R,3], normal [R,3] (faces against the
    incident ray), front_face [R] bool, material [R] int32, hit [R] bool,
    edge_m2 [R]: silhouette margin 1 - (b_perp/r)^2 of the hit sphere
    (1 on miss).
    """

    t: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    front_face: torch.Tensor
    material: torch.Tensor
    hit: torch.Tensor
    edge_m2: torch.Tensor


@dataclasses.dataclass
class Materials(_TensorFields):
    """Material table, SoA: albedo [M,3], kind [M] int32, fuzz [M], ior [M]."""

    albedo: torch.Tensor
    kind: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


@dataclasses.dataclass
class Scene(_TensorFields):
    """Sphere scene, SoA, plus its material table.

    centers [N,3], radii [N] (a negative radius flips the normal inward:
    the RTiOW hollow-glass trick), material_id [N] int32, materials.
    """

    centers: torch.Tensor
    radii: torch.Tensor
    material_id: torch.Tensor
    materials: Materials

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def gather_material(self, mat_idx):
        """Per-ray material attributes for material indices [R]."""
        m = self.materials
        mat_idx = mat_idx.long()
        return m.albedo[mat_idx], m.kind[mat_idx], m.fuzz[mat_idx], m.ior[mat_idx]


def _tensor(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


def make_scene(centers, radii, material_id, albedo, kind, fuzz, ior,
               device=None) -> Scene:
    """Build a Scene from array-likes with dtype normalization, on `device`
    (None: `device.default_device()`, the CUDA device)."""
    device = resolve(device)
    f32, i32 = torch.float32, torch.int32
    return Scene(
        centers=_tensor(centers, f32, device).reshape(-1, 3),
        radii=_tensor(radii, f32, device).reshape(-1),
        material_id=_tensor(material_id, i32, device).reshape(-1),
        materials=Materials(
            albedo=_tensor(albedo, f32, device).reshape(-1, 3),
            kind=_tensor(kind, i32, device).reshape(-1),
            fuzz=_tensor(fuzz, f32, device).reshape(-1),
            ior=_tensor(ior, f32, device).reshape(-1),
        ),
    )
