"""The port's RenderConfig equals the reference dataclass."""

import dataclasses

import pytest
import torch


import bevy_raytrace_tpu.config as ref
import bevy_raytrace_tpu_torch.config as port

torch.set_num_threads(2)


def test_fields_and_defaults_match_reference():
    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(port.RenderConfig) == spec(ref.RenderConfig)
    assert (port.EPSILON, port.VERY_FAR, port.DEFAULT_FOV) == (
        ref.EPSILON, ref.VERY_FAR, ref.DEFAULT_FOV)


@pytest.mark.parametrize("kw", [
    dict(samples_per_pixel=5, spp_chunk=2),
    dict(width=10, height=10, ray_chunk=7),
])
def test_validation_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        ref.RenderConfig(**kw)
    with pytest.raises(ValueError) as got:
        port.RenderConfig(**kw)
    assert str(got.value) == str(want.value)


def test_derived_properties_match_reference():
    kw = dict(width=320, height=180, samples_per_pixel=8, max_depth=3)
    a, b = ref.RenderConfig(**kw), port.RenderConfig(**kw)
    assert (a.num_pixels, a.rays_per_frame, a.aspect) == (
        b.num_pixels, b.rays_per_frame, b.aspect)
    assert dataclasses.asdict(b.replace(seed=7)) == dataclasses.asdict(
        a.replace(seed=7))
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.seed = 1
