"""A session of the port's plain paths for the CPU: `Renderer("cuda")`'s
frame schedule (a probe frame, then the cached cost-balanced permutation)
through `render_probed` and `render_mxu` on CPU tensors, which run K1's
plain twin.  The card's session refuses the CPU."""


class TwinSession:
    PROBE_SPP = 16

    def __init__(self, config, device):
        self.config = config
        self.frame = 0
        self._perm = None

    def render_frame(self, scene, camera):
        from bevy_raytrace_tpu_torch.kernels.render_lanes import (
            render_mxu,
            render_probed,
        )

        if self._perm is None:
            img, self._perm = render_probed(scene, camera, self.config,
                                            self.frame, self.PROBE_SPP)
        else:
            img = render_mxu(scene, camera, self.config, self.frame,
                             perm=self._perm)
        self.frame += 1
        return img


def no_sync():
    return None


def tiny_cell(name, width=32, height=24, spp=None, frames=2, pixels=128):
    """The cell `name` of BENCHMARK.json at a size the CPU holds."""
    import dataclasses

    from brtbench import spec

    cell = spec.load_cell(name)
    config = dict(cell.config, width=width, height=height)
    mix = dict(cell.traffic)
    if spp is not None:
        mix["samples_per_pixel"] = spp
    check = dict(cell.check, frames=frames, pixels=pixels)
    return dataclasses.replace(cell, config=config, traffic=mix, check=check)
