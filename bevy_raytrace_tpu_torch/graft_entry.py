"""Two entry points that check the package from outside: a single-device
forward step, and a multi-device dry run of the whole training step.

Counterpart of the repository's `__graft_entry__.py`.

entry()             -> (fn, example_args): the forward render step on the
                       flagship model, the wavefront path trace of the RTiOW
                       final scene at 400x224, 4 spp, depth 8;
                       `fn(*example_args)` is the image.
dryrun_multichip(n) -> starts n processes, one per device, in one
                       `torch.distributed` group arranged as a ("hosts",
                       "chips") mesh, and runs in each one FULL training
                       step (sharded render -> two-sample cross loss ->
                       gradient of the replicated scene parameters, summed by
                       the backward's all-reduce -> Adam update) and one
                       sharded fast-gradient step at tiny shapes
                       (`shard.worker.dryrun_step`).

Where the JAX package runs one program over a device mesh, the port is one
process per device, so the dry run spawns `python -m
bevy_raytrace_tpu_torch.shard.worker --dryrun` once per rank: on the CUDA
devices over nccl, or with `device="cpu"` on the CPU over gloo.
"""

from __future__ import annotations


def entry(device=None):
    """(fn, (scene, camera)) on `device` (None: the CUDA device)."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.scenes import (
        rtiow_final_camera,
        rtiow_final_scene,
    )
    from bevy_raytrace_tpu_torch.wavefront.render import render

    config = RenderConfig(
        width=400, height=224, samples_per_pixel=4, max_depth=8, spp_chunk=4
    )
    scene, _ = rtiow_final_scene(seed=0, device=device)
    camera = rtiow_final_camera(config.aspect, device=device)

    @torch.no_grad()
    def fn(scene, camera):
        return render(scene, camera, config)

    return fn, (scene, camera)


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0):
    """Run the dry run on `n_devices` ranks -> their reports (one dict a
    rank: the loss, the largest gradients, the mesh), or raise with the
    failing rank's output.  `hosts` is 2 when `n_devices` is even and above
    1, as the reference arranges its mesh."""
    import torch

    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.shard.worker import launch_ranks

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    dev = resolve(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} CUDA devices, found "
                         f"{torch.cuda.device_count()}")
    hosts = 2 if n % 2 == 0 and n > 1 else 1
    return launch_ranks(n, dev, ["--dryrun"], hosts, timeout)
