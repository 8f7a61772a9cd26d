"""The process group as a ("hosts", "chips") mesh, and multi-host bring-up.

Mirror of `bevy_raytrace_tpu/shard/mesh.py`.  The parallelism axis is
ray/tile data parallelism: every device renders one contiguous stripe of
pixels, the scene (a few KB) is replicated, and gradients of the replicated
scene parameters are summed over the devices (`shard/render_sharded.py`,
`inverse/shard_grad.py`).

One process per device is the PyTorch form of the JAX device mesh: where
JAX runs one program over all the devices of a `Mesh` under `shard_map`,
here every device has its own process in one `torch.distributed` group, and
a `Mesh` is that process's view of the group: the mesh's shape, this
process's place in it and its device.  Pixels are sharded over both axes
flattened in hosts-major order: rank = host * chips + chip.  On one host the
"hosts" axis has size 1; the same program runs on several hosts after
`initialize_multihost()`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from bevy_raytrace_tpu_torch.device import resolve

RAY_AXES = ("hosts", "chips")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of the ("hosts", "chips") mesh.

    hosts, chips: the mesh's shape (hosts * chips == world_size).  host,
    chip: this process's coordinates.  rank: its flattened hosts-major
    rank, host * chips + chip: the index of its pixel stripe.  group: the
    `torch.distributed` process group (None for the single-process mesh of
    a program that initialized no group; collectives are then the
    identity).  device: where this rank's tensors live."""

    hosts: int
    chips: int
    host: int
    chip: int
    world_size: int
    group: object
    device: torch.device

    @property
    def rank(self) -> int:
        return self.host * self.chips + self.chip

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group."""
        return self.group is not None


def make_mesh(hosts=None, device=None) -> Mesh:
    """The ("hosts", "chips") mesh over the processes of the world group (a
    single-process mesh when `torch.distributed` is not initialized).

    `hosts` is the host-axis size (default 1: every rank a chip of one
    host); the world size must divide by it.  A process's coordinates are
    (rank // chips, rank % chips), so consecutive ranks are the chips of
    one host.  `device=None` is the default device (the current CUDA
    device)."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, n, rank = None, 1, 0
    hosts = 1 if hosts is None else int(hosts)
    if hosts < 1 or n % hosts != 0:
        raise ValueError(f"{n} devices not divisible by {hosts} hosts")
    chips = n // hosts
    return Mesh(hosts=hosts, chips=chips, host=rank // chips,
                chip=rank % chips, world_size=n, group=group,
                device=resolve(device))


def initialize_multihost(coordinator_address, num_processes: int,
                         process_id: int, backend=None, device=None):
    """Bring up `torch.distributed` for this process: one process per
    device, `num_processes` in all, this one `process_id`.

    `coordinator_address` is "host:port" (or a full init method such as
    "tcp://host:port") of rank 0.  The backend is `nccl` when this rank's
    device is CUDA and `gloo` when the caller asked for the CPU
    (`device="cpu"` or `set_default_device("cpu")`).  On CUDA the process
    takes the device `process_id % torch.cuda.device_count()` unless
    `device` names an index.  Call it once per process, before
    `make_mesh()`."""
    dev = resolve(device)
    kwargs = {}
    if dev.type == "cuda":
        index = (dev.index if device is not None and dev.index is not None
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    address = str(coordinator_address)
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
