"""The device the package's entry points work on when the caller names none.

Every constructor and renderer of the package (`scenes.*`, `Camera.look_at`,
`make_scene`, `interop.*`, `Renderer`, `load_checkpoint`, `make_mesh`) takes
`device=None`, which means `default_device()`: the current CUDA device.
There is no silent fallback: without a CUDA device `default_device()`
raises.  A caller who wants the CPU says so, either per call
(`device="cpu"`) or once per process with `set_default_device("cpu")`, as
the CPU tests do.  `smi_line` names the card a measurement ran on.
"""

from __future__ import annotations

import subprocess

import torch

_OVERRIDE = None


def set_default_device(device) -> None:
    """Make `device` what `default_device()` returns in this process;
    `None` restores the rule (the current CUDA device, or an error)."""
    global _OVERRIDE
    _OVERRIDE = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The CUDA device the package runs on, or the one the caller set with
    `set_default_device`.  Raises when neither exists."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bevy_raytrace_tpu_torch runs on a CUDA device and found none; "
            'pass device="cpu" (or call set_default_device("cpu")) to run '
            "the plain PyTorch paths on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """`device`, or the default device when it is None."""
    return default_device() if device is None else torch.device(device)


def smi_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them
    ("NVIDIA H100 80GB HBM3, 700.00 W"): what a measurement states beside
    its numbers, since a card set below its maximum runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
