"""K3, the replay-gradient backward of the fast gradient path: its wrapper
and its plain PyTorch twin.

`replay_grad` is the wrapper of the CUDA kernel `csrc/k3_replay_grad.cu`,
which replaces `bevy_raytrace_tpu/kernels/replay_grad.py::_make_kernel` (the
TPU's fused backward).  From the residuals K2 recorded and the image
cotangent it returns the cotangents of the sphere table and of the packed
camera, replaying every path with no sphere search.  On CUDA tensors it
launches the kernel or raises; on CPU tensors it runs `replay_grad_plain`:
autograd of the PyTorch replay (`inverse/fast_grad.py::replay_paths`), the
function whose adjoint the kernel computes by hand.

Stripe mode (`pixel_base`, `num_local`, as the reference's
`replay_grad.py:405-433`): `g` is the flat [num_local, 3] stripe cotangent
and the residuals are the stripe's [spp, depth, num_local]; the paths'
RNG counters and camera rays come from the absolute pixel ids, and the
returned cotangents are the stripe's partial sums (`inverse/shard_grad.py`
all-reduces them).  The TPU's bf16 limb split and one-hot MXU contraction do
not exist here: rows are read and cotangents added by index.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.record import _check_frame, _stripe
from bevy_raytrace_tpu_torch.kernels.render_lanes import _check
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

# The deepest path K3 replays: its per-thread state array holds this many
# bounces (csrc/k3_replay_grad.cu kMaxDepth).
MAX_DEPTH = 16


def _check_operands(table, cam16, config: RenderConfig, res, g,
                    sample_base: int, res2, pixel_base, num_local):
    """Checks K3's operands -> (first absolute pixel id, pixel count)."""
    _check_frame(table, cam16, config, sample_base)
    base, n = _stripe(config, pixel_base, num_local)
    device = table.device
    shape = (config.samples_per_pixel, config.max_depth, n)
    for name, r in (("res", res), ("res2", res2)):
        if r is None:
            continue
        if r.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"{name} must be int16 or int32, got {r.dtype}")
        _check(name, r, r.dtype, shape, device)
    if res2 is not None and res2.dtype != res.dtype:
        raise TypeError("res and res2 must share one dtype")
    if config.edge_softness > 0.0 and res2 is None:
        raise ValueError(
            "edge_softness > 0 requires runner-up residuals (res2) — "
            "record the forward with record_second=True")
    g_shapes = ([(n, 3)] if num_local is not None
                else [(config.height, config.width, 3), (n, 3)])
    if tuple(g.shape) not in g_shapes:
        raise ValueError(f"g must have shape {g_shapes[0]}, got "
                         f"{tuple(g.shape)}")
    if g.device != device or g.dtype != torch.float32:
        raise ValueError("g must be float32 on the table's device")
    return base, n


def replay_grad_plain(table, cam16, config: RenderConfig, res, g,
                      frame: int = 0, sample_base: int = 0, res2=None,
                      pixel_base=None, num_local=None):
    """K3's contract through autograd of the PyTorch replay, on any device
    (each bounce checkpointed when storing the graph would pass 4 GiB)."""
    from bevy_raytrace_tpu_torch.inverse.fast_grad import _replay_sum

    base, n = _check_operands(table, cam16, config, res, g, sample_base,
                              res2, pixel_base, num_local)
    with torch.enable_grad():
        tbl = table.detach().requires_grad_(True)
        cam = cam16.detach().requires_grad_(True)
        camera = Camera.from_packed(cam, device=cam.device)
        fb = _replay_sum(camera, config, res, tbl, frame_seed(config, frame),
                         sample_base,
                         res2 if config.edge_softness > 0.0 else None,
                         pixel_base=base, num_local=n)
        img = fb / config.samples_per_pixel
        d_tbl, d_cam = torch.autograd.grad(
            img, (tbl, cam), g.reshape(n, 3), allow_unused=True)
    if d_tbl is None:
        d_tbl = torch.zeros_like(table)
    if d_cam is None:
        d_cam = torch.zeros_like(cam16)
    return d_tbl, d_cam


@functools.lru_cache(maxsize=None)
def _k3_launcher(defines: tuple = ()):
    """K3's launcher; `defines` select a measurement probe's build (see
    csrc/k3_replay_grad.cu)."""
    lib = build.load("k3_replay_grad", defines)
    fn = lib.brt_k3_replay_grad
    vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_float)
    fn.argtypes = [vp, vp, vp, vp, i32, vp, vp, vp, i32, i32, i32, u32, u32,
                   i32, f32, f32, f32, i32, i32, vp]
    fn.restype = i32
    return fn


def replay_grad(table, cam16, config: RenderConfig, res, g, frame: int = 0,
                sample_base: int = 0, res2=None, pixel_base=None,
                num_local=None):
    """K3: cotangents of the recorded render w.r.t. the table and camera.

    table [S, 11] float32 is the `sphere_table` the residual indices refer
    to; cam16 [16] float32 is `Camera.pack()`; res (and res2 when
    `config.edge_softness > 0`) [spp, max_depth, H*W] int16/int32 come from
    K2 or K4 with the same config, frame and sample_base; g [H, W, 3]
    float32 is the cotangent of the IMAGE, the mean over samples (1/spp is
    folded in).  In stripe mode (`num_local`, with `pixel_base` the
    stripe's first absolute pixel id, both as given to the recorder) res and
    res2 are [spp, max_depth, num_local] and g is the flat [num_local, 3]
    stripe cotangent.

    Returns (d_table [S, 11], d_cam [16]) float32, d_cam in `pack()`'s
    layout; in stripe mode the stripe's partial sums.  CUDA tensors launch the kernel (and count one in
    `replay_grad.launches`); CPU tensors run `replay_grad_plain`; any other
    device raises.  Paths deeper than MAX_DEPTH bounces raise on every
    device."""
    base, n = _check_operands(table, cam16, config, res, g, sample_base,
                              res2, pixel_base, num_local)
    if config.max_depth > MAX_DEPTH:
        raise ValueError(f"max_depth={config.max_depth} exceeds K3's "
                         f"MAX_DEPTH={MAX_DEPTH}")
    device = table.device
    if device.type == "cpu":
        return replay_grad_plain(table, cam16, config, res, g, frame,
                                 sample_base, res2, pixel_base, num_local)
    if device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA (or its twin on CPU), not {device}")
    out = _launch(_k3_launcher(), table, cam16, config, res, g, frame,
                  sample_base, res2, base, n)
    replay_grad.launches += 1
    return out


replay_grad.launches = 0


def _launch(launch, table, cam16, config: RenderConfig, res, g, frame: int,
            sample_base: int, res2, pixel_base: int = 0, num_local=None):
    """Runs `launch` (a `_k3_launcher`) on checked CUDA operands; the
    pixels are [pixel_base, pixel_base + num_local), the whole frame when
    `num_local` is None."""
    n = config.num_pixels if num_local is None else num_local
    device = table.device
    table, cam16 = table.detach(), cam16.detach()
    g = g.detach().contiguous()
    edge = config.edge_softness > 0.0
    # float64 sums: see csrc/k3_replay_grad.cu "Accumulation".
    d_tbl = torch.zeros(table.shape, dtype=torch.float64, device=device)
    d_cam = torch.zeros((16,), dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(table.data_ptr(), cam16.data_ptr(), res.data_ptr(),
                     res2.data_ptr() if edge else 0,
                     2 if res.dtype == torch.int16 else 4, g.data_ptr(),
                     d_tbl.data_ptr(), d_cam.data_ptr(), pixel_base, n,
                     config.samples_per_pixel, frame_seed(config, frame),
                     sample_base, config.max_depth, config.t_min,
                     config.edge_softness,
                     float(np.float32(1.0 / config.samples_per_pixel)),
                     config.width, config.height, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError_t {err}")
    return d_tbl.to(torch.float32), d_cam.to(torch.float32)
