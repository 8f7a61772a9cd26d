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

Table modes (`table_plan`, chosen by the sphere count alone): each block of
the kernel keeps a float64 copy of the table's 9 gradient columns in shared
memory and flushes it once ("shared"), unless that copy is larger than a
block may hold on the device, ~3,157 rows on an H100; then the adds go
straight to the output ("global").  Both are the kernel, counted apart
(the counter `k3.launches_global`).
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
from bevy_raytrace_tpu_torch.utils.spans import count
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

# The deepest path K3 replays: its per-thread state array holds this many
# bounces (csrc/k3_replay_grad.cu kMaxDepth).
MAX_DEPTH = 16
# Bytes of a block's table per sphere row: 9 float64 gradient columns.
ROW_BYTES = 9 * 8
TABLE_MODES = ("global", "shared")


def table_plan(n_rows: int, limit_bytes: int):
    """K3's table mode for a table of `n_rows` spheres -> (mode, bytes of
    dynamic shared memory a block takes): ("shared", n_rows * ROW_BYTES)
    when that fits `limit_bytes` (what a block may take for its table on the
    device, `brt_k3_table_bytes_limit`), else ("global", 0)."""
    if n_rows < 0 or limit_bytes < 0:
        raise ValueError(f"n_rows={n_rows} and limit_bytes={limit_bytes} "
                         f"must be >= 0")
    nbytes = n_rows * ROW_BYTES
    return ("shared", nbytes) if nbytes <= limit_bytes else ("global", 0)


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
def _k3_launcher():
    lib = build.load("k3_replay_grad")
    fn = lib.brt_k3_replay_grad
    vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_float)
    fn.argtypes = [vp, vp, vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, i32,
                   u32, u32, i32, f32, f32, f32, i32, i32, vp]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _table_limit(index: int) -> int:
    """Bytes of shared memory a K3 block may take for its table on CUDA
    device `index`."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.load("k3_replay_grad").brt_k3_table_bytes_limit(
            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"K3's shared-memory query failed with "
                           f"cudaError_t {err}")
    return out.value


def _table_mode(table) -> str:
    """`table_plan`'s mode for a CUDA table on its device."""
    index = table.device.index
    return table_plan(table.shape[0], _table_limit(
        torch.cuda.current_device() if index is None else index))[0]


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
    layout; in stripe mode the stripe's partial sums.  CUDA tensors launch
    the kernel (and count one in the counter `k3.launches`, and in
    `k3.launches_global` when the table is too large for a block's shared
    memory); CPU tensors run `replay_grad_plain`; any other device
    raises.  Paths deeper than MAX_DEPTH bounces raise on every device."""
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
    mode = _table_mode(table)
    out = _launch(table, cam16, config, res, g, frame, sample_base, res2,
                  base, n, mode)
    count("k3.launches")
    if mode == "global":
        count("k3.launches_global")
    return out


def _launch(table, cam16, config: RenderConfig, res, g, frame: int,
            sample_base: int, res2, pixel_base: int = 0, num_local=None,
            table_mode: str = "global"):
    """Launches K3 on checked CUDA operands; the pixels are [pixel_base,
    pixel_base + num_local), the whole frame when `num_local` is None.
    `table_mode` is one of TABLE_MODES: `replay_grad` passes `table_plan`'s,
    the checks on the card force one to hold the two against each other."""
    if table_mode not in TABLE_MODES:
        raise ValueError(f"table_mode must be one of {TABLE_MODES}, got "
                         f"{table_mode!r}")
    n = config.num_pixels if num_local is None else num_local
    device = table.device
    table, cam16 = table.detach(), cam16.detach()
    g = g.detach().contiguous()
    edge = config.edge_softness > 0.0
    # float64 sums: see csrc/k3_replay_grad.cu "Accumulation".
    d_tbl = torch.zeros(table.shape, dtype=torch.float64, device=device)
    d_cam = torch.zeros((16,), dtype=torch.float64, device=device)
    launch = _k3_launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(table.data_ptr(), cam16.data_ptr(), res.data_ptr(),
                     res2.data_ptr() if edge else 0,
                     2 if res.dtype == torch.int16 else 4, g.data_ptr(),
                     d_tbl.data_ptr(), d_cam.data_ptr(), table.shape[0],
                     TABLE_MODES.index(table_mode), pixel_base, n,
                     config.samples_per_pixel, frame_seed(config, frame),
                     sample_base, config.max_depth, config.t_min,
                     config.edge_softness,
                     float(np.float32(1.0 / config.samples_per_pixel)),
                     config.width, config.height, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError_t {err}")
    return d_tbl.to(torch.float32), d_cam.to(torch.float32)
