"""K4, the recording forward on the dense sweep: its wrapper, its plain
PyTorch twin, its host side.

`sweep_record_frame` is the wrapper of the CUDA kernel
`csrc/k4_sweep_record.cu`, which replaces
`bevy_raytrace_tpu/kernels/sweep_record.py::_make_kernel` (the TPU's
dense-sweep recorder, launched by `render_sweep_record`).  It is K1's body
(`kernels/render_lanes.py`: centered quadratic, `disc * rsqrt(disc)`, no
`t_max` test, exact winner-t recompute) with K2's recording store
(`kernels/record.py`: `res[s, b, pixel]`, -1 for a miss or a dead path, the
runner-up in `res2`), in stripe mode throughout: thread i renders the
absolute pixel `pixel_base + i`.  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs `sweep_record_frame_plain`, the twin in this
module.  The kernel is bound by fp32 instruction throughput in the sweep,
not by bytes.  Like K1 it refills each thread with its pixel's next sample
when a path ends (one loop over rounds), and it has K1's two table modes
(`kernels/common.py::forward_table_plan`: the sphere rows staged in shared
memory, or read from device memory above the plan's limit, counted in
`sweep_record_frame.launches_global`), with the same bits in both.

Host side, by the reference's name: `render_sweep_record(scene, camera,
config, frame, sample_base, record_second, pixel_base, num_local)` ->
`(img, res[, res2])`, residuals in the UNPERMUTED scene order.

Deliberate divergences from the reference:
  * no 1,024-slot cap (`IDX_BITS`) and no 2^24-pixel guard: the nearest hit
    is a (t, index) pair, pixel ids are integers, and residuals turn int32
    above 32,767 spheres as K2's do;
  * near-ties between spheres break on the full float32 t (lowest index on
    an exact tie), where the reference's packed key compares t truncated to
    22 bits; the runner-up follows K2's rule on the exact t as well;
  * residuals come back [spp, max_depth, npix], not padded to whole tiles;
  * the TPU tiling options (tile_rows, sphere_chunk, interpret) do not
    exist.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.common import (
    FORWARD_TABLE_MODES,
    check_table_mode,
    forward_table_mode,
)
from bevy_raytrace_tpu_torch.kernels.record import (
    _LANES,
    _PLAIN_WORKSPACE,
    _check_frame,
    _operands,
    _stripe,
    residual_dtype,
)
from bevy_raytrace_tpu_torch.kernels.render_lanes import _plain_chunk
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed


def _sweep_tables(table):
    """[S, 11] `sphere_table` -> (geom [S', 4], attr [S', 8]) float32: K1's
    tables (`render_lanes._scene_tables`) from the table's rows.

    geom row: (cx, cy, cz, r^2).  attr row: (1/r, albedo r, g, b, kind,
    fuzz, ior, 0).  An empty scene gets one row that no ray can hit
    (r^2 = -1)."""
    if table.shape[0] == 0:
        geom = table.new_tensor([[0.0, 0.0, 0.0, -1.0]])
        return geom, table.new_tensor([[1.0, 0, 0, 0, 0, 0, 1.0, 0]])
    r = table[:, 3]
    geom = torch.cat([table[:, 0:3], (r * r)[:, None]], dim=1)
    attr = torch.cat([(1.0 / r)[:, None], table[:, 4:10],
                      torch.zeros_like(r)[:, None]], dim=1)
    return geom.contiguous(), attr.contiguous()


# --- the plain twin -----------------------------------------------------


@torch.no_grad()
def sweep_record_frame_plain(table, cam16, config: RenderConfig,
                             frame: int = 0, sample_base: int = 0,
                             record_second: bool = False, pixel_base=None,
                             num_local=None):
    """K4 in tensor ops, on any device: the same contract as
    `sweep_record_frame`.

    K1's twin (`render_lanes._plain_chunk`, chunked over pixels) with its
    recording on.  The kernel's sequential nearest-hit rule becomes a
    first-index min over the valid roots, its runner-up rule the
    first-index min over the valid roots farther than the winner."""
    base, n = _stripe(config, pixel_base, num_local)
    geom, attr = _sweep_tables(table.detach())
    cam = cam16.detach()
    dev = table.device
    spp, depth = config.samples_per_pixel, config.max_depth
    rdt = residual_dtype(table.shape[0])
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    res = torch.empty((spp, depth, n), dtype=rdt, device=dev)
    res2 = (torch.empty((spp, depth, n), dtype=rdt, device=dev)
            if record_second else None)
    budget = _PLAIN_WORKSPACE.get(dev.type, _PLAIN_WORKSPACE["cpu"])
    chunk = max(budget // geom.shape[0] // _LANES, 1) * _LANES
    seed = frame_seed(config, frame)
    pids = torch.arange(base, base + n, dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        fb[lo:hi], _, _ = _plain_chunk(
            geom, attr, cam, pids[lo:hi], seed, sample_base, spp, depth,
            config.t_min, config.width, config.height, res[:, :, lo:hi],
            None if res2 is None else res2[:, :, lo:hi])
    img = fb / spp
    if num_local is None:
        img = img.reshape(config.height, config.width, 3)
    return img, res, res2


# --- the wrapper ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k4_launcher():
    lib = build.load("k4_sweep_record")
    fn = lib.brt_k4_sweep_record
    vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_float)
    fn.argtypes = [vp, vp, i32, vp, i32, i32, vp, vp, vp, i32, i32, u32, u32,
                   i32, i32, f32, i32, i32, i32, vp]
    fn.restype = i32
    return fn


def sweep_record_frame(table, cam16, config: RenderConfig, frame: int = 0,
                       sample_base: int = 0, record_second: bool = False,
                       pixel_base=None, num_local=None, table_mode=None):
    """K4: render and record `config`'s frame, or one stripe of it, from the
    sphere table and packed camera.

    table [S, 11] float32 is `sphere_table(...)` (its values only: no
    gradient flows through here); cam16 [16] float32 is `Camera.pack()`.
    Samples are [sample_base, sample_base + spp).  With `num_local` the
    pixels are [pixel_base, pixel_base + num_local) and the image is the
    flat [num_local, 3] stripe; else the whole frame, [H, W, 3].  Returns
    (img, res, res2): res [spp, max_depth, npix] int16/int32 winner indices
    in the table's order, res2 the runner-ups when `record_second` (else
    None).  `table_mode` None takes `forward_table_plan`'s mode; "shared" or
    "global" forces one (a shared table too large for a block raises).

    CUDA tensors launch the kernel (and count one in
    `sweep_record_frame.launches`, and in `sweep_record_frame.launches_global`
    when the rows are read from device memory); CPU tensors run
    `sweep_record_frame_plain`; any other device raises."""
    table, cam16 = table.detach(), cam16.detach()
    check_table_mode(table_mode)
    _check_frame(table, cam16, config, sample_base)
    base, n = _stripe(config, pixel_base, num_local)
    device = table.device
    if device.type == "cpu":
        return sweep_record_frame_plain(table, cam16, config, frame,
                                        sample_base, record_second,
                                        pixel_base, num_local)
    if device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA (or its twin on CPU), not {device}")
    mode = forward_table_mode("k4_sweep_record", device,
                              max(table.shape[0], 1), table_mode)
    geom, attr = _sweep_tables(table)
    spp, depth = config.samples_per_pixel, config.max_depth
    rdt = residual_dtype(table.shape[0])
    img = torch.empty((n, 3), dtype=torch.float32, device=device)
    res = torch.empty((spp, depth, n), dtype=rdt, device=device)
    res2 = (torch.empty((spp, depth, n), dtype=rdt, device=device)
            if record_second else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _k4_launcher()(
            geom.data_ptr(), attr.data_ptr(), geom.shape[0], cam16.data_ptr(),
            base, n, img.data_ptr(), res.data_ptr(),
            0 if res2 is None else res2.data_ptr(),
            2 if rdt == torch.int16 else 4, 1 + int(record_second),
            frame_seed(config, frame), sample_base, spp, depth, config.t_min,
            config.width, config.height, FORWARD_TABLE_MODES.index(mode),
            stream)
    if err != 0:
        raise RuntimeError(f"K4 launch ({mode} table) failed with "
                           f"cudaError_t {err}")
    sweep_record_frame.launches += 1
    sweep_record_frame.launches_global += int(mode == "global")
    if num_local is None:
        img = img.reshape(config.height, config.width, 3)
    return img, res, res2


sweep_record_frame.launches = 0
sweep_record_frame.launches_global = 0


# --- host side ----------------------------------------------------------


def render_sweep_record(scene, camera, config: RenderConfig, frame: int = 0,
                        sample_base: int = 0, record_second: bool = False,
                        pixel_base=None, num_local=None):
    """Recording forward on the dense sweep (K4) -> (img, res[, res2]).

    The port of the reference's `render_sweep_record`, with its returns: a
    pair, or a triple with `record_second`.  img is [H, W, 3], or the flat
    [num_local, 3] stripe in stripe mode; residuals are [spp, max_depth,
    npix] sphere indices in the UNPERMUTED scene order (int16 when the
    scene has at most 32,767 spheres, else int32; -1 = no hit)."""
    table, cam16 = _operands(scene, camera)
    img, res, res2 = sweep_record_frame(table, cam16, config, frame,
                                        sample_base, record_second,
                                        pixel_base, num_local)
    return (img, res, res2) if record_second else (img, res)
