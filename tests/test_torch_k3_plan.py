"""K3's table modes on the host: the size rule that picks the shared-memory
or the global table (`kernels/replay_grad.py::table_plan`, a pure function
of the sphere count and what a block may hold), and the wrapper's refusals
of what its launcher does not take.  The kernel's two modes themselves run
only on a card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels import replay_grad as k3

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

# An H100's per-block opt-in shared memory (232,448 bytes) less K3's static
# shared memory (5,120 bytes: the camera slots and the staging areas, as
# ptxas reports them): what brt_k3_table_bytes_limit returns there.
H100_TABLE_LIMIT = 232_448 - 5_120
LAST_FIT = H100_TABLE_LIMIT // k3.ROW_BYTES  # 3,157 rows


@pytest.mark.parametrize("n_rows,mode", [
    (2, "shared"), (486, "shared"), (LAST_FIT, "shared"),
    (LAST_FIT + 1, "global"), (5000, "global")])
def test_table_plan_by_sphere_count(n_rows, mode):
    got, nbytes = k3.table_plan(n_rows, H100_TABLE_LIMIT)
    assert got == mode
    assert nbytes == (n_rows * 72 if mode == "shared" else 0)
    assert nbytes <= H100_TABLE_LIMIT


def test_table_plan_rejects_negative_sizes():
    with pytest.raises(ValueError, match="n_rows"):
        k3.table_plan(-1, H100_TABLE_LIMIT)
    with pytest.raises(ValueError, match="limit_bytes"):
        k3.table_plan(3, -1)


def _operands():
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    _, res, _ = k2.render_record(scene, cam, cfg)
    table, cam16 = k2._operands(scene, cam)
    return table, cam16, cfg, res, torch.zeros((cfg.height, cfg.width, 3))


def test_launch_rejects_an_unknown_table_mode():
    """The mode is checked before anything reaches the launcher."""
    table, cam16, cfg, res, g = _operands()
    for mode in ("texture", None, 1):
        with pytest.raises(ValueError, match="table_mode"):
            k3._launch(None, table, cam16, cfg, res, g, 0, 0, None,
                       table_mode=mode)


def test_replay_grad_refuses_devices_it_has_no_kernel_for():
    """CPU tensors run the twin; a device other than CPU or CUDA raises
    before any launcher argument is formed."""
    table, cam16, cfg, res, g = _operands()
    d_tbl, d_cam = k3.replay_grad(table, cam16, cfg, res, g)
    assert d_tbl.shape == table.shape and d_cam.shape == (16,)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3.replay_grad(table.to(meta), cam16.to(meta), cfg, res.to(meta),
                       g.to(meta))
