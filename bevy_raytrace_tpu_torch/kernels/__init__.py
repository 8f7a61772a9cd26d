"""Hand-written CUDA kernels (sources in `csrc/`), their wrappers and their
plain PyTorch twins: `render_lanes` (K1, the forward render), `record` (K2,
the recording forward), `replay_grad` (K3, the replay gradient) and
`sweep_record` (K4, the recording forward on the dense sweep); `clusters`
plans K2's culled traversal; `build` compiles them.  Nothing is built at
import time.  The reference's package-level names are re-exported:
`render_pallas` (K2's render) and `cluster_scene` / `ClusterPlan`."""
from bevy_raytrace_tpu_torch.kernels.clusters import ClusterPlan, cluster_scene
from bevy_raytrace_tpu_torch.kernels.record import render_pallas

__all__ = ["render_pallas", "cluster_scene", "ClusterPlan"]
