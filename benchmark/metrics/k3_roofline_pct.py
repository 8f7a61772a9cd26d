"""k3_roofline_pct: K3's share of its roofline over the traced window of
the inverse cell.

The least time the card needs for the K3 launches the trace holds (each
replays one render's paths backward: the frozen count of `brtbench/
yardstick/replay.py`, from the rounds and hit bounces the checked pixels'
paths took as the plain reference traced them, times the paths of a
render), over their device time from the profiler.  None when no K3
launch was traced.
"""

from brtbench.yardstick.replay import replay_bound

KERNEL = "k3_replay_grad_kernel"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    least, _ = replay_bound(run.n_spheres, run.n_pix, run.spp,
                            run.rounds_per_path * run.paths_per_frame,
                            run.hits_per_path * run.paths_per_frame)
    return 100.0 * least * launches / seconds
