"""k2_roofline_pct: K2's share of its roofline over the traced window of
the inverse cell.

The least time the card needs for the K2 launches the trace holds (each
records one render: the frozen count of `brtbench/yardstick/
forward_sweep.py` for "k2" with two int16 residual streams, the winner and
the runner-up, counted as the brute-force loop: every sphere's test in
every round the render's paths take, whatever culls it), over their device
time from the profiler.  The rounds are the paths' own lengths: the mean
over the checked pixels' paths, as the plain reference traced them, times
the paths of a render.  None when no K2 launch was traced.
"""

from brtbench.yardstick.forward_sweep import forward_bound

KERNEL = "k2_record_kernel"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    rounds = run.rounds_per_path * run.paths_per_frame
    least, _ = forward_bound("k2", run.n_spheres, run.n_pix, run.spp,
                             run.depth, rounds, res_streams=2)
    return 100.0 * least * launches / seconds
