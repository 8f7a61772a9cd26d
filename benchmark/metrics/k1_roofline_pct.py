"""k1_roofline_pct: dense K1's share of its roofline over the traced window.

The least time the card needs for the K1 launches the trace holds (the
frozen count of `brtbench/yardstick/forward_sweep.py`: every sphere's test
in every round the frames' paths take, plus shading and camera rays, at
the published H100 SXM float32 peak; operations bound it, bytes are
0.01% of it), over their device time from the profiler.  The rounds a path
takes are its own length, which every correct renderer of these inputs
shares: the mean over the checked pixels' paths, as the plain reference
traced them, times the paths of a frame.  None when no K1 launch was traced.
"""

from brtbench.yardstick.forward_sweep import forward_bound

KERNEL = "k1_render_kernel"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    rounds = run.rounds_per_path * run.paths_per_frame
    least, _ = forward_bound("k1", run.n_spheres, run.n_pix, run.spp,
                             run.depth, rounds)
    return 100.0 * least * launches / seconds
