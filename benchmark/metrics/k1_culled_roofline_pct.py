"""k1_culled_roofline_pct: culled K1's share of its roofline over the traced
window.

The least time the card needs for the `k1_culled_kernel` launches the
trace holds (the count of `brtbench/yardstick/culled_sweep.py`: every
chunk's bound test in every round, the member tests of the chunks each
round's segment to its nearest hit enters, plus shading and camera rays,
at the published H100 SXM float32 peak), over their device time from the
profiler.  The counts are means over the paths the plain reference traces
for a sample of the checked pixels (the `session_culled` runner's
`culled_rounds_per_path` and `culled_members_per_path`), times the paths
of a frame.  None when the run holds no such count or no culled launch was
traced (a session that does not cull).
"""

from brtbench.yardstick.culled_sweep import culled_bound

KERNEL = "k1_culled_kernel"


def read(run):
    members = getattr(run, "culled_members_per_path", None)
    if run.trace is None or members is None:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    paths = run.paths_per_frame
    least, _ = culled_bound(run.n_spheres, run.culled_chunks, run.n_pix,
                            run.spp, run.culled_rounds_per_path * paths,
                            members * paths)
    return 100.0 * least * launches / seconds
