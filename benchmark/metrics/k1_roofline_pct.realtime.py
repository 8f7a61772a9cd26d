"""k1_roofline_pct.realtime: `k1_roofline_pct` (see that file) in the
real-time cell, where it moves `rays_per_s.realtime`."""

from brtbench import spec


def read(run):
    return spec.reader("k1_roofline_pct")(run)
