"""device_idle_pct.realtime: `device_idle_pct.render` (see that file) in
the real-time cell, where the host path of every short frame (the camera,
the session's tables and launch, the wait) shows as idle device time and
moves `rays_per_s.realtime`."""

from brtbench import spec


def read(run):
    return spec.reader("device_idle_pct.render")(run)
