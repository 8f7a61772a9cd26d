"""frame_ms_p95.session: the 95th percentile of the latency of every frame
of the traced window, from its request to its image complete on the
device, in ms.  Per layer and read in the `--trace 1` run, where the
profiler makes each frame some 15% slower: the real-time cell's host-bound
frames spread between processes by more than the largest bound an
end-to-end metric may have, so this tail moves `rays_per_s.realtime`
without a bound of its own."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
