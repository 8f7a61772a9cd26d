"""tables_ms.realtime: host milliseconds a real-time frame spends in the
port's span `k1.tables` (the sphere tables, the packed camera and the
frame's seed, before K1's launch), over the traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "k1.tables")
