"""scatter_ms.realtime: host milliseconds a real-time frame spends in the
port's span `k1.scatter` (the image and length map scattered back from
lane order to pixel order), over the traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "k1.scatter")
