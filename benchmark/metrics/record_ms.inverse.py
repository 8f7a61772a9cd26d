"""record_ms.inverse: host milliseconds an optimizer step spends in the
port's span `inverse.record` (a render of `make_fast_renderer`'s function:
the table gather, `Camera.pack`, the cluster bounds, K2's host side and
launch; two a step), over the traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "inverse.record")
