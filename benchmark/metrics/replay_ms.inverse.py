"""replay_ms.inverse: host milliseconds an optimizer step spends in the
port's span `inverse.replay` (the backward of a fast render: K3's host
side and launch, the cotangents' reduction; two a step), over the traced
window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "inverse.replay")
