"""update_ms.inverse: host milliseconds an optimizer step spends in the
port's span `inverse.update` (Adam's update in `optimize_step`), over the
traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "inverse.update")
