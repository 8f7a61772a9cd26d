"""launch_ms.realtime: host milliseconds a real-time frame spends in the
port's span `k1.launch` (`render_lanes`: the operand checks, the table
mode and K1's ctypes launch), over the traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "k1.launch")
