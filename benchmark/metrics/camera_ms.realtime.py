"""camera_ms.realtime: host milliseconds a real-time frame spends in the
port's span `camera.look_at` (`Camera.look_at`: the frame's new camera,
built before the frame is requested of the session), over the traced
window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "camera.look_at")
