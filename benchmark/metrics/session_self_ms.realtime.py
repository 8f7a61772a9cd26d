"""session_self_ms.realtime: host milliseconds a real-time frame spends in
the port's span `session.frame` (`Renderer.render_frame`) outside its
child spans (`k1.tables`, `k1.launch`, `k1.scatter`): the session's own
step, the lane ids and the scaling, over the traced window."""

from brtbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "session.frame", self_time=True)
