from bevy_raytrace_tpu_torch.utils.metrics import (FrameTimer, RenderMetrics,
                                                   trace_profile)

__all__ = ["FrameTimer", "RenderMetrics", "trace_profile"]
