from bevy_raytrace_tpu_torch.utils.metrics import FrameTimer, RenderMetrics

__all__ = ["FrameTimer", "RenderMetrics"]
