from bevy_raytrace_tpu_torch.utils.metrics import trace_profile

__all__ = ["trace_profile"]
