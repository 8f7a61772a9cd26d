"""The benchmark harness of bevy_raytrace_tpu_torch (see benchmark/run.py)."""
