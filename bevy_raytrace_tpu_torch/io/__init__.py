"""Image writeback: tone-map, PNG/PPM/EXR encoders, stripe assembly and the
asynchronous `FrameWriter`.  Every function takes numpy arrays and torch
tensors on any device (a CUDA tensor is copied to the host inside)."""

from bevy_raytrace_tpu_torch.io.image import (
    assemble_tiles,
    png_bytes,
    tonemap,
    write_exr,
    write_image,
    write_png,
    write_ppm,
)
from bevy_raytrace_tpu_torch.io.writer import FrameWriter

__all__ = ["assemble_tiles", "png_bytes", "tonemap", "write_png", "write_ppm",
           "write_exr", "write_image", "FrameWriter"]
