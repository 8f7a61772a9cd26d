"""Image writeback: tone-map + PNG/PPM/EXR.

Mirror of `bevy_raytrace_tpu/io/image.py`: PNG/PPM for display (gamma 2, the
"Ray Tracing in One Weekend" write_color), EXR for linear HDR.  Encoding
runs in the native C++ library when it could be built (`io/native.py`),
else in pure Python (stdlib zlib for PNG); both give the same bytes.

Images are numpy arrays or torch tensors; a tensor is detached and copied
to the host here, so a frame on the CUDA device can be passed as it is.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np
import torch

from bevy_raytrace_tpu_torch.io import native

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def to_numpy(img) -> np.ndarray:
    """`img` (array-like or tensor on any device) as a host numpy array."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def tonemap(img) -> np.ndarray:
    """Linear float [H,W,3] -> gamma-2 uint8 (the sqrt write_color)."""
    img = np.asarray(to_numpy(img), np.float32)
    lib = native.load()
    if lib is not None:
        flat = np.ascontiguousarray(img).reshape(-1)
        out = np.empty(flat.size, np.uint8)
        lib.brt_tonemap_srgb(flat.ctypes.data_as(_F32P),
                             out.ctypes.data_as(_U8P), flat.size)
        return out.reshape(img.shape)
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255.0 + 0.5).astype(np.uint8)


def _rgb8(img) -> np.ndarray:
    """A linear float image tone-mapped, or a uint8 one as it is ->
    contiguous uint8 [H, W, 3]."""
    img = to_numpy(img)
    rgb = img if img.dtype == np.uint8 else tonemap(img)
    return np.ascontiguousarray(rgb, np.uint8)


def write_png(path: str, img) -> None:
    """Write a linear float image (or uint8) as gamma-2 PNG."""
    rgb = _rgb8(img)
    h, w, _ = rgb.shape
    lib = native.load()
    if lib is not None:
        if lib.brt_write_png(path.encode(), rgb.ctypes.data_as(_U8P), w,
                             h) == 0:
            return
    _write_png_py(path, rgb)


def png_bytes(img) -> bytes:
    """Encode a linear float (or uint8) image as PNG bytes in memory
    (stdlib zlib; the `cli serve` path, where frames go to an HTTP response
    instead of disk)."""
    rgb = _rgb8(img)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _write_png_py(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def write_ppm(path: str, img) -> None:
    rgb = _rgb8(img)
    h, w, _ = rgb.shape
    lib = native.load()
    if lib is not None:
        if lib.brt_write_ppm(path.encode(), rgb.ctypes.data_as(_U8P), w,
                             h) == 0:
            return
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def write_exr(path: str, img) -> None:
    """Write linear float32 HDR as minimal uncompressed EXR (native only)."""
    img = np.ascontiguousarray(np.asarray(to_numpy(img), np.float32))
    h, w, _ = img.shape
    lib = native.load()
    if lib is None:
        raise RuntimeError(
            "EXR writeback requires the native library, which could not be "
            f"built: {native.BUILD_ERROR}")
    rc = lib.brt_write_exr(path.encode(), img.ctypes.data_as(_F32P), w, h)
    if rc != 0:
        raise IOError(f"brt_write_exr failed with {rc}")


def write_image(path: str, img) -> None:
    """Dispatch on extension: .png / .ppm / .exr."""
    low = path.lower()
    if low.endswith(".png"):
        write_png(path, img)
    elif low.endswith(".ppm"):
        write_ppm(path, img)
    elif low.endswith(".exr"):
        write_exr(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


def assemble_tiles(tiles, starts, num_pixels: int) -> np.ndarray:
    """Gather per-rank framebuffer stripes into one flat image on the host.

    `tiles` is a list of [n_i, 3] float32 arrays or tensors, `starts` their
    absolute pixel offsets.  Uses the native `brt_assemble_tiles` when
    available, else numpy.
    """
    tiles = [np.ascontiguousarray(to_numpy(t), np.float32).reshape(-1, 3)
             for t in tiles]
    # Validate every stripe BEFORE dispatch: the native path is a raw
    # memcpy loop, so an inconsistent stripe would be an out-of-bounds heap
    # write there (and a shape-mismatch ValueError in numpy).
    if len(tiles) != len(starts):
        raise ValueError(
            f"{len(tiles)} tiles but {len(starts)} starts")
    for t, s0 in zip(tiles, starts):
        s0 = int(s0)
        if s0 < 0 or s0 + t.shape[0] > num_pixels:
            raise ValueError(
                f"tile stripe [{s0}, {s0 + t.shape[0]}) out of bounds for "
                f"num_pixels={num_pixels}")
    out = np.zeros((num_pixels, 3), np.float32)
    lib = native.load()
    if lib is not None:
        ptrs = (_F32P * len(tiles))(*[t.ctypes.data_as(_F32P) for t in tiles])
        starts_a = np.asarray(starts, np.int64)
        sizes_a = np.asarray([t.shape[0] for t in tiles], np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.brt_assemble_tiles(ptrs, starts_a.ctypes.data_as(i64p),
                               sizes_a.ctypes.data_as(i64p), len(tiles),
                               out.ctypes.data_as(_F32P))
        return out
    for t, s0 in zip(tiles, starts):
        out[int(s0):int(s0) + t.shape[0]] = t
    return out
