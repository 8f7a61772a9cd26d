"""Asynchronous frame writeback: the frame loop's IO executor.

Mirror of `bevy_raytrace_tpu/io/writer.py`.  Writing every frame
synchronously stalls the renderer for the tone-map + encode + write time of
each frame.  `FrameWriter.submit()` copies the frame and returns at once, a
native C++ worker pool (`csrc/brt_native.cpp`: brt_writer_*) tone-maps,
encodes and writes in the background, and `wait()` joins at the end of the
sequence.  Without the native library a Python thread pool over
`write_image` does the same (identical bytes either way: the same
encoders).

Frames are numpy arrays or torch tensors; a tensor is copied to the host
inside `submit` (a synchronous copy: when `submit` returns the frame's
bytes have landed and the caller may reuse the tensor).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os

import numpy as np

from bevy_raytrace_tpu_torch.io import native
from bevy_raytrace_tpu_torch.io.image import to_numpy, write_image

_FMT = {".png": 0, ".ppm": 1, ".exr": 2}


class FrameWriter:
    """Background frame writer.

    Usage:
        with FrameWriter() as fw:
            for i in range(n):
                img = step(...)          # the device renders frame i+1 while
                fw.submit(path_i, img)   # ...frame i encodes on the host
        # __exit__ waits and raises if any frame failed to write
    """

    def __init__(self, n_threads: int = 2):
        self._lib = native.load()
        self._handle = None
        self._pool = None
        self._n_threads = int(n_threads)
        self._futures = []
        if self._lib is not None:
            self._handle = self._lib.brt_writer_create(int(n_threads))
        if self._handle is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n_threads)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def submit(self, path: str, img) -> None:
        """Enqueue a linear float, or already tone-mapped uint8, [H, W, 3]
        frame; returns immediately.

        The buffer is copied before returning, so callers may overwrite or
        free `img` right away.  Format follows the extension (.png / .ppm /
        .exr, the dispatch of `write_image`).  uint8 frames are already
        gamma-2 tone-mapped (`cli animate` tone-maps on the device and
        copies 3 bytes per pixel); they are encoded as they are.  EXR needs
        linear float.
        """
        ext = os.path.splitext(path)[1].lower()
        if ext not in _FMT:
            raise ValueError(f"unsupported image extension: {path}")
        # Validate before the native/fallback branch: the thread pool would
        # otherwise accept a malformed frame here and surface the error
        # only at wait().
        rgb = to_numpy(img)
        if rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] frame, got {rgb.shape}")
        if rgb.dtype == np.uint8:
            if ext == ".exr":
                raise ValueError("EXR output needs a linear float frame")
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._n_threads)
            arr = np.array(rgb, np.uint8, copy=True)
            self._futures.append(self._pool.submit(write_image, path, arr))
            return
        rgb = np.ascontiguousarray(rgb, np.float32)
        if self._handle is not None:
            h, w, _ = rgb.shape
            rc = self._lib.brt_writer_submit(
                self._handle, path.encode(),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h,
                _FMT[ext])
            if rc != 0:
                raise RuntimeError(f"brt_writer_submit failed ({rc})")
        else:
            arr = np.array(rgb, np.float32, copy=True)
            self._futures.append(self._pool.submit(write_image, path, arr))

    def wait(self) -> None:
        """Block until every submitted frame is on disk; raise on failure.

        Both queues are drained: a native writer can hold float frames
        while uint8 frames ride the thread pool."""
        native_failed = 0
        if self._handle is not None:
            native_failed = self._lib.brt_writer_wait(self._handle)
        futures, self._futures = self._futures, []
        errors = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — collected below
                errors.append(e)
        if native_failed or errors:
            raise IOError(
                f"{native_failed + len(errors)} frame(s) failed to write"
                + (": " + "; ".join(str(e) for e in errors[:4])
                   if errors else ""))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.brt_writer_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.wait()
        finally:
            self.close()
        return False
