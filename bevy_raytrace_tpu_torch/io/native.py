"""ctypes loader for the native runtime library (`csrc/brt_native.cpp` at
the repository root: tone-map, PNG/PPM/EXR encoders, stripe assembly and
the frame-writer worker pool).

Mirror of `bevy_raytrace_tpu/io/native.py`, with its own build: the library
is compiled from that source with the host's C++ compiler at first use,
into the git-ignored `bevy_raytrace_tpu_torch/_build/`, under a name keyed
by a hash of the source and the flags (as `kernels/build.py` does for the
CUDA sources).  The compiler is called directly (no `make`), and without
`-march=native`: a library built for one host's CPU can die with an illegal
instruction on another's.  `-ffp-contract=off` keeps the tone-map's
`x * 255 + 0.5` unfused, so the bytes do not depend on the host's CPU.

Callers fall back to pure Python when the library cannot be built
(`load()` returns None and `BUILD_ERROR` says why): this is host-side file
encoding, and both routes give the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "csrc" / "brt_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off",
             "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
# Why the last `load()` returned None (the compiler's output, or the
# exception), or None.
BUILD_ERROR = None


def _compiler():
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (CXX, c++, g++, clang++)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbrt_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"compiling {SOURCE.name} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none


def _declare(lib) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.brt_tonemap_srgb.argtypes = [f32p, u8p, ctypes.c_int64]
    lib.brt_tonemap_srgb.restype = None
    for fn in (lib.brt_write_png, lib.brt_write_ppm):
        fn.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.brt_write_exr.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int,
                                  ctypes.c_int]
    lib.brt_write_exr.restype = ctypes.c_int
    lib.brt_assemble_tiles.argtypes = [ctypes.POINTER(f32p), i64p, i64p,
                                       ctypes.c_int, f32p]
    lib.brt_assemble_tiles.restype = None
    lib.brt_writer_create.argtypes = [ctypes.c_int]
    lib.brt_writer_create.restype = ctypes.c_void_p
    lib.brt_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f32p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.brt_writer_submit.restype = ctypes.c_int
    lib.brt_writer_wait.argtypes = [ctypes.c_void_p]
    lib.brt_writer_wait.restype = ctypes.c_int
    lib.brt_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_writer_destroy.restype = None


def load():
    """The loaded native library (built on first use), or None when it
    cannot be built or loaded here; `BUILD_ERROR` then holds the reason."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError,
                AttributeError) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def route() -> str:
    """"native" when the encoders run in the C++ library, else "python"."""
    return "native" if load() is not None else "python"
