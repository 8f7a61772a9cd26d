"""Build the CUDA sources of `csrc/` with nvcc and load them with ctypes.

Each library is compiled on first use, from the repository's own sources,
into `bevy_raytrace_tpu_torch/_build/` (git-ignored), under a name keyed by
a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the existing `.so`.  The sources expose plain `extern
"C"` launchers: no PyTorch header is compiled, which keeps a build to
seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# name -> (seconds, nvcc output) of the builds this process ran.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or in /usr/local/cuda)")
    return path


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a shared library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        BUILD_LOG[name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
