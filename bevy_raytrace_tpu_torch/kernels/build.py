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
# Per-library additions.  K3 replays paths bit for bit like its plain
# PyTorch version, which rounds every operation: no fused multiply-add.
EXTRA_FLAGS = {"k3_replay_grad": ("-fmad=false",)}

_LIBS: dict = {}
# name -> (seconds, nvcc output) of the builds this process ran.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or in /usr/local/cuda)")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def load_all(names) -> dict:
    """Build every library of `names` that is missing, one nvcc process
    each, all started together; then load them all -> {name: CDLL}."""
    names = list(names)
    procs = {}
    for name in names:
        out = library_path(name)
        if name in _LIBS or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[name] = (proc, time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}:\n{stdout}\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        BUILD_LOG[name] = (time.perf_counter() - t0, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: load(name) for name in names}


def build_output(name: str) -> str:
    """nvcc's output (ptxas's registers, stack frame and spills of each
    kernel) for the library `load` gives: this process's build, or the one
    saved beside a library built earlier."""
    load(name)
    got = BUILD_LOG.get(name)
    return got[1] if got else library_path(name).with_suffix(
        ".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a shared library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        return load_all([name])[name]
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
