"""Build the CUDA sources of `csrc/` with nvcc and load them with ctypes.

Each library is compiled on first use, from the repository's own sources,
into `bevy_raytrace_tpu_torch/_build/` (git-ignored), under a name keyed by
a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the existing `.so`.  The sources expose plain `extern
"C"` launchers: no PyTorch header is compiled, which keeps a build to
seconds.  Nothing here runs at import time.  `defines` (macro=value strings,
passed as -D) build a variant of a library beside it, under its own hash:
`profile_grad.py` builds K3's measurement probes that way.
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
# name (then the defines, space-separated) -> (seconds, nvcc output) of the
# builds this process ran.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or in /usr/local/cuda)")
    return path


def _flags(name: str, defines: tuple = ()) -> tuple:
    return (NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
            + tuple(f"-D{d}" for d in defines))


def _key(name: str, defines: tuple) -> str:
    return " ".join((name, *defines))


def _source_hash(name: str, defines: tuple = ()) -> str:
    h = hashlib.sha256(" ".join(_flags(name, defines)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, defines: tuple = ()) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name, defines)}.so"


def load_all(names, defines: tuple = ()) -> dict:
    """Build every library of `names` that is missing, one nvcc process
    each, all started together; then load them all -> {name: CDLL}."""
    names, defines = list(names), tuple(defines)
    procs = {}
    for name in names:
        out = library_path(name, defines)
        if _key(name, defines) in _LIBS or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name, defines), "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[name] = (proc, time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        BUILD_LOG[_key(name, defines)] = (time.perf_counter() - t0,
                                          stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: load(name, defines) for name in names}


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a shared library."""
    defines = tuple(defines)
    lib = _LIBS.get(_key(name, defines))
    if lib is not None:
        return lib
    out = library_path(name, defines)
    if not out.exists():
        return load_all([name], defines)[name]
    lib = ctypes.CDLL(str(out))
    _LIBS[_key(name, defines)] = lib
    return lib
