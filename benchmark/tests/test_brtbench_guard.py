"""The check for modules of the JAX package, by whole top-level name."""

import subprocess
import sys
from pathlib import Path

from brtbench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_whole_names_only():
    names = ["bevy_raytrace_tpu_torch", "bevy_raytrace_tpu_torch.kernels",
             "jaxtyping", "flaxen", "torch", "numpy.linalg"]
    assert guard.forbidden_modules(names) == []


def test_each_forbidden_name_is_found():
    names = ["jax.numpy", "jaxlib", "flax.linen", "bevy_raytrace_tpu.core",
             "bevy_raytrace_tpu_torch"]
    assert guard.forbidden_modules(names) == [
        "bevy_raytrace_tpu", "flax", "jax", "jaxlib"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.'];"
            "import brtbench.main, brtbench.spec, brtbench.reference;"
            "import bevy_raytrace_tpu_torch.wavefront, "
            "bevy_raytrace_tpu_torch.kernels.render_lanes;"
            "from brtbench import spec; spec.runner('session');"
            "from brtbench.guard import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
