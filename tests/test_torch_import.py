"""The PyTorch port imports without JAX, on a CPU-only torch."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parent.parent / "bevy_raytrace_tpu_torch"


def test_import_does_not_load_jax():
    """Importing the package and every module in it leaves JAX unloaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bevy_raytrace_tpu_torch as p\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name[len(p.__name__) + 1:])\n"
        "new = {'shard.mesh', 'shard.render_sharded', 'shard.worker',\n"
        "       'kernels.sweep_record', 'inverse.shard_grad', 'device',\n"
        "       'cli', 'io', 'io.native', 'io.image', 'io.writer',\n"
        "       'kernels.clusters', 'kernels.probes', 'kernels.fp32_probe',\n"
        "       'tools', 'tools.proto_probes', 'tools.fp32_probe',\n"
        "       'tools.grad_bench', 'tools.scaling', 'tools.ref_probe',\n"
        "       'graft_entry', 'wavefront.oracle'}\n"
        "assert new <= seen, new - seen\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'bevy_raytrace_tpu.')) or k == 'bevy_raytrace_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_reference_package_names_import_without_jax():
    """The reference's package-level names (`kernels.render_pallas`,
    `kernels.cluster_scene`, `kernels.ClusterPlan`, `utils.trace_profile`)
    import from the port's packages on a CPU-only torch, with no JAX loaded
    and no kernel built."""
    code = (
        "import sys\n"
        "from bevy_raytrace_tpu_torch.kernels import (ClusterPlan,\n"
        "    cluster_scene, render_pallas)\n"
        "from bevy_raytrace_tpu_torch.utils import trace_profile\n"
        "import bevy_raytrace_tpu_torch.kernels.record as k2\n"
        "assert render_pallas is k2.render_pallas\n"
        "assert callable(cluster_scene) and callable(trace_profile)\n"
        "assert isinstance(ClusterPlan, type)\n"
        "assert k2._k2_launcher.cache_info().currsize == 0\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'bevy_raytrace_tpu.')) or k == 'bevy_raytrace_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_NO_JAX = re.compile(r"^\s*(import jax|from jax\b|import bevy_raytrace_tpu\b"
                     r"(?!_torch)|from bevy_raytrace_tpu\b(?!_torch))", re.M)


def test_no_module_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"shard/mesh.py", "shard/render_sharded.py", "shard/worker.py",
            "kernels/sweep_record.py", "inverse/shard_grad.py",
            "device.py", "cli.py", "io/__init__.py", "io/native.py",
            "io/image.py", "io/writer.py", "kernels/clusters.py",
            "kernels/probes.py", "kernels/fp32_probe.py", "tools/__init__.py",
            "tools/proto_probes.py", "tools/fp32_probe.py",
            "tools/grad_bench.py", "tools/scaling.py", "tools/ref_probe.py",
            "graft_entry.py", "wavefront/oracle.py"} <= names
    offenders = [str(f) for f in files if _NO_JAX.search(f.read_text())]
    assert not offenders


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on a machine without JAX."""
    text = (PKG.parent / "chip_smoke.py").read_text()
    assert not _NO_JAX.search(text)


def test_bench_imports_no_jax():
    """bench_torch.py runs on a machine without JAX."""
    text = (PKG.parent / "bench_torch.py").read_text()
    assert not _NO_JAX.search(text)


def test_cli_help_needs_no_device():
    """`python -m bevy_raytrace_tpu_torch.cli --help` prints the four
    commands on any machine."""
    out = subprocess.run(
        [sys.executable, "-m", "bevy_raytrace_tpu_torch.cli", "--help"],
        cwd=PKG.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("render", "animate", "serve", "inverse"):
        assert cmd in out.stdout


def test_tools_help_needs_no_device():
    """Every tool and the bench print their usage on any machine, and
    asking for it builds nothing."""
    def listing():
        return sorted((PKG / "_build").glob("*"))

    before = listing()
    for cmd in [["-m", f"bevy_raytrace_tpu_torch.tools.{tool}"]
                for tool in ("proto_probes", "fp32_probe", "grad_bench",
                             "scaling", "ref_probe")] + [["bench_torch.py"]]:
        out = subprocess.run([sys.executable, *cmd, "--help"],
                             cwd=PKG.parent, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert "--device" in out.stdout
    assert listing() == before
