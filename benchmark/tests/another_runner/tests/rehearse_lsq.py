"""The `lsq` runner's CPU rehearsal: the toy's sizes fit the CPU as they
stand, and its own session runs on CPU tensors."""

from brtbench import spec


def make_session(problem, device):
    return spec.runner("lsq").default_session(problem, device)


def sync():
    return None


def tiny_cell(name, fault=None):
    return spec.load_cell(name)


def trace(monkeypatch, runner):
    """The toy traces itself on the host's clock."""
