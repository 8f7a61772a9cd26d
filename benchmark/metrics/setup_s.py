"""setup_s: from the top of run.py to the first timed frame: CUDA's start,
the kernels' load (or build on a checkout's first run), the scene, the
session's probe frame and the warm-up frames."""


def read(run):
    return run.setup_s
