"""Run the five construct probes P1-P5 on the reference tool's own inputs.

    python -m bevy_raytrace_tpu_torch.tools.proto_probes [--device cpu]

Counterpart of `tools/proto_mxu.py`'s main: the same draws
(`np.random.RandomState(0..3)`) at the same shapes, one line a probe:

    p1_while     OK  result=51.51...  (0.03 ms)

`result` is the reference's figure: P1's lane (0, 0); P2's largest error
against the float64 product, relative to its largest entry; P3's and P5's
largest error; P4's count of rows that are not `np.argmin`'s (the reference
reports 8 here: its packed key truncates t; the port's minimum is exact).
Each is checked against a numpy answer made on the host.  Unlike the
reference, which prints FAIL and goes on, a probe that raises ends the run
with its traceback, and a result that is off makes the exit code 1.

The time is one call after a warm-up call, host clock to
`torch.cuda.synchronize()`: at these shapes mostly the launch itself.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def reference_inputs():
    """{probe: tuple of numpy operands}, the reference tool's own."""
    rs3 = np.random.RandomState(3)
    packed = rs3.randint(0, 1 << 20, (512, 1024)).astype(np.int32)
    attr = rs3.randn(16, 512).astype(np.float32)
    return {
        "p1_while": (np.zeros((8, 128), np.float32),),
        "p2_dot": (np.random.RandomState(0).randn(1024, 16).astype(np.float32),
                   np.random.RandomState(1).randn(16, 1024).astype(np.float32)),
        "p3_reshape": (np.arange(1024, dtype=np.float32).reshape(8, 128),),
        "p4_minpack": (1.0 + np.random.RandomState(2).rand(512, 1024).astype(
            np.float32),),
        "p5_onehot": (packed, packed.min(axis=0, keepdims=True), attr),
    }


def _p1_lane00():
    """P1's answer for x = 0, in float64 on the host."""
    a, b, rounds = 0.0, 0.0, 0
    while True:
        a += 1.0
        b = b * 1.01 + a * 0.001
        rounds += 1
        if not a < 50.0:
            return b + rounds


def figures(inputs, outputs):
    """{probe: (the reference's figure, whether it is as it must be)} of the
    probes' outputs (numpy arrays) on `inputs`."""
    a, b = inputs["p2_dot"]
    ref = a.astype(np.float64) @ b.astype(np.float64)
    (x,) = inputs["p3_reshape"]
    (t,) = inputs["p4_minpack"]
    packed, _, attr = inputs["p5_onehot"]
    p1 = float(outputs["p1_while"][0][0, 0])
    p2 = float(np.abs(outputs["p2_dot"] - ref).max() / np.abs(ref).max())
    p3 = float(np.abs(outputs["p3_reshape"] - x * 2.0).max())
    m, row = outputs["p4_minpack"]
    p4 = int(np.sum(row.reshape(-1) != np.argmin(t, axis=0)))
    p5 = float(np.abs(outputs["p5_onehot"]
                      - attr[:, np.argmin(packed, axis=0)]).max())
    return {
        "p1_while": (p1, abs(p1 - _p1_lane00()) <= 1e-5 * _p1_lane00()
                     and int(outputs["p1_while"][1][0]) == 50),
        "p2_dot": (p2, p2 <= 1e-5),
        "p3_reshape": (p3, p3 == 0.0),
        "p4_minpack": (p4, p4 == 0 and np.array_equal(
            m.reshape(-1), t.min(axis=0))),
        "p5_onehot": (p5, p5 == 0.0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where to run: the CUDA device by default; 'cpu' "
                         "runs the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    import torch

    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.kernels import probes

    device = resolve(args.device)
    fns = {"p1_while": probes.p1_while, "p2_dot": probes.p2_dot,
           "p3_reshape": probes.p3_reshape, "p4_minpack": probes.p4_min,
           "p5_onehot": probes.p5_onehot_gather}
    inputs = reference_inputs()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    outputs, ms = {}, {}
    for name, fn in fns.items():
        operands = [torch.from_numpy(v).to(device) for v in inputs[name]]
        fn(*operands)  # warm-up; on CUDA the first one builds the library
        sync()
        t0 = time.perf_counter()
        out = fn(*operands)
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        outputs[name] = (tuple(o.cpu().numpy() for o in out)
                         if isinstance(out, tuple) else out.cpu().numpy())
    bad = 0
    for name, (figure, ok) in figures(inputs, outputs).items():
        print(f"{name:12s} {'OK ' if ok else 'OFF'} result={figure}  "
              f"({ms[name]:.3f} ms on {device})", flush=True)
        bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
