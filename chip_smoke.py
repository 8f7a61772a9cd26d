#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths from a checkout of this repository — the
forward render of a frame through the K1 CUDA kernel (dense and
chunk-culled), inverse rendering
through the K2 (recording forward) and K3 (replay gradient) CUDA kernels,
the sharded gradient path (one process per device on torch.distributed)
through K2/K4 (the dense-sweep recorder) and K3 in stripe mode, the
command line (`cli render | animate | serve | inverse`, in-process) with
K2's cluster-culled traversal, the tool path (`tools.proto_probes`,
`tools.fp32_probe`, `tools.grad_bench`, `graft_entry`) through the probe
kernels P1-P5 and V1-V3, and the bench (`bench_torch.py`) with the sharding
record (`tools.scaling`) and the frame loops (`tools.ref_probe`) through
K1-K4 — and fails loudly — a traceback and a nonzero
exit — if any phase fails:

  1. environment: torch/CUDA versions, the card (nvidia-smi), nvcc;
  2. build: K1 from bevy_raytrace_tpu_torch/csrc with nvcc, timed;
  3. parity at the bench's verify config (240x160, 8 spp, depth 8) on
     rtiow_final and baseline_config2: kernel vs its plain PyTorch twin and
     vs the torch wavefront under parity.COMPILED; a random lane
     permutation must give a bit-identical kernel image; each launch's
     table mode (K1 and K4 stage the sphere rows in shared memory, or read
     them from device memory above kernels/common.py::forward_table_plan's
     limit) is recorded;
  4. the reference's own frame (1920x1080, depth 3, reference_scene, 64 spp)
     through Renderer(backend="cuda"): a probe frame, then cached-perm
     frames; finite, and one 16,384-pixel stripe against the twin;
  5. the flagship (1200x800, 256 spp, depth 8, rtiow_final) through
     render_mxu_balanced, timed;
  6. K1's launch count over phases 4-5 must be > 0 (staged table); then
     K1 on the flagship's identity lanes, timed, with its bound from the
     rounds it ran, and render_mxu on 15,000 seeded spheres (K1's global
     table: one launch, counted) against the twin;
 6b. K1's chunk-culled traversal (cluster size 12; k1_culled_kernel, its
     own entry of the kernels line): `nvcc -Xptxas -v`'s registers, stack
     frame and spills of each K1 instantiation; the flagship through
     render_mxu_balanced(plan=cluster_scene(scene, 12)) twice, its counts
     set to 0 before and read after (4 culled launches on the staged
     table), bit for bit phase 5's dense frame, both timed; one 16,384-pixel
     stripe of it against the culled twin under parity.COMPILED, and the
     culled kernel on those lanes against the twin (the kernels line's
     culled check, its bound counted from the live chunks it reported);
     culled against dense K1 on the flagship's identity lanes, timed, with
     the live chunks a round and the culled bound and its share; the
     reference frame (bit for bit phase 4a's dense launch) and 15,000
     seeded spheres at 320x240x2, depth 3 (device-memory tables), culled
     against dense, bit for bit, timed; 2,000 seeded spheres at 96x64x4,
     depth 8, planned at cluster size 1 (chunks of one small sphere, where
     the bound test's slack must cover the member test's grazing hits),
     culled against dense, bit for bit; `tools.livechunks` at cluster
     sizes 12 and 64;
  7. build: K2 (k2_record), K3 (k3_replay_grad) and K4 (k4_sweep_record),
     one nvcc each, started together, timed, with ptxas registers and spills
     of every instantiation;
  8. K2 against its plain twin at the gradient bench's shape (400x300,
     16 spp, depth 8, rtiow_final, edge_softness 0.01): image under
     parity.COMPILED, at most 2% of residual entries differing, and the
     torch replay of the kernel's residuals reconstructing its image;
  9. K3 against its plain twin (autograd of the torch replay) on those
     residuals with a seeded cotangent: d_table and d_cam to rtol 2e-3 of
     each array's max-abs.  Then every other instantiation the main path
     launches, each against its twin on the same inputs: at the bench's
     shape with edge_softness 0, K2 recording winners only and value only,
     and K3 without the silhouette term; and on a 2-sample slice of the
     flagship gradient (1200x800, samples 128-129 through sample_base), the
     same three.  K3's table mode (its block-private table in shared memory,
     or adds straight into d_table above what a block holds) is recorded
     with each check; at the bench's shape the global mode is also forced
     and held against the twin and the shared mode.  Then K2 and K3 on the
     hot-row case (config1 at 1200x800, 2 samples, edge 0.01: nearly every
     lane of a warp adds into one of 3 rows) and on 2,000 and 4,096 seeded
     spheres at 320x240x4 (a 144 KB block table, against the global mode
     too; K3's global table); K2 on a tangent ray (disc == 0 exactly:
     a hit at every first bounce) and on 15,000 seeded spheres (rows read
     from device memory, not staged);
 10. inverse rendering at the CLI's size (1200x800, 64 spp, depth 8,
     edge_softness 0.01, config1 perturbed as `cli inverse` does): 3 Adam
     steps with a checkpoint, resumed to 6 steps, and the step-3 checkpoint
     resumed again for the same 3 steps; finite losses, the last below the
     first, the two resumed runs agreeing;
 11. recovery, each run with the counts set to 0 before it and read after
     it, held to exact numbers: (a) the reference test's problem
     (tests/test_inverse.py: config1 at 32x24, 4 spp, depth 3, the ball's
     albedo and center perturbed, edge_softness 0.01, 80 Adam steps at lr
     1e-2) through the wavefront (no kernel), K2 and K4 (K2 or K4 160, K3
     160), each clearing the reference's bars (last loss < 0.3x the first,
     center error < 0.4x the initial, albedo error < 0.08); (b) the `cli
     inverse` problem of phase 10 at its 120 steps and lr 1.5e-2 through K2
     and through K4 (K2 or K4 240, K3 240) from the same start: the first
     loss, the mean of the last 10, the center and albedo errors, s/step,
     paths/s and a profiled step's idle share logged; each clears the bars
     with the last-10 mean for the last loss, and K4's last-10 mean lies
     within 10% of K2's;
 12. the flagship gradient (1200x800, 256 spp, depth 8, rtiow_final, d
     mean(img^2) / d centers) unchunked and with grad_spp_chunk=64; finite
     and agreeing to rtol 2e-3;
 13. K2's and K3's launch counts over phases 10 and 12 must be > 0 (K3 in its
     shared mode); then the gradient of the 4,096-sphere scene through
     make_fast_renderer, counted (K2 1, K3 1 in its global mode) and held
     against backward="torch" at rtol 2e-3;
 14. K4 against its plain twin at the gradient bench's shape (edge_softness
     0.01: winners + runner-up; 0: winners only) and on the 2-sample
     1200x800 slice through sample_base: image under parity.COMPILED, at
     most 2% of residual entries differing, the torch replay of its
     residuals reconstructing its image; K3 on K4's residuals against K3's
     twin (rtol 2e-3); K4's time beside K2's and K1's at the same shape;
     K1's and K4's global table forced against their shared one on the same
     inputs (bit-identical outputs);
 15. K2, K4 and K3 in stripe mode against their full launches: 4 stripes of
     the gradient bench's frame, images and residuals bit-identical,
     cotangents summing to the full launch's (rtol 2e-3);
 16. the sharded gradient path at full width: a torch.distributed group of
     world size 1 on the nccl backend, then make_fast_renderer_sharded on
     the flagship gradient with forward="pallas" (K2) and forward="sweep"
     (K4), each against the unsharded gradient through the same recorder
     (rtol 2e-3; K2's is phase 12's, K4's is taken here and held against
     K2's in bulk: the two record different near-tangent paths), timed,
     with the all-reduce's byte count; render_mxu_sharded(balance=True) on
     the flagship frame bit-identical to render_mxu;
     Renderer(backend="cuda-sharded") on the reference frame; the group is
     destroyed;
 17. K4's, K2's, K3's and K1's launch counts over phase 16 must be > 0
     (K4's staged table); then render_sweep_record on the 15,000 seeded
     spheres (K4's global table: one launch, counted) against the twin;
 18. the native IO library (csrc/brt_native.cpp) built with the host's C++
     compiler at first use; the run fails if it does not build here;
 19. K2's cluster-culled traversal (cluster size 12, 41 clusters on
     rtiow_final): at the gradient bench's shape, culled against the twin
     with the same plan (which sweeps the members with no bound test) for
     value only, winners, and winners + runner-up, and against the
     brute-force launch (differing pixels and residual entries, expected
     0), timed interleaved (brute, culled, culled, brute); the same at the
     CLI's default frame (1200x800, 64 spp, depth 8) against brute force,
     and its 2-sample slice against the twin; clusters hit per primary ray;
 20. the command line at full width, each command through `cli.main([...])`
     with the counts set to 0 before: `render --scene rtiow --backend
     pallas` at the CLI's defaults and with `--cluster-size 0` (the two PNGs
     compared), `render --backend cuda`, `animate --frames 4 --backend
     cuda`, `serve` on a free port (GET /, two /frame.png with different
     cameras, POST /quit), `inverse --backend pallas --steps 6` with a
     checkpoint (its closing `final` line's center and albedo errors below
     those at the start);
     every PNG decoded and held against the image the Python API gives for
     the same arguments (at most one 8-bit step);
 21. Renderer(backend="pallas") over three frames of the reference frame:
     one plan, reused; the last frame against the brute-force launch;
 22. K1's, K2's (with clusters and without) and K3's launch counts over
     phases 20-21 must be > 0;
 23. build: the probes (csrc/probes.cu: P1-P5; csrc/fp32_probe.cu: V1-V3),
     one nvcc each, started together, timed, with ptxas registers and
     spills;
 24. `tools.proto_probes.main([])` (P1-P5 on the reference tool's inputs,
     two launches each, counted); then each of P1-P5 against its plain
     version on the card on those inputs and, for P4 and P5, on a second
     input with a forced tie in one column; P1 also on seeded lanes dying in
     different rounds, on warp 0 dying in round 1 beside lanes that take 50,
     on one surviving lane, on lanes all dead after one round and on a NaN
     lane (p1_inputs(), each with its exact round count); P2 also at
     [1024,48] @ [48,1024] (three K steps); P3 also at a card-filling
     [2^21,128] (1 GiB in, 1 GiB out: bound by its bytes, 0.641 ms) with
     its library call, and bit for bit against x * 2 at [2^24 + 1,128],
     where rows x 128 passes 2^31 (compared a chunk of rows at a time).
     The SHA-256 of P1's, P2's and P3's outputs on each input is printed,
     so that two trees run in one call can be held to the same bits.
     Tolerances: P1 rtol 1e-5 (the kernel contracts one multiply-add); P2
     1e-5 of the largest entry (the order of the sum over K), with
     torch.backends.cuda.matmul.allow_tf32 False; P3, P4 (value and row)
     and P5 exact.  Each beside the one PyTorch call that
     computes the same function, where there is one (library_ms); and the
     device-side durations of the kernel and the library call
     (torch.profiler's CUDA trace, 50 calls), which the host's launch path
     does not inflate, with the bound's share of the kernel's.  P4 also on
     a third input, NaN at rows 0 and 9 of one column and in every row of
     another: bit for bit against the plain version, a NaN never winning
     against a number and the all-NaN column giving row 0;
 25. `tools.fp32_probe.main([])`: V1, V2 (float32 and bfloat16) and V3 (prod,
     nosqrt, nobranch, smem, k1) at the reference's shape (256 spheres, 1,024
     rays, 4,000 rounds) and at the card-filling shape (270,336 rays, 400
     rounds; V3 prod and k1 also on two scenes' tables with camera rays in
     raster order, uniform within a warp, and shuffled, smem in raster
     order), launches counted; twice the rounds must take twice the time; no
     rate may exceed the card's peak; V3 prod's (t, index) must have k1's
     SHA-256 (and smem's) on every input the tool ran both; V1's time, the
     bound's share of it and its SHA-256 printed per shape.  Then
     every kernel and variant against its plain version at the reference's
     shape with 3 rounds: V1's and V3's t to rtol 1e-5 (atol 2e-6: a root is
     a difference of O(1) terms), V3's index equal on all but near-ties (at
     most 0.5% of columns), V2 float32 rtol 1e-4, bfloat16 rtol 5e-2 (bf16
     rounds after every operation and __hfma2 fuses);
 26. `tools.grad_bench.main(["400", "300", "16", "8", "kernel"])`, its
     `torch,wavefront` paths at 1 spp and `[..., "kernel", "--forward",
     "sweep"]`, with their launch counts held to exact numbers;
     `graft_entry.entry()` and its fn run once on the card, held against
     K1's image of the same frame under parity.COMPILED;
     `graft_entry.dryrun_multichip(1)`: one rank on the card in an nccl
     group, a finite training step and a finite fast-gradient step;
 27. the port's bench, the sharding record and the frame loops:
     `bench_torch.main(["--quick", "--repeats", "1"])` in this process with
     its stdout captured and K1-K4's counts set to 0 before it and read
     after it, held to exact numbers (K1 11: the gate and its session, the
     reference workload, the flagship frames; K2 7: the gate culled, grad_fast,
     grad_flagship; K3 9; K4 4: the gate, grad_flagship_sweep); its one
     JSON line must have bench.py's keys (with
     `grad_torch_paths_per_s` for `grad_xla_paths_per_s`) plus
     `grad_flagship_sweep_paths_per_s` and `device`, `verify == "pass"`
     and every rate finite and > 0; `tools.scaling.main(["--worlds", "1",
     ...])` (one `shard.worker` rank on nccl: 0 forward collectives, one
     all-reduce of (11 S + 16) x 4 bytes per fast backward, K1's sharded
     frame and the sharded fast-gradient step timed on rtiow at
     1200x800x256 depth 8, a trace written);
     `tools.ref_probe.main(["--frames", "2", "--skip-spp64"])` (the
     reference frame at 16 spp, sync and pipelined, finite rates).

Every kernel entry carries bound_ms, the least time the card could take for
the entry's shape: the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s (the H100 SXM data sheet).  Operations are
counted from the CUDA sources per ray-sphere test, per executed round and
per path (the constants below), times what THIS run's data needs: executed
rounds from K1's `len` output at the same shape, the culled K1's chunk and
member tests from its live-chunk count, hit bounces from the recorded
residuals; P1's rounds from its output; the probes' from their
shapes, bfloat16 against 133.8 TFLOP/s.  No single PyTorch call computes what
K1-K4, P1 or V1-V3 compute, so their library_ms is null; P2-P5 each stand
beside one (torch.matmul, a reshape and multiply, torch.min, an indexed
gather), timed here and used nowhere in the package.

Kernel times are CUDA-event times; step times are host-clock times to
torch.cuda.synchronize().  Entry points are called without a device where
the package's default (the CUDA device) serves.  Prints a {"kernels": [...]}
line, the card's name and power limit, and last {"ok": true, "device":
{...}}.  Exits nonzero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def zero_launches(*kernels):
    """Set every launch counter of `kernels` ("k1", "p3", ...) to 0."""
    from bevy_raytrace_tpu_torch.utils import spans

    for k in kernels:
        spans.reset_counters(f"{k}.")


def launches_of(kernels):
    """{kernel: the launches counted for it} for `kernels`."""
    from bevy_raytrace_tpu_torch.utils import spans

    return {k: spans.counter(f"{k}.launches") for k in kernels}


def cuda_ms(fn, reps, warm=True):
    """Mean CUDA-event milliseconds of fn() over `reps` runs (after one
    warm-up run if `warm`) and fn()'s last result."""
    import torch

    out = fn() if warm else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_ms(fn, reps):
    """Mean device-side milliseconds of fn() over `reps` calls: the summed
    durations of the kernels (and memsets) a call runs, from
    torch.profiler's CUDA trace, so neither the host's launch path nor the
    gaps between launches count.  A kernel traced on at least half the
    calls counts its mean over the launches the trace holds (which can be a
    few short of the calls made: an H100 trace dropped 1 of 50 and 3 of 20)
    times its launches a call; one traced less often (a one-off memset)
    counts its total over the calls.  -> (ms or None where the trace holds
    no device activity, the names of what ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total_us = sum(e.self_device_time_total / e.count
                   * max(1, round(e.count / reps)) if 2 * e.count >= reps
                   else e.self_device_time_total / reps for e in rows)
    return (total_us / 1e3 if rows else None), sorted(
        e.key[:60] for e in rows)


# The card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and device memory.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Float32 operations that a ray-sphere test needs: the discriminant.  K1/K4
# (the centered quadratic of k1_render.cu's and k4_sweep_record.cu's sweep):
# oc 3, hb 5, cq 6, disc 2.  K2 (k2_record.cu, the expanded quadratic): c.d
# 5, o.c 5, half_b 1, cq 3, disc 2.  The root is needed only where disc > 0
# (a small share of the tests) and is not counted, although K2 executes its
# sqrtf and both roots for every sphere: the bound counts what the function
# needs, not what a kernel chooses to execute.
SWEEP_FLOPS = {"k1": 16, "k4": 16, "k2": 16}
# Per executed round (hit frame, scatter, sky; ~40 + ~70 + ~10) and per path
# (the thin-lens camera ray), from common.cuh.
ROUND_FLOPS = 120
CAMERA_FLOPS = 70
# K3 (k3_replay_grad.cu): per hit bounce, one hit_forward (~90) and its
# hit_adjoint (~110); per path, the camera ray and its adjoint (~150) and
# the sky's.  The kernel runs hit_forward a second time in its reverse
# sweep: a recompute it chose instead of storing, so not counted.
K3_HIT_FLOPS = 200
K3_PATH_FLOPS = 160


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    """{"bound_ms", "bound_by"} of work that needs `flops` operations (of
    float32 unless `peak_flops` says otherwise) and moves `nbytes` bytes."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def forward_bound(kind, n_spheres, n_pix, spp, depth, rounds, res_streams=0):
    """Bound of a forward kernel (K1, K2 or K4) that executed `rounds`
    (path, bounce) rounds over `n_pix` pixels: the sweep over every sphere
    per round plus shading, against the tables in, the image (and K1's
    pids in and len out) and `res_streams` int16 residual streams out."""
    flops = (rounds * (n_spheres * SWEEP_FLOPS[kind] + ROUND_FLOPS)
             + n_pix * spp * CAMERA_FLOPS)
    nbytes = (n_spheres * 48 + 64 + n_pix * 12
              + (n_pix * 8 if kind == "k1" else 0)
              + res_streams * 2 * spp * depth * n_pix)
    return bound(flops, nbytes)


def culled_bound(n_spheres, n_chunks, chunk, n_prio, n_pix, spp, rounds,
                 live):
    """Bound of K1's culled launch that executed `rounds` rounds and found
    `live` chunks live over them (its live count): per round, the test of
    every chunk's bound and of every priority row, shading, and the sweep
    of the live chunks' members, counted as live x chunk less a short last
    chunk once a round (so never more than were swept); against the rows,
    bounds, priority rows and members in, pids in and fb and len out."""
    members = max(live * chunk - rounds * (n_chunks * chunk - n_spheres), 0)
    flops = ((rounds * (n_chunks + n_prio) + members) * SWEEP_FLOPS["k1"]
             + rounds * ROUND_FLOPS + n_pix * spp * CAMERA_FLOPS)
    nbytes = (n_spheres * 52 + (n_chunks + n_prio) * 16 + 64 + n_pix * 12
              + n_pix * 8)
    return bound(flops, nbytes)


def k3_bound(n_spheres, n_pix, spp, depth, hits, res_streams):
    """Bound of K3 on residuals with `hits` recorded hit bounces: reads the
    residual streams, g and the table; writes float64 d_table and d_cam."""
    flops = hits * K3_HIT_FLOPS + n_pix * spp * K3_PATH_FLOPS
    nbytes = (res_streams * 2 * spp * depth * n_pix + n_pix * 12
              + n_spheres * 44 + 64 + n_spheres * 88 + 128)
    return bound(flops, nbytes)


def k1_rounds(scene, cam, cfg, frame=0, sample_base=0):
    """Executed (path, bounce) rounds of `cfg`'s frame: the sum of K1's
    `len` output over the frame's pixels."""
    import torch

    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    geom, attr = k1._scene_tables(scene)
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                        device=scene.device)
    _, ln = k1.render_lanes(geom, attr, cam.pack().contiguous(), pids,
                            frame_seed(cfg, frame), sample_base,
                            cfg.samples_per_pixel, cfg.max_depth, cfg.t_min,
                            cfg.width, cfg.height)
    return float(ln[:cfg.num_pixels].sum())


def kernel_entry(name, source, replaces, launches, ks, library_ms=None):
    """A kernel's line of the {"kernels": [...]} object from its checks
    `ks`; the first check gives the headline ms, plain_ms and bound."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in ks),
            "ms": ks[0]["ms"], "plain_ms": ks[0]["plain_ms"],
            "bound_ms": ks[0]["bound_ms"], "bound_by": ks[0]["bound_by"],
            "library_ms": library_ms, "checks": ks}


def p1_inputs():
    """{label: (x float32 [8, 128], the rounds P1 must run)}: the
    reference's x = 0 and inputs whose lanes die in different rounds, in
    one round, or at once (a NaN lane: `a < 50` is false)."""
    import numpy as np

    seeded = np.random.RandomState(7).uniform(0.0, 40.0, (8, 128)).astype(
        np.float32)
    apart = np.zeros((8, 128), np.float32)
    apart.reshape(-1)[:32] = 49.5  # warp 0 dies in round 1, the rest in 50
    survivor = np.full((8, 128), 49.5, np.float32)
    survivor.reshape(-1)[1023] = 0.0
    high = np.random.RandomState(8).uniform(49.0, 60.0, (8, 128)).astype(
        np.float32)
    nan = seeded.copy()
    nan[3, 77] = np.nan
    after = int(np.ceil(50.0 - float(seeded.min())))
    return {"x = 0 (the reference's)": (np.zeros((8, 128), np.float32), 50),
            "seeded x in [0, 40)": (seeded, after),
            "warp 0 at 49.5, the rest at 0": (apart, 50),
            "one survivor, lane 1023 at 0": (survivor, 50),
            "every lane at x >= 49": (high, 1),
            "a NaN lane among seeded x": (nan, after)}


def p2_inputs():
    """{label: (a [M, K], b [K, N]) float32}: the reference's product and a
    seeded one with K = 48 (three K steps)."""
    import numpy as np

    rs = np.random.RandomState(1024 + 48 + 1024)
    return {"[1024,16] @ [16,1024] (the reference's)": (
                np.random.RandomState(0).randn(1024, 16).astype(np.float32),
                np.random.RandomState(1).randn(16, 1024).astype(np.float32)),
            "[1024,48] @ [48,1024] seeded": (
                rs.randn(1024, 48).astype(np.float32),
                rs.randn(48, 1024).astype(np.float32))}


def sha256(*tensors):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy())
    return h.hexdigest()[:16]


def ptxas_summary(text):
    """{kernel<template args>: ptxas's registers, stack frame, spill stores
    and loads, static shared memory} from an `nvcc -Xptxas -v` log."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'_Z\w*?\d+(k\w+?_kernel)I(\w+?)EEEv", line)
        if m:
            args = ",".join("true" if b == "1" else "false"
                            for b in re.findall(r"Lb([01])E", m.group(2) + "E"))
            name = f"{m.group(1)}<{args}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             smem=int(smem.group(1)) if smem else 0)
    return out


def recovery_phase(dev, smi, cli_problem):
    """Phase 11: the inverse-rendering path recovers the ball, (a) on the
    reference test's problem through the wavefront, K2 and K4, (b) on the
    `cli inverse` problem through K2 (`cli_problem`, phase 10's
    `cli_inverse_problem(dev)`) and K4.  Returns (the launches of K2, K3
    and K4 over both parts, the numbers each run reached)."""
    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch.inverse import optimize
    from bevy_raytrace_tpu_torch.profile_grad import (
        RECOVERY_BARS,
        _profile,
        ball_errors,
        ball_inverse_problem,
        cli_inverse_problem,
    )

    kernels = ("k2", "k3", "k4")
    total = dict.fromkeys(kernels, 0)

    def run(label, make_problem, forward, steps, lr, tail):
        """`steps` Adam steps through `forward` on the problem
        `make_problem()` gives, counted and timed; the bars checked with
        the mean of the last `tail` losses."""
        t0 = time.perf_counter()
        scene_bad, scene_true, problem = make_problem()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        zero_launches(*kernels)
        t0 = time.perf_counter()
        result = optimize(scene_bad, problem, steps=steps, learning_rate=lr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches_of(kernels)
        renders = 2 * steps
        want = {"k2": renders if forward == "pallas" else 0,
                "k3": 0 if forward == "wavefront" else renders,
                "k4": renders if forward == "sweep" else 0}
        for k, v in got.items():
            total[k] += v
        losses = result.losses
        last = float(np.mean(losses[-tail:]))
        err0, alb0 = ball_errors(scene_bad, scene_true)
        err1, alb1 = ball_errors(result.scene, scene_true)
        cfg = problem.config
        out = {"first_loss": losses[0], "last_loss": losses[-1],
               f"last{tail}_mean": last, "center_error": [err0, err1],
               "albedo_error": [alb0, alb1], "s_per_step": secs / steps,
               "paths_per_s": renders * cfg.rays_per_frame / secs,
               "setup_s": setup_s, "launches": got}
        log(f"[recovery] {label}, {forward}: {cfg.width}x{cfg.height}x"
            f"{cfg.samples_per_pixel} depth {cfg.max_depth}, {steps} steps "
            f"at lr {lr}: loss {losses[0]:.6f} -> {losses[-1]:.6f} (mean of "
            f"the last {tail} {last:.6f}, {last / losses[0]:.4f}x); center "
            f"error {err0:.5f} -> {err1:.5f} ({err1 / err0:.4f}x); albedo "
            f"error {alb0:.4f} -> {alb1:.4f}; {secs / steps * 1e3:.2f} "
            f"ms/step, {out['paths_per_s'] / 1e6:.1f}M paths/s (2 renders "
            f"a step); set-up {setup_s:.2f} s; launches {got} on {smi}")
        check(all(np.isfinite(losses)) and len(losses) == steps,
              f"recovery {label} {forward}: losses {losses}")
        check(got == want, f"recovery {label} {forward}: launches {got}, "
              f"expected {want}")
        check(last < RECOVERY_BARS["loss"] * losses[0]
              and err1 < RECOVERY_BARS["center"] * err0
              and alb1 < RECOVERY_BARS["albedo"],
              f"recovery {label} {forward} missed the reference's bars "
              f"{RECOVERY_BARS}: {out}")
        return out, scene_bad, problem

    # (a) the reference test's problem.
    small = {fw: run("the reference test's problem",
                     lambda: ball_inverse_problem(dev, forward=fw), fw, 80,
                     1e-2, 1)[0]
             for fw in ("wavefront", "pallas", "sweep")}

    # (b) the `cli inverse` problem at its defaults (K2's is phase 10's),
    # with one more step of each recorder profiled after the counted run.
    full = {}
    for fw, make in (("pallas", lambda: cli_problem),
                     ("sweep", lambda: cli_inverse_problem(dev,
                                                           forward="sweep"))):
        full[fw], scene_bad, problem = run(
            "the cli inverse problem", make, fw, 120, 1.5e-2, 10)
        full[fw]["profile"] = _profile(
            f"recovery_{fw}", lambda: optimize(scene_bad, problem, steps=1,
                                               learning_rate=1.5e-2), None)
    m2, m4 = full["pallas"]["last10_mean"], full["sweep"]["last10_mean"]
    log(f"[recovery] the cli inverse problem, last-10 mean loss: K2 "
        f"{m2:.6f}, K4 {m4:.6f} ({m4 / m2 - 1:+.2%}); s/step K2 "
        f"{full['pallas']['s_per_step']:.4f}, K4 "
        f"{full['sweep']['s_per_step']:.4f}")
    check(abs(m4 - m2) <= 0.1 * m2,
          f"K4's last-10 mean loss {m4} is not within 10% of K2's {m2}")
    return total, {"reference_problem": small, "cli_problem": full}


def gradient_phases(dev, smi):
    """Phases 7-13: K2 and K3, and the inverse-rendering path through them.
    Returns (K2's and K3's launch counts over the path, extra stats, and
    what the sharded phases reuse, the kernels' checks among it)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.core.camera import Camera
    from bevy_raytrace_tpu_torch.core.types import make_scene
    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        optimize,
        replay_image,
    )
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import replay_grad as k3
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare, grad_close
    from bevy_raytrace_tpu_torch.profile_grad import (
        cli_inverse_problem,
        random_scene,
    )
    from bevy_raytrace_tpu_torch.utils import spans

    # ---- 7. build K2 and K3 ----------------------------------------------
    names = ["k2_record", "k3_replay_grad", "k4_sweep_record"]
    t0 = time.perf_counter()
    build.load_all(names)
    build_s = time.perf_counter() - t0
    for name in names:
        secs, out = build.BUILD_LOG.get(name, (0.0, ""))
        log(f"[build] {name}: nvcc {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] k2 + k3 + k4 in {build_s:.2f} s (in parallel)")

    # ---- 8-9. K2 and K3 against their twins --------------------------------
    checks = {"k2": [], "k3": []}

    def k2_check(label, table, cam16, cfg, rounds, sample_base=0,
                 with_residuals=True, record_second=False, clusters=None):
        """K2 vs its twin on one input: image under COMPILED, at most 2% of
        residual entries differing.  `rounds`: the executed rounds of this
        input, for the bound (the same with or without `clusters`: the
        bound counts a test of every sphere, whatever a kernel skips).
        Returns the kernel's outputs."""
        kw = dict(sample_base=sample_base, with_residuals=with_residuals,
                  record_second=record_second, clusters=clusters)
        ms, (img, res, res2) = cuda_ms(
            lambda: k2.record_frame(table, cam16, cfg, 1, **kw), 3)
        plain_ms, (pimg, pres, pres2) = cuda_ms(
            lambda: k2.record_frame_plain(table, cam16, cfg, 1, **kw), 1,
            warm=False)
        img_vs = compare(img.cpu().numpy(), pimg.cpu().numpy(), COMPILED)
        off = [float((a != b).float().mean())
               for a, b in ((res, pres), (res2, pres2)) if a is not None]
        log(f"[k2] {label}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms; "
            f"image vs twin {img_vs}; residuals differing: "
            f"{[f'{o:.5%}' for o in off]}")
        check(img_vs["ok"], f"K2 {label}: image vs twin {img_vs}")
        check(all(o <= 0.02 for o in off),
              f"K2 {label}: residuals differ from the twin's on {off}")
        check(res is None or res.dtype == torch.int16,
              "residuals are not int16")
        checks["k2"].append({
            "shape": label, "max_abs_err": img_vs["max_abs_err"],
            "residuals_off": off, "ms": ms, "plain_ms": plain_ms,
            **forward_bound("k2", table.shape[0], cfg.num_pixels,
                            cfg.samples_per_pixel, cfg.max_depth, rounds,
                            int(with_residuals) + int(record_second))})
        return img, res, res2

    def cotangents_vs(got, want):
        """grad_close of (d_table, d_cam) against `want`'s, both arrays to
        rtol 2e-3 of the larger max-abs."""
        glob = max(float(want[0].abs().max()), float(want[1].abs().max()))
        return [grad_close(a.cpu(), b.cpu(), glob=glob)
                for a, b in zip(got, want)]

    def k3_check(label, table, cam16, cfg, res, res2, sample_base=0,
                 against_global=False):
        """K3 vs its twin on recorded residuals with a seeded cotangent:
        d_table and d_cam to rtol 2e-3 of the larger max-abs.  The launch
        takes the table mode replay_grad picks for this table; with
        `against_global` the global mode is also forced on the same inputs
        and held against the twin and against the picked mode."""
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (cfg.height, cfg.width, 3)).astype(np.float32)).to(dev)
        mode = k3._table_mode(table)
        ms, got = cuda_ms(
            lambda: k3.replay_grad(table, cam16, cfg, res, g, 1, sample_base,
                                   res2=res2), 3)
        plain_ms, want = cuda_ms(
            lambda: k3.replay_grad_plain(table, cam16, cfg, res, g, 1,
                                         sample_base, res2=res2), 1,
            warm=False)
        tbl_vs, cam_vs = cotangents_vs(got, want)
        log(f"[k3] {label}: {mode} table, kernel {ms:.3f} ms, twin "
            f"{plain_ms:.1f} ms; d_table vs twin {tbl_vs}, d_cam vs twin "
            f"{cam_vs}")
        check(tbl_vs["ok"] and cam_vs["ok"],
              f"K3 {label}: cotangents disagree with the twin's (rtol 2e-3)")
        entry = {
            "shape": label, "mode": mode,
            "rel_err": [tbl_vs["rel_err"], cam_vs["rel_err"]],
            "max_abs_err": max(tbl_vs["max_abs_err"], cam_vs["max_abs_err"]),
            "ms": ms, "plain_ms": plain_ms,
            **k3_bound(table.shape[0], cfg.num_pixels, cfg.samples_per_pixel,
                       cfg.max_depth, int((res >= 0).sum()),
                       1 if res2 is None else 2)}
        if against_global:
            glob_ms, forced = cuda_ms(lambda: k3._launch(
                k3._k3_launcher(), table, cam16, cfg, res, g, 1, sample_base,
                res2, table_mode="global"), 3)
            vs_twin, vs_mode = cotangents_vs(forced, want), cotangents_vs(
                forced, got)
            log(f"[k3] {label}: global table forced {glob_ms:.3f} ms; vs "
                f"twin {vs_twin}; vs the {mode} table {vs_mode}")
            check(all(v["ok"] for v in vs_twin + vs_mode),
                  f"K3 {label}: the global table disagrees with the twin or "
                  f"the {mode} table")
            entry["global_forced"] = {
                "ms": glob_ms, "max_abs_err": max(
                    v["max_abs_err"] for v in vs_twin + vs_mode)}
        checks["k3"].append(entry)

    # The gradient bench's shape (400x300, 16 spp, depth 8, rtiow_final),
    # with edge_softness 0.01 (the inverse path's instantiations: runner-up
    # recorded, the silhouette adjoint) and 0 (the flagship gradient's).
    cfg = RenderConfig(width=400, height=300, samples_per_pixel=16,
                       max_depth=8, edge_softness=0.01)
    cfg0 = cfg.replace(edge_softness=0.0)
    scene = scenes.rtiow_final_scene(0)[0]  # the default device: the card
    cam = scenes.rtiow_final_camera(cfg.aspect)
    check(scene.device.type == "cuda" and cam.origin.device.type == "cuda",
          "the scene constructors' default device is not the card")
    table, cam16 = k2._operands(scene, cam)
    bench = f"rtiow {cfg.width}x{cfg.height}x{cfg.samples_per_pixel} depth 8"
    bench_rounds = k1_rounds(scene, cam, cfg, 1)
    img, res, res2 = k2_check(f"{bench} record_second", table, cam16, cfg,
                              bench_rounds, record_second=True)
    with torch.no_grad():
        rep = replay_image(scene, cam, cfg, res, 1, res2=res2)
    rep_vs = compare(rep.cpu().numpy(), img.cpu().numpy(), COMPILED)
    log(f"[k2] torch replay of the kernel's residuals vs its image {rep_vs}")
    check(rep_vs["ok"], f"replay does not reconstruct the K2 image {rep_vs}")
    k3_check(f"{bench} edge 0.01", table, cam16, cfg, res, res2,
             against_global=True)
    del res, res2
    _, res, _ = k2_check(f"{bench} record", table, cam16, cfg0, bench_rounds)
    k2_check(f"{bench} value only", table, cam16, cfg0, bench_rounds,
             with_residuals=False)
    k3_check(f"{bench} edge 0", table, cam16, cfg0, res, None)
    del res

    # A 2-sample slice of the flagship gradient (1200x800, samples 128-129
    # through sample_base, as grad_spp_chunk's re-recording runs them).
    sl = RenderConfig(width=1200, height=800, samples_per_pixel=2,
                      max_depth=8)
    sl_cam = scenes.rtiow_final_camera(sl.aspect)
    sl_table, sl_cam16 = k2._operands(scene, sl_cam)
    label = "rtiow 1200x800 samples 128-129 depth 8"
    sl_rounds = k1_rounds(scene, sl_cam, sl, 1, 128)
    _, res, _ = k2_check(f"{label} record", sl_table, sl_cam16, sl, sl_rounds,
                         128)
    k2_check(f"{label} value only", sl_table, sl_cam16, sl, sl_rounds, 128,
             with_residuals=False)
    k3_check(f"{label} edge 0", sl_table, sl_cam16, sl, res, None, 128)
    del res

    # Hot rows: config1 (2 spheres and the ground) at the `cli inverse`
    # frame, 2 samples, edge 0.01: nearly every lane of a warp adds into one
    # of 3 rows, the case K3's warp aggregation is for.
    hot = sl.replace(edge_softness=0.01)
    hot_scene = scenes.baseline_config1_scene()[0]
    hot_cam = scenes.baseline_config1_camera(hot.aspect)
    hot_table, hot_cam16 = k2._operands(hot_scene, hot_cam)
    label = "config1 1200x800x2 depth 8 edge 0.01 (hot rows)"
    _, res, res2 = k2_check(label, hot_table, hot_cam16, hot,
                            k1_rounds(hot_scene, hot_cam, hot, 1),
                            record_second=True)
    k3_check(label, hot_table, hot_cam16, hot, res, res2)
    del res, res2

    # Large tables: 2,000 seeded spheres take a 144 KB block table (above
    # the 48 KB a launch gets without asking), held against the global mode
    # too; 4,096 are above a block's shared memory, so K3 takes its global
    # table (and K2 stages 64 KB of rows).
    small = RenderConfig(width=320, height=240, samples_per_pixel=4,
                         max_depth=8, edge_softness=0.01)
    big_cam = scenes.rtiow_final_camera(small.aspect)
    for n, mode in ((2000, "shared"), (4096, "global")):
        big_scene = random_scene(n)
        big_table, big_cam16 = k2._operands(big_scene, big_cam)
        label = f"random {n} spheres {small.width}x{small.height}x4 depth 8"
        _, res, res2 = k2_check(label, big_table, big_cam16, small,
                                k1_rounds(big_scene, big_cam, small, 1),
                                record_second=True)
        check(k3._table_mode(big_table) == mode,
              f"a {n}-sphere table did not take K3's {mode} mode")
        k3_check(label, big_table, big_cam16, small, res, res2,
                 against_global=mode == "shared")
        del res, res2

    # K2 on its own edges: a tangent ray (disc == 0 exactly: every camera
    # ray runs from (1, 0, 0) along (0, 0, -1), grazing the sphere at
    # (0, 0, -5) of radius 1) is a hit at every first bounce; 15,000
    # spheres (240,000 bytes of rows) are read from device memory.
    tan = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=3)
    tan_scene = make_scene([[0.0, 0.0, -5.0]], [1.0], [0], [[0.5, 0.6, 0.7]],
                           [0], [0.0], [1.5])
    tan_cam = Camera.from_packed(torch.tensor(
        [1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
         0.0, 1.0], device=dev))
    tan_table, tan_cam16 = k2._operands(tan_scene, tan_cam)
    _, res, _ = k2_check("tangent ray 64x32x2 depth 3", tan_table, tan_cam16,
                         tan, k1_rounds(tan_scene, tan_cam, tan, 1),
                         record_second=True)
    check(bool((res[:, 0] == 0).all()), "K2 missed the tangent hit")
    huge_scene = random_scene(15000, seed=1)
    huge = RenderConfig(width=64, height=48, samples_per_pixel=2, max_depth=3)
    huge_cam = scenes.rtiow_final_camera(huge.aspect)
    huge_table, huge_cam16 = k2._operands(huge_scene, huge_cam)
    k2_check("random 15000 spheres 64x48x2 depth 3", huge_table, huge_cam16,
             huge, k1_rounds(huge_scene, huge_cam, huge, 1),
             record_second=True)
    del res

    # ---- 10. inverse rendering at the CLI's size --------------------------
    zero_launches("k2", "k3")
    scene_bad, scene_true, problem = cli_inverse_problem(dev)
    inv_cfg = problem.config
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck3 = os.path.join(tmp, "inverse.npz"), os.path.join(tmp, "s3.npz")
        t0 = time.perf_counter()
        first = optimize(scene_bad, problem, steps=3, learning_rate=1.5e-2,
                         checkpoint_path=ck, checkpoint_every=3)
        shutil.copy(ck, ck3)
        rest = optimize(scene_bad, problem, steps=6, learning_rate=1.5e-2,
                        checkpoint_path=ck, checkpoint_every=3)
        torch.cuda.synchronize()
        inv_s = time.perf_counter() - t0
        again = optimize(scene_bad, problem, steps=6, learning_rate=1.5e-2,
                         checkpoint_path=ck3, checkpoint_every=100)
    losses = first.losses + rest.losses
    step_s = inv_s / len(losses)
    inv_pps = 2 * inv_cfg.rays_per_frame / step_s
    log(f"[inverse] {inv_cfg.width}x{inv_cfg.height}x"
        f"{inv_cfg.samples_per_pixel} depth {inv_cfg.max_depth}, config1: "
        f"losses {[f'{v:.6f}' for v in losses]}; resumed from step 3 again: "
        f"{[f'{v:.6f}' for v in again.losses]}; {step_s:.3f} s/step, "
        f"{inv_pps / 1e6:.1f}M paths/s (2 renders per step) on {smi}")
    log(f"[inverse] center {rest.scene.centers[1].tolist()} (true "
        f"{scene_true.centers[1].tolist()}), albedo "
        f"{rest.scene.materials.albedo[1].tolist()} (true "
        f"{scene_true.materials.albedo[1].tolist()})")
    check(len(losses) == 6 and all(np.isfinite(losses)),
          f"inverse losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(np.allclose(again.losses, rest.losses, rtol=1e-2, atol=1e-7),
          f"resuming the step-3 checkpoint twice disagrees: {rest.losses} "
          f"vs {again.losses}")

    # ---- 11. recovery through both recorders ------------------------------
    counts = spans.counters()
    t0 = time.perf_counter()
    rec_launches, rec_stats = recovery_phase(
        dev, smi, (scene_bad, scene_true, problem))
    rec_stats["phase_s"] = time.perf_counter() - t0
    log(f"[time] phase 11 in {rec_stats['phase_s']:.1f} s")
    spans.reset_counters()
    for name, n in counts.items():
        spans.count(name, n)

    # ---- 12. the flagship gradient ----------------------------------------
    big = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                       max_depth=8)
    cam_big = scenes.rtiow_final_camera(big.aspect)

    def flagship_grad(render_fn):
        c = scene.centers.clone().requires_grad_(True)
        loss = torch.mean(render_fn(dataclasses.replace(scene, centers=c),
                                    cam_big, 1) ** 2)
        (grad,) = torch.autograd.grad(loss, c)
        return grad

    flag = {}
    for label, chunk in (("unchunked", 0), ("chunk64", 64)):
        render_fn = make_fast_renderer(big, grad_spp_chunk=chunk)
        flagship_grad(render_fn)  # warm-up: allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad = flagship_grad(render_fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        flag[label] = (grad, secs, big.rays_per_frame / secs)
        log(f"[flagship grad] {label}: {secs:.3f} s/step, "
            f"{big.rays_per_frame / secs / 1e6:.1f}M paths/s fwd+bwd "
            f"(1200x800x256 depth 8, {scene.count} spheres) on {smi}")
    (g_full, _, _), (g_chunk, _, _) = flag["unchunked"], flag["chunk64"]
    check(bool(torch.isfinite(g_full).all()), "flagship gradient not finite")
    fl_vs = grad_close(g_chunk.cpu(), g_full.cpu())
    log(f"[flagship grad] chunked vs unchunked {fl_vs}")
    check(fl_vs["ok"], "chunked flagship gradient disagrees with the unchunked")

    # ---- 13. launches -----------------------------------------------------
    k2_launches = spans.counter("k2.launches")
    k3_launches = spans.counter("k3.launches")
    k3_modes = {"shared": k3_launches - spans.counter("k3.launches_global"),
                "global": spans.counter("k3.launches_global")}
    log(f"[launches] k2_record launches={k2_launches}, k3_replay_grad "
        f"launches={k3_launches} ({k3_modes}) over phases 10 and 12")
    check(k2_launches > 0 and k3_modes["shared"] > 0,
          "K2 or K3 (shared table) was not launched by the inverse-rendering "
          "path")

    # The gradient of a scene above a block's shared memory (the 4,096
    # seeded spheres) through make_fast_renderer: K3's global table on the
    # path, one launch of each kernel, held against backward="torch" (the
    # torch replay of the same K2 residuals).
    def big_grad(backward):
        c = big_scene.centers.clone().requires_grad_(True)
        img = make_fast_renderer(small, backward=backward)(
            dataclasses.replace(big_scene, centers=c), big_cam, 1)
        return torch.autograd.grad(torch.mean(img ** 2), c)[0]

    zero_launches("k2", "k3")
    g_big = big_grad("kernel")
    big_launches = (spans.counter("k2.launches"),
                    spans.counter("k3.launches"),
                    spans.counter("k3.launches_global"))
    k3_modes["global"] += big_launches[2]
    big_vs = grad_close(g_big.cpu(), big_grad("torch").cpu())
    log(f"[big scene grad] {big_scene.count} spheres, {small.width}x"
        f"{small.height}x{small.samples_per_pixel} depth {small.max_depth}: "
        f"launches (K2, K3, K3 global) {big_launches}; vs backward='torch' "
        f"{big_vs}")
    check(big_launches == (1, 1, 1) and bool(torch.isfinite(g_big).all())
          and big_vs["ok"],
          f"the large-scene gradient: launches {big_launches}, {big_vs}")

    launches = {"k2": k2_launches, "k3": k3_launches, "k3_modes": k3_modes,
                "recovery": rec_launches}
    stats = {"grad_build_s": build_s, "inverse_losses": losses,
             "recovery": rec_stats,
             "inverse_s_per_step": step_s, "inverse_paths_per_s": inv_pps,
             "flagship_grad_s": {k: v[1] for k, v in flag.items()},
             "flagship_grad_paths_per_s": {k: v[2] for k, v in flag.items()}}
    shared = {"scene": scene, "cam": cam, "cfg": cfg, "cfg0": cfg0,
              "table": table, "cam16": cam16, "bench": bench,
              "bench_rounds": bench_rounds, "sl": sl, "sl_table": sl_table,
              "sl_cam16": sl_cam16, "sl_rounds": sl_rounds, "big": big,
              "cam_big": cam_big, "flagship_grad": flagship_grad,
              "g_full": g_full, "k3_check": k3_check, "k2_check": k2_check,
              "checks": checks, "inverse_scene": rest.scene,
              "huge_cfg": huge, "huge_scene": huge_scene,
              "huge_cam": huge_cam,
              "huge_operands": (huge_table, huge_cam16)}
    return launches, stats, shared


def sharded_phases(dev, smi, shared, ref):
    """Phases 14-17: K4, the stripe modes, and the sharded gradient path.
    `shared` comes from `gradient_phases`, `ref` holds the reference frame's
    scene, camera and config.  Returns (launch counts over the sharded path,
    extra stats); K4's checks join `shared["checks"]`."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        make_fast_renderer_sharded,
        replay_image,
    )
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels import replay_grad as k3
    from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
    from bevy_raytrace_tpu_torch.kernels.sweep_record import (
        render_sweep_record,
    )
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare, grad_close
    from bevy_raytrace_tpu_torch.shard import (
        initialize_multihost,
        make_mesh,
        render_mxu_sharded,
    )
    from bevy_raytrace_tpu_torch.utils import spans
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    scene, cam = shared["scene"], shared["cam"]
    table, cam16 = shared["table"], shared["cam16"]
    cfg, cfg0, bench = shared["cfg"], shared["cfg0"], shared["bench"]
    checks = shared["checks"]
    checks["k4"] = []

    # ---- 14. K4 against its twin ------------------------------------------
    def k4_check(label, table, cam16, cfg, rounds, sample_base=0,
                 record_second=False):
        """K4 vs its twin on one input: image under COMPILED, at most 2% of
        residual entries differing.  Returns the kernel's outputs."""
        kw = dict(sample_base=sample_base, record_second=record_second)
        mode = k4.forward_table_mode("k4_sweep_record", dev, table.shape[0])
        ms, (img, res, res2) = cuda_ms(
            lambda: k4.sweep_record_frame(table, cam16, cfg, 1, **kw), 3)
        plain_ms, (pimg, pres, pres2) = cuda_ms(
            lambda: k4.sweep_record_frame_plain(table, cam16, cfg, 1, **kw),
            1, warm=False)
        img_vs = compare(img.cpu().numpy(), pimg.cpu().numpy(), COMPILED)
        off = [float((a != b).float().mean())
               for a, b in ((res, pres), (res2, pres2)) if a is not None]
        log(f"[k4] {label}: kernel ({mode} table) {ms:.3f} ms, twin "
            f"{plain_ms:.1f} ms; image vs twin {img_vs}; residuals "
            f"differing: {[f'{o:.5%}' for o in off]}")
        check(img_vs["ok"], f"K4 {label}: image vs twin {img_vs}")
        check(all(o <= 0.02 for o in off),
              f"K4 {label}: residuals differ from the twin's on {off}")
        check(res.dtype == torch.int16, "residuals are not int16")
        dead = torch.cummax((res < 0).int(), dim=1).values.bool()
        check(bool((res[dead] == -1).all()),
              f"K4 {label}: a dead path's later bounce is not -1")
        checks["k4"].append({
            "shape": label, "mode": mode, "max_abs_err": img_vs["max_abs_err"],
            "residuals_off": off, "ms": ms, "plain_ms": plain_ms,
            **forward_bound("k4", table.shape[0], cfg.num_pixels,
                            cfg.samples_per_pixel, cfg.max_depth, rounds,
                            1 + int(record_second))})
        return img, res, res2

    rounds = shared["bench_rounds"]
    img, res, res2 = k4_check(f"{bench} record_second", table, cam16, cfg,
                              rounds, record_second=True)
    with torch.no_grad():
        rep = replay_image(scene, cam, cfg, res, 1, res2=res2)
    rep_vs = compare(rep.cpu().numpy(), img.cpu().numpy(), COMPILED)
    log(f"[k4] torch replay of the kernel's residuals vs its image {rep_vs}")
    check(rep_vs["ok"], f"replay does not reconstruct the K4 image {rep_vs}")
    shared["k3_check"](f"{bench} edge 0.01 on K4's residuals", table, cam16,
                       cfg, res, res2)
    del res, res2, rep
    _, res, _ = k4_check(f"{bench} record", table, cam16, cfg0, rounds)
    shared["k3_check"](f"{bench} edge 0 on K4's residuals", table, cam16,
                       cfg0, res, None)
    del res
    sl = shared["sl"]
    label = "rtiow 1200x800 samples 128-129 depth 8"
    k4_check(f"{label} record", shared["sl_table"], shared["sl_cam16"], sl,
             shared["sl_rounds"], 128)
    # The same paths through the three forward kernels, one call each.
    geom, attr = k1._scene_tables(scene)
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                        device=dev)
    k1_ms, _ = cuda_ms(lambda: k1.render_lanes(
        geom, attr, cam16, pids, frame_seed(cfg, 1), 0, cfg.samples_per_pixel,
        cfg.max_depth, cfg.t_min, cfg.width, cfg.height), 3)
    forward_ms = {"k1": k1_ms,
                  "k2_record_second": checks["k2"][0]["ms"],
                  "k2_record": checks["k2"][1]["ms"],
                  "k4_record_second": checks["k4"][0]["ms"],
                  "k4_record": checks["k4"][1]["ms"]}
    log(f"[k4] {bench}, the same paths: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in forward_ms.items()) + f" on {smi}")

    # Each kernel's global table forced once against its staged table on
    # the same inputs: the same bits.
    k1_args = (geom, attr, cam16, pids, frame_seed(cfg, 1), 0,
               cfg.samples_per_pixel, cfg.max_depth, cfg.t_min, cfg.width,
               cfg.height)
    forced = {}
    for name, run in (
            ("k1", lambda m: k1.render_lanes(*k1_args, table_mode=m)),
            ("k4", lambda m: k4.sweep_record_frame(
                table, cam16, cfg, 1, record_second=True, table_mode=m))):
        glob_ms, glob = cuda_ms(lambda: run("global"), 3)
        shared_ms, staged = cuda_ms(lambda: run("shared"), 3)
        same = all(torch.equal(a, b) for a, b in zip(glob, staged))
        forced[name] = {"global_ms": glob_ms, "shared_ms": shared_ms,
                        "bit_identical": same}
        log(f"[{name}] {bench}: global table forced {glob_ms:.3f} ms, shared "
            f"{shared_ms:.3f} ms; bit-identical outputs: {same}")
        check(same, f"{name}: the global table's outputs differ from the "
                    f"shared table's")
        del glob, staged

    # ---- 15. stripe modes against the full launches -----------------------
    n = cfg.num_pixels
    local = n // 4
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    for name, record in (("k2", k2.record_frame),
                         ("k4", k4.sweep_record_frame)):
        img, res, res2 = record(table, cam16, cfg, 1, record_second=True)
        w_tbl, w_cam = k3.replay_grad(table, cam16, cfg, res, g, 1, res2=res2)
        d_tbl, d_cam = torch.zeros_like(w_tbl), torch.zeros_like(w_cam)
        for base in range(0, n, local):
            s_img, s_res, s_res2 = record(table, cam16, cfg, 1,
                                          record_second=True,
                                          pixel_base=base, num_local=local)
            span = slice(base, base + local)
            check(torch.equal(s_img, img.reshape(n, 3)[span])
                  and torch.equal(s_res, res[:, :, span])
                  and torch.equal(s_res2, res2[:, :, span]),
                  f"{name} stripe at {base} differs from its full launch")
            dt, dc = k3.replay_grad(table, cam16, cfg, s_res,
                                    g[span].contiguous(), 1, res2=s_res2,
                                    pixel_base=base, num_local=local)
            d_tbl, d_cam = d_tbl + dt, d_cam + dc
        glob = max(float(w_tbl.abs().max()), float(w_cam.abs().max()))
        tbl_vs = grad_close(d_tbl.cpu(), w_tbl.cpu(), glob=glob)
        cam_vs = grad_close(d_cam.cpu(), w_cam.cpu(), glob=glob)
        log(f"[stripes] {name}: 4 stripes of {bench} bit-identical to the "
            f"full launch; K3's stripes sum to the full d_table {tbl_vs}, "
            f"d_cam {cam_vs}")
        check(tbl_vs["ok"] and cam_vs["ok"],
              f"K3's stripes on {name}'s residuals do not sum to the full "
              f"cotangent")
        del img, res, res2

    # ---- 16. the sharded gradient path at full width ----------------------
    # What the sharded gradients are held against: the unsharded gradient
    # through the SAME recorder.  K2's is phase 12's; K4's is taken here,
    # before the path's counts are zeroed.  K2 and K4 round differently, so
    # they record different paths on ~0.1% of entries, the near-tangent and
    # near-tie ones, whose gradients are the estimate's heavy tail: the two
    # recorders' gradients agree in bulk only, under the JAX package's rule
    # for two backends on this scene (tests/test_fast_grad.py: the largest
    # error among the closest 98% of components is under 0.3 of the 99th
    # percentile of the reference's magnitudes).
    big, cam_big = shared["big"], shared["cam_big"]
    unsharded = {"pallas": shared["g_full"]}
    sweep_fn = make_fast_renderer(big, forward="sweep")
    shared["flagship_grad"](sweep_fn)  # warm-up: allocations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unsharded["sweep"] = shared["flagship_grad"](sweep_fn)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    err = (unsharded["sweep"] - unsharded["pallas"]).abs().flatten()
    trimmed = float(torch.sort(err).values[:int(0.98 * err.numel())].max())
    p99 = float(torch.quantile(unsharded["pallas"].abs().flatten(), 0.99))
    log(f"[flagship grad] forward=sweep unsharded: {sweep_s:.3f} s/step, "
        f"{big.rays_per_frame / sweep_s / 1e6:.1f}M paths/s fwd+bwd on {smi}; "
        f"vs forward=pallas: largest error of the closest 98% of components "
        f"{trimmed:.3e} against p99 magnitude {p99:.3e}, largest error "
        f"{float(err.max()):.3e}")
    check(bool(torch.isfinite(unsharded["sweep"]).all())
          and trimmed < 0.3 * p99,
          "the K4-recorded flagship gradient disagrees with the K2-recorded "
          "one in bulk")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0)
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.device.type == "cuda"
          and mesh.distributed and mesh.world_size == 1,
          f"the process group is not nccl on the card: {mesh}")
    log(f"[sharded] torch.distributed group: backend {dist.get_backend()}, "
        f"world size {mesh.world_size}, mesh {mesh.hosts}x{mesh.chips}, "
        f"device {mesh.device}")
    zero_launches("k1", "k2", "k3", "k4")

    sharded = {}
    for forward in ("pallas", "sweep"):
        render_fn = make_fast_renderer_sharded(big, mesh, forward=forward)

        def gathered(sc, c, frame, render_fn=render_fn):
            return render_fn(sc, c, frame, gather=True)

        shared["flagship_grad"](gathered)  # warm-up: allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad = shared["flagship_grad"](gathered)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        vs = grad_close(grad.cpu(), unsharded[forward].cpu())
        stats = dict(render_fn.stats)
        sharded[forward] = {"s": secs, "vs_unsharded": vs, **stats,
                            "paths_per_s": big.rays_per_frame / secs}
        log(f"[sharded grad] forward={forward}: {secs:.3f} s/step, "
            f"{big.rays_per_frame / secs / 1e6:.1f}M paths/s fwd+bwd "
            f"(1200x800x256 depth 8, {scene.count} spheres, world size 1) "
            f"on {smi}; vs the unsharded gradient {vs}; all-reduces "
            f"{stats['all_reduces']} (2 steps), {stats['all_reduce_bytes']} "
            f"B each")
        check(bool(torch.isfinite(grad).all()) and vs["ok"],
              f"sharded flagship gradient (forward={forward}) disagrees with "
              f"the unsharded one through the same recorder")
        check(stats["all_reduces"] == 2 and stats["all_reduce_bytes"]
              == (11 * scene.count + 16) * 4,
              f"the fast backward's all-reduce count or payload: {stats}")
        del grad

    t0 = time.perf_counter()
    flag_img = render_mxu_sharded(scene, cam_big, big, mesh, 0, balance=True,
                                  gather=True)
    torch.cuda.synchronize()
    mxu_s = time.perf_counter() - t0

    ref_scene, ref_cam, ref_cfg = ref
    r = Renderer(ref_cfg, backend="cuda-sharded", mesh=mesh)
    frame_ms = []
    for frame in range(2):
        t0 = time.perf_counter()
        img = r.render_frame(ref_scene, ref_cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": spans.counter("k1.launches"),
                "k2": spans.counter("k2.launches"),
                "k3": spans.counter("k3.launches"),
                "k4": spans.counter("k4.launches")}
    k4_modes = {"shared": launches["k4"]
                - spans.counter("k4.launches_global"),
                "global": spans.counter("k4.launches_global")}
    dist.destroy_process_group()
    # The unsharded renders they are held against (launched after the
    # path's counts were read).
    check(torch.equal(flag_img, k1.render_mxu(scene, cam_big, big)),
          "render_mxu_sharded(balance=True) differs from render_mxu")
    log(f"[sharded] render_mxu_sharded(balance=True) on the flagship frame: "
        f"{mxu_s:.3f} s, bit-identical to render_mxu")
    check(torch.equal(img, k1.render_mxu(ref_scene, ref_cam, ref_cfg, 1)),
          'Renderer(backend="cuda-sharded") differs from render_mxu')
    log('[sharded] Renderer(backend="cuda-sharded") reference frames, '
        "bit-identical to render_mxu: "
        + ", ".join(f"{m:.2f} ms" for m in frame_ms))
    del flag_img

    # ---- 17. launches -----------------------------------------------------
    log(f"[launches] over the sharded path: {launches}; K4 by table mode "
        f"{k4_modes}")
    check(all(v > 0 for v in launches.values()) and k4_modes["shared"] > 0,
          f"a kernel was not launched by the sharded path: {launches}, "
          f"{k4_modes}")

    # K4's global table on its entry point: 15,000 seeded spheres through
    # render_sweep_record, counted, and held against the twin.
    huge_cfg = shared["huge_cfg"]
    huge_scene, huge_cam = shared["huge_scene"], shared["huge_cam"]
    zero_launches("k4")
    img, res, res2 = render_sweep_record(huge_scene, huge_cam, huge_cfg, 1,
                                         record_second=True)
    huge_counts = (spans.counter("k4.launches"),
                   spans.counter("k4.launches_global"))
    k4_modes["global"] += huge_counts[1]
    table, cam16 = shared["huge_operands"]
    pimg, pres, pres2 = k4.sweep_record_frame_plain(table, cam16, huge_cfg, 1,
                                                    record_second=True)
    huge_vs = compare(img.cpu().numpy(), pimg.cpu().numpy(), COMPILED)
    off = [float((a != b).float().mean())
           for a, b in ((res, pres), (res2, pres2))]
    log(f"[k4] render_sweep_record on 15000 spheres {huge_cfg.width}x"
        f"{huge_cfg.height}x2 depth 3: launches (K4, global) {huge_counts}; "
        f"image vs twin {huge_vs}; residuals differing {off}")
    check(huge_counts == (1, 1) and huge_vs["ok"]
          and all(o <= 0.02 for o in off),
          f"K4's global table: launches {huge_counts}, vs twin {huge_vs}, "
          f"residuals {off}")
    launches["k4_modes"] = k4_modes
    return launches, {"forward_ms_grad_bench": forward_ms,
                      "forced_table_modes": forced,
                      "flagship_grad_sweep_s": sweep_s,
                      "flagship_grad_sweep_vs_pallas": {
                          "trimmed_98_max_err": trimmed, "p99_abs": p99},
                      "sharded_flagship_grad": sharded,
                      "sharded_flagship_mxu_s": mxu_s,
                      "sharded_reference_frame_ms": frame_ms}


def png_pixels(data):
    """PNG bytes (or a path) -> int32 [H, W, 3], decoded here: 8-bit RGB
    with rows of filter type 0 (the Python encoder) or 1 (Sub, the native
    one), which is all the port's encoders write."""
    import struct
    import zlib

    import numpy as np

    if not isinstance(data, bytes):
        with open(data, "rb") as f:
            data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            check((depth, ctype) == (8, 2), "PNG is not 8-bit RGB")
            size = (w, h)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    ftype, rows = raw[:, 0], raw[:, 1:].reshape(h, w, 3)
    check(bool((ftype <= 1).all()), "a PNG row filter other than None or Sub")
    # Sub: each byte is stored minus the same channel of the pixel to its
    # left, modulo 256; a wrapping running sum restores the row.
    sub = np.cumsum(rows, axis=1, dtype=np.uint8)
    return np.where((ftype == 1)[:, None, None], sub, rows).astype(np.int32)


def cli_phases(dev, smi, shared, ref):
    """Phases 18-22: the native IO build, K2's cluster-culled traversal, the
    four CLI commands at full width, and Renderer(backend="pallas").
    Returns (launch counts over the CLI path, extra stats); the culled
    checks join `shared["checks"]["k2"]`."""
    import contextlib
    import io as stdio
    import re
    import socket
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, cli, scenes
    from bevy_raytrace_tpu_torch.core.camera import Camera
    from bevy_raytrace_tpu_torch.io import native, tonemap
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels.clusters import (
        cluster_bounds,
        cluster_scene,
    )
    from bevy_raytrace_tpu_torch.kernels.common import _plain_camera
    from bevy_raytrace_tpu_torch.utils import spans
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed, render

    # ---- 18. the native IO library ----------------------------------------
    t0 = time.perf_counter()
    lib = native.load()
    io_build_s = time.perf_counter() - t0
    log(f"[io] route: {native.route()}; {native.library_path().name} built "
        f"(unless a build of this source was found) and loaded in "
        f"{io_build_s:.2f} s")
    check(lib is not None,
          f"the native IO library did not build here: {native.BUILD_ERROR}")

    # ---- 19. K2 culled: vs twin, vs brute force ---------------------------
    scene, cam = shared["scene"], shared["cam"]
    table, cam16 = shared["table"], shared["cam16"]
    cfg, cfg0, bench = shared["cfg"], shared["cfg0"], shared["bench"]
    plan = cluster_scene(scene, cluster_size=12)
    check(plan.n_clusters == 41 and plan.n_members == scene.count,
          f"the plan of rtiow_final: {plan.n_clusters} clusters")

    def hits_per_primary_ray(c16, c):
        """Mean number of clusters whose bound a camera ray hits (sample 0
        of frame 1), by the kernel's test in tensor ops."""
        pid = torch.arange(c.num_pixels, dtype=torch.int64, device=dev)
        ox, oy, oz, dx, dy, dz = _plain_camera(c16, pid, 0, frame_seed(c, 1),
                                               c.width, c.height)
        bx, by, bz, kq = cluster_bounds(table[:, :3], table[:, 3], plan)
        o_dot_d = ox * dx + oy * dy + oz * dz
        o2 = ox * ox + oy * oy + oz * oz
        hb = o_dot_d[:, None] - (bx * dx[:, None] + by * dy[:, None]
                                 + bz * dz[:, None])
        cq = o2[:, None] - 2.0 * (ox[:, None] * bx + oy[:, None] * by
                                  + oz[:, None] * bz) + kq
        return float(((torch.sqrt(hb * hb - cq) - hb) > c.t_min).sum(1)
                     .float().mean())

    def culled_vs_brute(label, tbl, c16, c, reps, sample_base=0, **kw):
        """The culled launch against the brute-force one on the same input:
        differing pixels and residual entries, and their times interleaved
        (brute, culled, culled, brute)."""
        def run(clusters):
            return cuda_ms(lambda: k2.record_frame(
                tbl, c16, c, 1, sample_base=sample_base, clusters=clusters,
                **kw), reps)

        b1, brute = run(None)
        c1, culled = run(plan)
        c2, _ = run(plan)
        b2, _ = run(None)
        px = int((culled[0] != brute[0]).any(-1).sum())
        entries = [int((a != b).sum()) for a, b in zip(culled[1:], brute[1:])
                   if a is not None]
        out = {"brute_ms": [b1, b2], "culled_ms": [c1, c2],
               "culled_over_brute": (c1 + c2) / (b1 + b2),
               "differing_pixels": px, "differing_entries": entries}
        log(f"[k2 culled] {label}: brute force {b1:.3f}, {b2:.3f} ms; culled "
            f"{c1:.3f}, {c2:.3f} ms ({out['culled_over_brute']:.3f}x) on "
            f"{smi}; culled vs brute force: {px} differing pixels, "
            f"{entries} differing residual entries")
        check(px == 0 and not any(entries),
              f"K2 culled differs from brute force at {label}: {out}")
        return out

    k2_checks = shared["checks"]["k2"]
    first_culled = len(k2_checks)
    culled_stats = {"clusters_hit_per_primary_ray": {
        "grad_bench": hits_per_primary_ray(cam16, cfg)}}
    for label, c, kw in (
            ("record_second", cfg, dict(record_second=True)),
            ("record", cfg0, {}),
            ("value only", cfg0, dict(with_residuals=False))):
        full = f"{bench} culled L=12 {label}"
        shared["k2_check"](full, table, cam16, c, shared["bench_rounds"],
                           clusters=plan, **kw)
        k2_checks[-1].update(culled_vs_brute(full, table, cam16, c, 3, **kw))
    sl = shared["sl"]
    label = "rtiow 1200x800 samples 128-129 depth 8 culled L=12"
    shared["k2_check"](f"{label} record", shared["sl_table"],
                       shared["sl_cam16"], sl, shared["sl_rounds"], 128,
                       clusters=plan)
    k2_checks[-1].update(culled_vs_brute(
        f"{label} record", shared["sl_table"], shared["sl_cam16"], sl, 3,
        sample_base=128))
    shared["k2_check"](f"{label} value only", shared["sl_table"],
                       shared["sl_cam16"], sl, shared["sl_rounds"], 128,
                       with_residuals=False, clusters=plan)
    frame_cfg = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                             max_depth=8, spp_chunk=4)
    culled_stats["clusters_hit_per_primary_ray"]["cli_frame"] = (
        hits_per_primary_ray(shared["sl_cam16"], frame_cfg))
    culled_stats["cli_frame_value_only"] = culled_vs_brute(
        "rtiow 1200x800x64 depth 8 (the CLI's frame) value only",
        shared["sl_table"], shared["sl_cam16"], frame_cfg, 1,
        with_residuals=False)
    log(f"[k2 culled] clusters hit per primary ray (of {plan.n_clusters}): "
        f"{culled_stats['clusters_hit_per_primary_ray']}")

    # ---- 20. the command line at full width -------------------------------
    # Every leg of the path is counted on its own: the counts are set to 0
    # just before it and read just after, and must be exactly the leg's
    # own.  The images the legs are held against are rendered between the
    # legs, outside every counted window.
    kernels = ("k1", "k2", "k3", "k4")
    launches = dict.fromkeys([*kernels, "k2_clustered"], 0)
    legs = {}

    def counted(leg, fn, **want):
        """fn() with every count at 0 before and read after -> its result.
        The leg must launch exactly `want` (kernels not named: none)."""
        zero_launches(*kernels)
        out = fn()
        got = launches_of(kernels)
        got["k2_clustered"] = spans.counter("k2.launches_clustered")
        legs[leg] = {k: v for k, v in got.items() if v}
        log(f"[launches] {leg}: {legs[leg]}")
        check(got == {**dict.fromkeys(got, 0), **want},
              f"{leg} launched {got}, expected exactly {want}")
        for k, v in got.items():
            launches[k] += v
        return out

    def run_cli(argv, **want):
        """cli.main(argv) in this process, launching exactly `want` ->
        (wall seconds, its stderr)."""
        err = stdio.StringIO()

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                cli.main(argv)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        secs = counted("cli " + " ".join(
            a for a in argv if a != "-o" and not a.startswith(tmp)), run,
            **want)
        for line in err.getvalue().splitlines():
            log(f"[cli] {argv[0]}: {line}")
        return secs, err.getvalue()

    def held(name, got, want):
        """A decoded PNG against the API's image, tone-mapped: at most one
        8-bit step anywhere (the CLI tone-maps on the device)."""
        want = tonemap(want).astype(np.int32)
        check(got.shape == want.shape, f"{name}: shape {got.shape}")
        worst = int(np.abs(got - want).max())
        log(f"[cli] {name}: PNG vs the API image: max 8-bit difference "
            f"{worst}, {float((got != want).mean()):.5%} of values differ")
        check(worst <= 1, f"{name}: PNG differs from the API image by {worst}")

    def timed(text, pattern=r"in (\d+\.\d+)s"):
        m = re.search(pattern, text)
        check(m is not None, f"no time in the CLI's report: {text!r}")
        return float(m.group(1))

    cli_stats = {}
    cam_frame = scenes.rtiow_final_camera(frame_cfg.aspect)
    with tempfile.TemporaryDirectory() as tmp:
        # render --backend pallas: the defaults, then brute force.
        p12, p0 = os.path.join(tmp, "pallas.png"), os.path.join(tmp, "p0.png")
        wall, err = run_cli(["render", "--scene", "rtiow", "--backend",
                             "pallas", "-o", p12], k2=1, k2_clustered=1)
        cli_stats["render_pallas"] = {
            "wall_s": wall, "timed_s": timed(err),
            "rays_per_s": frame_cfg.rays_per_frame / timed(err)}
        wall, err = run_cli(["render", "--scene", "rtiow", "--backend",
                             "pallas", "--cluster-size", "0", "-o", p0],
                            k2=1)
        cli_stats["render_pallas_brute"] = {
            "wall_s": wall, "timed_s": timed(err),
            "rays_per_s": frame_cfg.rays_per_frame / timed(err)}
        with open(p12, "rb") as fa, open(p0, "rb") as fb:
            same = fa.read() == fb.read()
        got12 = png_pixels(p12)
        diff = int((got12 != png_pixels(p0)).any(-1).sum())
        log(f"[cli] render --backend pallas: cluster size 12 vs 0: PNG bytes "
            f"{'equal' if same else 'differ'}, {diff} differing pixels")
        check(diff == 0, "the culled and brute-force CLI renders differ")
        held("render --backend pallas", got12, k2.render_pallas(
            scene, cam_frame, frame_cfg, 0, clusters=plan))

        # render --backend cuda.
        pc = os.path.join(tmp, "cuda.png")
        # The session's first frame is two launches: the probe samples,
        # then the rest on the balanced permutation.
        wall, err = run_cli(["render", "--scene", "rtiow", "--backend",
                             "cuda", "-o", pc], k1=2)
        cli_stats["render_cuda"] = {
            "wall_s": wall, "timed_s": timed(err),
            "rays_per_s": frame_cfg.rays_per_frame / timed(err)}
        held("render --backend cuda", png_pixels(pc),
             k1.render_mxu(scene, cam_frame, frame_cfg, 0))

        # animate --frames 4 --backend cuda.
        seq = os.path.join(tmp, "seq")
        wall, err = run_cli(["animate", "--frames", "4", "--backend", "cuda",
                             "-o", seq], k1=5)
        check(sorted(os.listdir(seq)) == [f"frame_{i:04d}.png"
                                          for i in range(4)],
              f"animate wrote {sorted(os.listdir(seq))}")
        per_frame = timed(err, r"then (\d+\.\d+)s/frame")
        cli_stats["animate_cuda"] = {
            "wall_s": wall, "first_frame_s": timed(err, r"frame (\d+\.\d+)s"),
            "s_per_frame": per_frame,
            "rays_per_s": frame_cfg.rays_per_frame / per_frame}
        ang = 2.0 * np.pi * 2 / 4
        orbit = Camera.look_at(
            lookfrom=(13.0 * np.cos(ang), 2.0, 13.0 * np.sin(ang)),
            lookat=(0.0, 0.0, 0.0), vfov_deg=20.0, aspect=frame_cfg.aspect,
            aperture=0.1, focus_dist=10.0)
        held("animate frame 2", png_pixels(os.path.join(seq,
                                                         "frame_0002.png")),
             k1.render_mxu(scene, orbit, frame_cfg, 2))

        # serve: a server that answers a few requests.
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        serve_err = stdio.StringIO()

        def serve():
            with contextlib.redirect_stdout(stdio.StringIO()):
                cli.main(["serve", "--port", str(port)])

        def session():
            """The server's life, from its start to its /quit ->
            (the thread, the two frames, their request seconds, /quit's
            answer)."""
            server = threading.Thread(target=serve, daemon=True)
            server.start()
            base = f"http://127.0.0.1:{port}"
            page = None
            for _ in range(600):
                try:
                    page = urllib.request.urlopen(f"{base}/", timeout=30).read()
                    break
                except OSError:
                    time.sleep(0.1)
            check(page is not None and b"frame.png" in page,
                  "serve: the page did not come up")
            frames, frame_s = [], []
            for query in ("yaw=0.2&pitch=0.1&dist=13",
                          "yaw=1.2&pitch=0.1&dist=9"):
                t0 = time.perf_counter()
                frames.append(urllib.request.urlopen(
                    f"{base}/frame.png?{query}", timeout=600).read())
                frame_s.append(time.perf_counter() - t0)
            bye = urllib.request.urlopen(urllib.request.Request(
                f"{base}/quit", method="POST"), timeout=60).read()
            server.join(timeout=60)
            return server, frames, frame_s, bye

        # The server's stderr lines are read back below, so the whole
        # process's stderr is captured while it runs.  Its session's first
        # frame is two launches (the probe, then the rest), the second one.
        with contextlib.redirect_stderr(serve_err):
            server, frames, frame_s, bye = counted("cli serve", session, k1=3)
        for line in serve_err.getvalue().splitlines():
            log(f"[cli] serve: {line}")
        check(bye == b"bye" and not server.is_alive(),
              "serve did not shut down on /quit")
        shots = [png_pixels(f) for f in frames]
        check(all(s.shape == (800, 1200, 3) for s in shots)
              and frames[0] != frames[1], "serve: frames invalid or equal")
        render_ms = [float(v) for v in re.findall(
            r"rendered in (\d+\.\d+) ms", serve_err.getvalue())]
        encode_ms = [float(v) for v in re.findall(
            r"encoded in (\d+\.\d+) ms", serve_err.getvalue())]
        cli_stats["serve_cuda"] = {"request_s": frame_s,
                                   "render_ms": render_ms,
                                   "encode_ms": encode_ms}
        view = Camera.look_at(
            lookfrom=(13 * np.cos(0.1) * np.cos(0.2), 13 * np.sin(0.1) + 2.0,
                      13 * np.cos(0.1) * np.sin(0.2)),
            lookat=(0.0, 0.0, 0.0), vfov_deg=20.0, aspect=frame_cfg.aspect,
            aperture=0.0, focus_dist=13.0)
        held("serve frame 0", shots[0],
             k1.render_mxu(scene, view, frame_cfg, 0))

        # inverse --backend pallas --steps 6 with a checkpoint.
        pi, ck = os.path.join(tmp, "inv.png"), os.path.join(tmp, "inv.npz")
        # The loss renders two independent sample sets per step, each one
        # K2 recording and, backward, one K3 replay.
        wall, err = run_cli(["inverse", "--backend", "pallas", "--steps", "6",
                             "--checkpoint", ck, "--checkpoint-every", "3",
                             "-o", pi], k2=12, k3=12)
        with np.load(ck) as z:
            step = int(z["step"])
        # The command's closing line: its last loss and the ball's errors.
        (final,) = [line for line in err.splitlines()
                    if line.startswith("final ")]
        got = {k: float(v) for k, v in (kv.split("=")
                                        for kv in final.split()[1:])}
        cli_stats["inverse_pallas"] = {
            "wall_s": wall, "s_per_step": timed(err, r"in (\d+\.\d+)s") / 6,
            **got}
        log(f"[cli] inverse: checkpoint at step {step}; {final}")
        check(step == 6 and np.isfinite(got["loss"])
              and got["center_error"] < got["center_error_start"]
              and got["albedo_error"] < got["albedo_error_start"],
              f"cli inverse did not improve: {final}")
        inv_cfg = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                               max_depth=8, spp_chunk=4)
        with torch.no_grad():
            want = render(shared["inverse_scene"],
                          scenes.baseline_config1_camera(inv_cfg.aspect),
                          inv_cfg, 0)
        got, want8 = png_pixels(pi), tonemap(want).astype(np.int32)
        close = float((np.abs(got - want8).max(-1) <= 1).mean())
        log(f"[cli] inverse: PNG vs the API's 6-step result: {close:.4%} of "
            f"pixels within one 8-bit step")
        check(close >= 0.98, "cli inverse's image differs from the API's")

    # ---- 21. Renderer(backend="pallas") -----------------------------------
    ref_scene, ref_cam, ref_cfg = ref
    r = Renderer(ref_cfg, backend="pallas")
    frame_ms, plans = [], []

    def session_frames():
        for _ in range(3):
            t0 = time.perf_counter()
            img = r.render_frame(ref_scene, ref_cam)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            plans.append(r._plans[(ref_scene.count, 12)])
        return img

    img = counted('Renderer(backend="pallas") x 3 frames', session_frames,
                  k2=3, k2_clustered=3)
    check(len(r._plans) == 1 and plans[0] is not None
          and all(p is plans[0] for p in plans),
          "Renderer('pallas') did not reuse its plan")
    brute = k2.render_pallas(ref_scene, ref_cam, ref_cfg, 2)
    diff = int((img != brute).any(-1).sum())
    log('[pallas session] Renderer(backend="pallas") reference frames '
        f"({ref_scene.count} spheres, {plans[0].n_clusters} clusters): "
        + ", ".join(f"{m:.2f} ms" for m in frame_ms)
        + f"; one plan for 3 frames; last frame vs brute force: {diff} "
        f"differing pixels; on {smi}")
    check(diff == 0 and bool(torch.isfinite(img).all()),
          "Renderer('pallas') differs from the brute-force launch")

    # The session's own shape and plan against the twin: a 2-sample slice
    # of the reference frame, value only as the session launches it.
    ref_sl = RenderConfig(width=ref_cfg.width, height=ref_cfg.height,
                          samples_per_pixel=2, max_depth=ref_cfg.max_depth)
    ref_table, ref_cam16 = k2._operands(ref_scene, ref_cam)
    shared["k2_check"](
        f"reference frame 1920x1080 samples 0-1 depth 3 culled L=12 "
        f"({plans[0].n_clusters} clusters) value only", ref_table, ref_cam16,
        ref_sl, k1_rounds(ref_scene, ref_cam, ref_sl, 1),
        with_residuals=False, clusters=plans[0])

    # ---- 22. launches -----------------------------------------------------
    # The sums of the legs' counts, each of which was held to its exact
    # number above.
    log(f"[launches] over the CLI path (phases 20-21): {launches}")
    check(launches["k1"] > 0 and launches["k3"] > 0
          and launches["k2_clustered"] > 0
          and launches["k2"] > launches["k2_clustered"],
          f"a kernel was not launched by the CLI path: {launches}")
    for c in k2_checks[first_culled:]:
        c["launches_cli_path"] = launches["k2_clustered"]
    return launches, {"io_route": native.route(), "io_build_s": io_build_s,
                      "k2_culled": culled_stats, "cli": cli_stats,
                      "cli_leg_launches": legs,
                      "pallas_session_frame_ms": frame_ms}


def tool_phases(dev, smi):
    """Phases 23-26: the probe kernels P1-P5 and V1-V3 behind their tools,
    the gradient bench tool and the graft entry points.  Returns (the
    probes' entries of the {"kernels": [...]} line, K1-K4's launch counts
    over the tool path, extra stats)."""
    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, graft_entry
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import fp32_probe as vp
    from bevy_raytrace_tpu_torch.kernels import probes as pp
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare
    from bevy_raytrace_tpu_torch.tools import fp32_probe as fp32_tool
    from bevy_raytrace_tpu_torch.tools import grad_bench, proto_probes

    # ---- 23. build the probes ---------------------------------------------
    names = ["probes", "fp32_probe"]
    t0 = time.perf_counter()
    build.load_all(names)
    build_s = time.perf_counter() - t0
    for name in names:
        secs, out = build.BUILD_LOG.get(name, (0.0, ""))
        log(f"[build] {name}: nvcc {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] probes + fp32_probe in {build_s:.2f} s (in parallel)")

    kernels = ("p1", "p2", "p3", "p4", "p5", "v1", "v2", "v3", "k1", "k2",
               "k3", "k4")
    launches = dict.fromkeys(kernels, 0)
    legs = {}

    def counted(leg, fn, **want):
        """fn() with every count at 0 before and read after -> its result.
        The leg must launch exactly `want` (kernels not named: none)."""
        zero_launches(*kernels)
        out = fn()
        got = launches_of(kernels)
        legs[leg] = {k: v for k, v in got.items() if v}
        log(f"[launches] {leg}: {legs[leg]}")
        check(got == {**dict.fromkeys(got, 0), **want},
              f"{leg} launched {got}, expected exactly {want}")
        for k, v in got.items():
            launches[k] += v
        return out

    def as_tuple(v):
        return v if isinstance(v, tuple) else (v,)

    # ---- 24. P1-P5 ----------------------------------------------------------
    rc = counted("tools.proto_probes", lambda: proto_probes.main([]),
                 p1=2, p2=2, p3=2, p4=2, p5=2)
    check(rc == 0, f"tools.proto_probes exited {rc}")
    log(f"[probes] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (P2's plain version and "
        f"library call are float32 products)")
    ref = {k: tuple(torch.from_numpy(v).to(dev) for v in ops)
           for k, ops in proto_probes.reference_inputs().items()}
    checks = {k: [] for k in ("p1", "p2", "p3", "p4", "p5", "v1", "v2", "v3")}
    library, library_device = {}, {}

    def p_check(key, label, wrapper, plain, operands, flops, nbytes,
                rtol=0.0, atol=0.0, lib=None):
        """A construct probe against its plain version on the card: every
        output within atol + rtol * |plain| (0, 0: exact)."""
        ms, got = cuda_ms(lambda: wrapper(*operands), 200)
        plain_ms, want = cuda_ms(lambda: plain(*operands), 3)
        got, want = as_tuple(got), as_tuple(want)
        err = 0.0
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{label}: output {a.shape} {a.dtype} vs the plain "
                  f"version's {b.shape} {b.dtype}")
            nan = torch.isnan(b) if b.is_floating_point() else None
            if nan is not None:
                check(torch.equal(torch.isnan(a), nan),
                      f"{label}: NaN elsewhere than the plain version")
            diff = (a.double() - b.double()).abs()
            tol = atol + rtol * b.double().abs()
            if nan is not None:
                diff[nan] = tol[nan] = 0.0
            err = max(err, float(diff.max()))
            check(bool((diff <= tol).all()),
                  f"{label}: off the plain version by {float(diff.max())} "
                  f"(rtol {rtol}, atol {atol})")
            if rtol == atol == 0.0 and a.dtype == torch.float32:
                check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                      f"{label}: not the plain version's bits")
        if callable(flops):
            flops = flops(got)
        dev_ms, names = device_ms(lambda: wrapper(*operands), 50)
        entry = {"shape": label, "max_abs_err": err, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 **bound(flops, nbytes)}
        # The bound's share of the device-side time (of the event time where
        # the trace holds none).
        entry["share_of_bound"] = entry["bound_ms"] / (dev_ms or ms)
        line = (f"[probes] {label}: kernel {ms * 1e3:.2f} us (device-side "
                f"{'not measured' if dev_ms is None else f'{dev_ms * 1e3:.2f} us'}"
                f": {names}), plain version {plain_ms * 1e3:.2f} us, bound "
                f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}, "
                f"{entry['share_of_bound']:.2%} of the kernel's time); max "
                f"abs err {err:.3e}")
        if lib is not None:
            entry["library_ms"], _ = cuda_ms(lib, 200)
            entry["library_device_ms"], lib_names = device_ms(lib, 50)
            library.setdefault(key, entry["library_ms"])
            library_device.setdefault(key, entry["library_device_ms"])
            lib_dev = entry["library_device_ms"]
            line += (f"; library call {entry['library_ms'] * 1e3:.2f} us "
                     f"(device-side {'not measured' if lib_dev is None else f'{lib_dev * 1e3:.2f} us'}"
                     f": {lib_names})")
        log(line + f" on {smi}")
        checks[key].append(entry)
        return got

    # P1 on the reference's x and on lanes that die rounds apart, in one
    # round or at once; P2 on the reference's product and with K = 48.  The
    # SHA-256 of each output is printed, so that two trees run in one call
    # can be held to the same bits.
    p1_digests, p2_digests = {}, {}
    for label, (x, want_rounds) in p1_inputs().items():
        x = torch.from_numpy(x).to(dev)
        # Per lane and round: an add, a multiply, a multiply-add, a compare
        # (the function's own work: the vote and the count are the
        # kernel's).
        out, rounds = p_check(
            "p1", f"P1 [8,128] {label}", pp.p1_while, pp.p1_while_plain,
            (x,), lambda got: int(got[1]) * 1024 * 5, 2 * 1024 * 4 + 4,
            rtol=1e-5)
        p1_digests[label] = sha256(out, rounds)
        log(f"[probes] P1 {label}: {int(rounds)} rounds, sha256 "
            f"{p1_digests[label]}")
        check(int(rounds) == want_rounds,
              f"P1 {label}: {int(rounds)} rounds, not {want_rounds}: the "
              f"loop did not run until its last lane died")
    check(p1_digests["x = 0 (the reference's)"]
          != p1_digests["every lane at x >= 49"], "P1's digests are blind")
    for label, ab in p2_inputs().items():
        a, b = (torch.from_numpy(v).to(dev) for v in ab)
        (m, k), n = a.shape, b.shape[1]
        scale = float((a @ b).abs().max())
        c = p_check("p2", f"P2 {label}", pp.p2_dot, pp.p2_dot_plain, (a, b),
                    2 * m * n * k, (m * k + k * n + m * n) * 4,
                    atol=1e-5 * scale,
                    lib=(lambda a=a, b=b: torch.matmul(a, b))
                    if k == 16 else None)[0]
        p2_digests[label] = sha256(c)
        log(f"[probes] P2 {label}: sha256 {p2_digests[label]}")
    # P3 at the tool's [8,128] (its launch floor) and at a card-filling
    # [2^21,128] (1 GiB in, 1 GiB out: a stream through device memory, bound
    # by its bytes), each beside x.reshape(1, -1) * 2; then bit for bit at
    # [2^24 + 1,128], where rows x 128 passes 2^31 (x, out and a compare a
    # chunk of rows at a time, ~18 GiB).
    (x3,) = ref["p3_reshape"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x3_card = torch.randn((1 << 21, 128), generator=gen, device=dev)
    p3_digests = {}
    for label, x in (("[8,128]", x3), ("[2^21,128]", x3_card)):
        out = p_check("p3", f"P3 {label}", pp.p3_reshape, pp.p3_reshape_plain,
                      (x,), x.numel(), 2 * x.numel() * 4,
                      lib=lambda x=x: x.reshape(1, -1) * 2.0)[0]
        p3_digests[label] = sha256(out)
        log(f"[probes] P3 {label}: sha256 {p3_digests[label]}")
    del x3_card, out
    torch.cuda.empty_cache()
    x = torch.randn(((1 << 24) + 1, 128), generator=gen, device=dev)
    t0 = time.perf_counter()
    out = pp.p3_reshape(x)
    torch.cuda.synchronize()
    off = sum(int((out[r:r + (1 << 22)].view(torch.int32)
                   != (x[r:r + (1 << 22)] * 2.0).view(torch.int32)).sum())
              for r in range(0, x.shape[0], 1 << 22))
    log(f"[probes] P3 [2^24+1,128] (rows x 128 past 2^31): {off} of "
        f"{x.numel()} elements off x * 2 ({time.perf_counter() - t0:.2f} s "
        f"with the compare)")
    check(off == 0, f"P3 [2^24+1,128]: {off} elements off x * 2")
    del x, out
    torch.cuda.empty_cache()
    (t4,) = ref["p4_minpack"]
    tie_t = t4.clone()
    tie_t[400, 5] = tie_t[17, 5] = 0.5
    # NaN at rows 0 and 9 of column 3 (a NaN never wins against a number)
    # and in every row of column 7 (an all-NaN column gives row 0).
    nan_t = t4.clone()
    nan_t[[0, 9], 3] = float("nan")
    nan_t[:, 7] = float("nan")
    p4_out = {}
    for label, t in (("the reference's t", t4), ("a tie in column 5", tie_t),
                     ("NaN in columns 3 and 7", nan_t)):
        p4_out[label] = p_check(
            "p4", f"P4 [512,1024] {label}", pp.p4_min, pp.p4_min_plain, (t,),
            512 * 1024, 512 * 1024 * 4 + 1024 * 8,
            lib=(lambda t=t: torch.min(t, dim=0)) if t is t4 else None)
    m, row = p4_out["a tie in column 5"]
    check(float(m[0, 5]) == 0.5 and int(row[0, 5]) == 17,
          "P4: the lowest row did not win the tie")
    m, row = p4_out["NaN in columns 3 and 7"]
    check(int(row[0, 3]) not in (0, 9) and not bool(torch.isnan(m[0, 3]))
          and int(row[0, 7]) == 0 and bool(torch.isnan(m[0, 7])),
          f"P4: a NaN won against a number, or an all-NaN column gave "
          f"({float(m[0, 7])}, {int(row[0, 7])})")
    packed, m5, attr = ref["p5_onehot"]
    tie_p = packed.clone()
    tie_p[3, 7] = tie_p[300, 7] = -1
    for label, pk in (("the reference's keys", packed),
                      ("a tie in column 7", tie_p)):
        mk = pk.min(dim=0, keepdim=True).values
        out = p_check(
            "p5", f"P5 [512,1024] x [16,512] {label}", pp.p5_onehot_gather,
            pp.p5_onehot_gather_plain, (pk, mk, attr), 512 * 1024 + 16 * 1024,
            (512 * 1024 + 1024 + 16 * 512 + 16 * 1024) * 4,
            lib=(lambda: attr[:, torch.min(packed, dim=0).indices])
            if pk is packed else None)[0]
    check(torch.equal(out[:, 7], attr[:, 3] + attr[:, 300]),
          "P5: the tied rows did not sum")

    # ---- 25. V1-V3 ----------------------------------------------------------
    rc = counted("tools.fp32_probe", lambda: fp32_tool.main([]),
                 v1=12, v2=16, v3=108)
    check(rc == 0, f"tools.fp32_probe exited {rc}")
    rows = list(fp32_tool.ROWS)
    check(all(r["device"].startswith("cuda") and 0.0 < r["share_of_peak"]
              <= 1.0 for r in rows),
          "a probe's rate is missing or above the card's peak")
    # V3 "prod" (several rays a thread on a staged table) must give K1's
    # loop's bits ("k1", and "smem", K1's loop on a staged table) on every
    # input the tool ran: SHA-256 of (t, index) per input and round count.
    v3_digests = {}
    for row in rows:
        if row["name"] in ("v3 prod", "v3 k1", "v3 smem"):
            key = (row["rays"], row["iters"], row["spheres"], row["rays_as"])
            v3_digests.setdefault(key, {})[row["name"][3:]] = row["sha256"]
    for (n_rays, n_iters, n_sph, rays_as), got in v3_digests.items():
        log(f"[fp32 probe] V3 digests, {n_sph} spheres, {n_rays} rays "
            f"({rays_as}) x {n_iters} rounds: {got}")
        check("k1" not in got or len(set(got.values())) == 1,
              f"V3 prod differs from k1 on {rays_as} x {n_iters}: {got}")
    card_inputs = {k[3] for k in v3_digests
                   if k[0] == fp32_tool.CARD_RAYS and "k1" in v3_digests[k]}
    check({"reference", "reference raster", "rtiow raster"} <= card_inputs,
          f"V3 prod was not held against k1 on every card-filling input: "
          f"{sorted(card_inputs)}")
    v3_speedup = {}
    for rays_as in sorted(card_inputs):
        ms = {r["name"][3:]: r["ms"] for r in rows
              if r["kind"] == "v3" and r["rays"] == fp32_tool.CARD_RAYS
              and r["iters"] == fp32_tool.CARD_ITERS
              and r["rays_as"] == rays_as}
        v3_speedup[rays_as] = {v: ms[v] / ms["prod"] for v in ms
                               if v in ("k1", "smem")}
        log(f"[fp32 probe] V3 {rays_as}, card-filling shape: prod "
            f"{ms['prod']:.3f} ms; time over prod's: {v3_speedup[rays_as]} "
            f"on {smi}")

    g, r = (torch.from_numpy(v).to(dev)
            for v in fp32_tool.reference_inputs(256, 1024))
    g16, r16 = g.to(torch.bfloat16), r.to(torch.bfloat16)

    def v_bound(kind, s, n, iters, dtype="float32"):
        """Bound of a rate probe: the counted operations against the peak
        of their type; both operands read once, the outputs written once."""
        size = 2 if dtype == "bfloat16" else 4
        return bound(s * n * iters * vp.OPS[kind],
                     (s * 8 + 8 * n) * size + n * (8 if kind == "v3" else 4),
                     fp32_tool.PEAK[dtype])

    # V1 per shape and round count: its time, the bound's share of it, and
    # its output's SHA-256 (the same bits as the kernel it replaced).
    for row in rows:
        if row["name"] == "v1 sweep":
            b = v_bound("v1", row["spheres"], row["rays"], row["iters"])
            log(f"[fp32 probe] V1 ({row['spheres']},{row['rays']}) x "
                f"{row['iters']} rounds: {row['ms']:.3f} ms, bound "
                f"{b['bound_ms']:.3f} ms ({b['bound_ms'] / row['ms']:.2%} "
                f"of the kernel's time), sha256 {row['sha256']} on {smi}")

    def v_check(key, label, fn, plain_fn, rtol, atol=0.0, dtype="float32"):
        """A rate probe against its plain version at the reference's shape,
        3 rounds: t within atol + rtol * |plain|, NaN where the plain
        version has NaN; V3's index equal on all but 0.5% of columns."""
        ms, got = cuda_ms(fn, 20)
        plain_ms, want = cuda_ms(plain_fn, 3)
        got, want = as_tuple(got), as_tuple(want)
        miss = torch.isnan(want[0])
        check(torch.equal(torch.isnan(got[0]), miss),
              f"{label}: NaN elsewhere than the plain version")
        diff = (got[0] - want[0]).abs()[~miss]
        err = float(diff.max())
        check(bool((diff <= atol + rtol * want[0][~miss].abs()).all()),
              f"{label}: off the plain version by {err} (rtol {rtol}, atol "
              f"{atol})")
        entry = {"shape": label, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, **v_bound(key, 256, 1024, 3, dtype)}
        if len(got) == 2:
            entry["index_off"] = float((got[1] != want[1]).float().mean())
            check(entry["index_off"] <= 0.005 and bool((got[1] >= 0).any()),
                  f"{label}: index differs on {entry['index_off']:.3%}")
        log(f"[fp32 probe] {label}: kernel {ms * 1e3:.2f} us, plain version "
            f"{plain_ms * 1e3:.2f} us; max abs err {err:.3e}"
            + (f", index differing on {entry['index_off']:.4%}"
               if len(got) == 2 else ""))
        checks[key].append(entry)

    at = "(256,1024) x 3 rounds"
    v_check("v1", f"V1 {at}", lambda: vp.v1_sweep(g, r, 3),
            lambda: vp.v1_sweep_plain(g, r, 3), 1e-5, 2e-6)
    v_check("v2", f"V2 float32 {at}", lambda: vp.v2_fma(g, r, 3),
            lambda: vp.v2_fma_plain(g, r, 3), 1e-4)
    v_check("v2", f"V2 bfloat16 {at}", lambda: vp.v2_fma(g16, r16, 3),
            lambda: vp.v2_fma_plain(g16, r16, 3), 5e-2, dtype="bfloat16")
    for variant in vp.VARIANTS:
        v_check("v3", f"V3 {variant} {at}",
                lambda variant=variant: vp.v3_sweep(g, r, 3, variant),
                lambda variant=variant: vp.v3_sweep_plain(g, r, 3, variant),
                1e-5, 2e-6)

    # The headline of each V entry: the card-filling shape as the tool ran
    # it, its plain version at the same shape and rounds (one run), and
    # the values' error from the checks above.
    gc, rc_ = (torch.from_numpy(v).to(dev) for v in fp32_tool.reference_inputs(
        256, fp32_tool.CARD_RAYS))
    n, iters = fp32_tool.CARD_RAYS, fp32_tool.CARD_ITERS
    for key, name, plain_fn in (
            ("v1", "v1 sweep", lambda: vp.v1_sweep_plain(gc, rc_, iters)),
            ("v2", "v2 fma f32", lambda: vp.v2_fma_plain(gc, rc_, iters)),
            ("v3", "v3 prod", lambda: vp.v3_sweep_plain(gc, rc_, iters))):
        row = next(x for x in rows if x["name"] == name and x["rays"] == n
                   and x["iters"] == iters and x["rays_as"] == "reference")
        plain_ms, _ = cuda_ms(plain_fn, 1, warm=False)
        head = {"shape": f"{name} (256,{n}) x {iters} rounds, the card-"
                         f"filling shape of tools.fp32_probe",
                "max_abs_err": max(c["max_abs_err"] for c in checks[key]),
                "ms": row["ms"], "plain_ms": plain_ms,
                "share_of_peak": row["share_of_peak"],
                **v_bound(key, 256, n, iters)}
        log(f"[fp32 probe] {head['shape']}: kernel {row['ms']:.3f} ms "
            f"({row['share_of_peak']:.2%} of peak), plain version "
            f"{plain_ms:.1f} ms, bound {head['bound_ms']:.3f} ms on {smi}")
        checks[key].insert(0, head)
    del gc, rc_
    torch.cuda.empty_cache()

    # ---- 26. grad_bench, graft_entry ----------------------------------------
    # A step is one recording forward and one replay: four steps a path.  The
    # torch path's backward and the wavefront launch no kernel; those two
    # run at 1 spp (a step of each at 16 spp is 3-5 s, host-bound).
    size = ["400", "300", "16", "8"]
    rc = counted("tools.grad_bench kernel",
                 lambda: grad_bench.main([*size, "kernel"]), k2=4, k3=4)
    check(rc == 0, f"tools.grad_bench kernel exited {rc}")
    steps = list(grad_bench.STEPS)
    rc = counted("tools.grad_bench torch,wavefront at 1 spp",
                 lambda: grad_bench.main(["400", "300", "1", "8",
                                          "torch,wavefront"]), k2=4)
    check(rc == 0, f"tools.grad_bench torch,wavefront exited {rc}")
    steps += grad_bench.STEPS
    rc = counted("tools.grad_bench kernel --forward sweep",
                 lambda: grad_bench.main([*size, "kernel", "--forward",
                                          "sweep"]), k4=4, k3=4)
    check(rc == 0, f"tools.grad_bench --forward sweep exited {rc}")
    steps += grad_bench.STEPS
    check(len(steps) == 4 and all(s["device"].startswith("cuda")
                                  for s in steps),
          f"grad_bench did not run its four paths on the card: {steps}")

    fn, (scene, cam) = graft_entry.entry()
    check(scene.device.type == "cuda", "graft_entry.entry() is not on the card")

    def run_entry():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn(scene, cam)
        torch.cuda.synchronize()
        return img, time.perf_counter() - t0

    img, entry_s = counted("graft_entry.entry fn", run_entry)
    cfg = RenderConfig(width=400, height=224, samples_per_pixel=4,
                       max_depth=8, spp_chunk=4)
    entry_vs = compare(img.cpu().numpy(),
                       k1.render_mxu(scene, cam, cfg).cpu().numpy(), COMPILED)
    log(f"[graft] entry() fn: {tuple(img.shape)} in {entry_s:.3f} s "
        f"({scene.count} spheres); vs K1's image {entry_vs}")
    check(tuple(img.shape) == (224, 400, 3)
          and bool(torch.isfinite(img).all()) and entry_vs["ok"],
          f"graft_entry.entry()'s image: {entry_vs}")
    t0 = time.perf_counter()
    (report,) = graft_entry.dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    log(f"[graft] dryrun_multichip(1) in {dry_s:.1f} s: {report}")
    check(report["ok"] and report["backend"] == "nccl"
          and report["device"].startswith("cuda")
          and (report["hosts"], report["chips"]) == (1, 1)
          and np.isfinite(report["loss"]) and report["moved"] > 0.0
          and all(v > 0.0 for v in report["fast_grad_max"].values()),
          f"dryrun_multichip(1): {report}")

    csrc = "bevy_raytrace_tpu_torch/csrc/"
    entries = [
        kernel_entry(name, csrc + source, f"tools/{tool}.py:{line}",
                     launches[key], checks[key], library.get(key))
        for key, name, source, tool, line in (
            ("p1", "p1_while", "probes.cu", "proto_mxu", 24),
            ("p2", "p2_dot", "probes.cu", "proto_mxu", 55),
            ("p3", "p3_reshape", "probes.cu", "proto_mxu", 74),
            ("p4", "p4_min", "probes.cu", "proto_mxu", 90),
            ("p5", "p5_onehot_gather", "probes.cu", "proto_mxu", 116),
            ("v1", "v1_sweep", "fp32_probe.cu", "vpu_probe", 31),
            ("v2", "v2_fma", "fp32_probe.cu", "vpu_probe", 69),
            ("v3", "v3_sweep", "fp32_probe.cu", "vpu_probe", 114))]
    for entry, key in zip(entries, ("p1", "p2", "p3", "p4", "p5")):
        # Device-side durations (torch.profiler): the headline `ms` of a
        # probe is a mean over back-to-back launches through ctypes, which
        # sits on the host's launch floor.
        entry["device_ms"] = checks[key][0]["device_ms"]
        entry["library_device_ms"] = library_device.get(key)
    log(f"[launches] over the tool path (phases 24-26): {launches}")
    return entries, launches, {
        "probe_build_s": build_s, "tool_leg_launches": legs,
        "probe_sha256": {"p1": p1_digests, "p2": p2_digests,
                         "p3": p3_digests},
        "v3_time_over_prod": v3_speedup,
        "fp32_probe_rows": rows, "grad_bench_steps": steps,
        "graft_entry_s": entry_s, "graft_entry_vs_k1": entry_vs,
        "graft_dryrun": report, "graft_dryrun_s": dry_s}


def bench_phases(dev, smi):
    """Phase 27: the port's bench, the sharding record and the frame loops,
    each through its entry point in this process.  Returns (K1-K4's launch
    counts over the bench, extra stats)."""
    import contextlib
    import io as stdio
    import math
    import shutil
    import tempfile

    import torch

    import bench_torch
    from bevy_raytrace_tpu_torch.tools import ref_probe, scaling

    def stdout_of(fn):
        """fn() with stdout captured -> (seconds, the lines it printed)."""
        out = stdio.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = fn()
        secs = time.perf_counter() - t0
        check(rc == 0, f"{fn} returned {rc}")
        return secs, out.getvalue().strip().splitlines()

    def rate(v):
        return isinstance(v, float) and math.isfinite(v) and v > 0.0

    # ---- 27. bench_torch, tools.scaling, tools.ref_probe --------------------
    kernels = ("k1", "k2", "k3", "k4")
    zero_launches(*kernels)
    bench_s, lines = stdout_of(
        lambda: bench_torch.main(["--quick", "--repeats", "1"]))
    launches = launches_of(kernels)
    log(f"[launches] bench_torch --quick: {launches}")
    # K1: the gate 3 (8 spp is all probe: `cuda` 1, the session's probe
    # and cached frames 1 each), the reference workload 5 (its probe frame
    # 2, three cached frames), the flagship frames 3 (16 spp is all probe,
    # then frames 1 and 2); K2: the gate 1, grad_fast and grad_flagship 3
    # steps each; K3: 3 steps of each fast leg; K4: the gate 1,
    # grad_flagship_sweep 3.
    want = {"k1": 11, "k2": 7, "k3": 9, "k4": 4}
    check(launches == want, f"the bench launched {launches}, expected "
                            f"exactly {want}")
    check(len(lines) == 1, f"bench_torch printed {len(lines)} lines")
    line = json.loads(lines[0])
    log(f"[bench] --quick in {bench_s:.1f} s on {smi}: {lines[0]}")
    check(set(line) == bench_torch.KEYS,
          f"bench keys: missing {bench_torch.KEYS - set(line)}, extra "
          f"{set(line) - bench_torch.KEYS}")
    check(line["verify"] == "pass", f"bench verify: {line['verify']}")
    rates = {k: v for k, v in line.items()
             if k not in ("metric", "unit", "verify", "device")}
    check(all(rate(v) for v in rates.values()), f"bench rates: {rates}")
    check(line["device"]["name"] in smi
          and line["device"]["power_limit_w"] > 0,
          f"bench device {line['device']} against {smi}")

    # The worker rank is a process of its own: hand it the cached blocks.
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="brt_scaling_")
    try:
        out = os.path.join(tmp, "SCALING_torch.json")
        scaling_s, _ = stdout_of(lambda: scaling.main(
            ["--worlds", "1", "--out", out, "--trace-dir",
             os.path.join(tmp, "trace")]))
        with open(out) as f:
            record = json.load(f)
        (world,) = record["worlds"]
        log(f"[scaling] world 1 in {scaling_s:.1f} s on {smi}: "
            f"{json.dumps(world)}")
        timed = world["timed"]
        check(world["world"] == 1 and world["backend"] == "nccl"
              and world["devices"][0].startswith("cuda")
              and world["matches_single_process"]
              and world["forward_collectives"]["count"] == 0
              and world["backward_collectives"]["fast_all_reduces"] == 1
              and world["backward_collectives"]["fast_bytes"]
              == (11 * world["spheres"] + 16) * 4
              and timed["shape"] == list(scaling.CARD_STEP)
              and timed["spheres"] == 486
              and timed["fast_bytes"] == (11 * 486 + 16) * 4
              and rate(timed["step_s"]) and rate(timed["frame_s"])
              and os.path.getsize(world["trace"]),
              f"tools.scaling world 1: {world}")
    finally:
        shutil.rmtree(tmp)

    probe_s, lines = stdout_of(
        lambda: ref_probe.main(["--frames", "2", "--skip-spp64"]))
    probe = json.loads(lines[-1])
    log(f"[ref_probe] in {probe_s:.1f} s on {smi}: {lines[-1]}")
    check(probe["backend"] == "cuda" and rate(probe["spp16_sync_rays_per_s"])
          and rate(probe["spp16_pipelined_rays_per_s"]),
          f"tools.ref_probe: {probe}")
    torch.cuda.empty_cache()
    return launches, {"bench_line": line, "bench_s": bench_s,
                      "scaling_world1": world, "scaling_s": scaling_s,
                      "ref_probe": probe, "ref_probe_s": probe_s}


def culled_phase(dev, smi, flagship, reference, lane_args):
    """Phase 6b: K1's chunk-culled traversal.  `flagship` = (scene, camera,
    config, phase 5's dense balanced frame, its seconds, phase 6's dense
    identity-lane ms), `reference` = (scene, camera, config, phase 4a's
    dense fb and len on identity lanes), `lane_args` main's.  Returns (the
    culled launches of the main path's leg, the record, the kernels-line
    check)."""
    import torch

    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare
    from bevy_raytrace_tpu_torch.profile_grad import random_scene
    from bevy_raytrace_tpu_torch.tools import livechunks
    from bevy_raytrace_tpu_torch.utils import spans

    from bevy_raytrace_tpu_torch.kernels import build

    flag_scene, flag_cam, flag_cfg, flag, flag_s, flag_ms = flagship
    ref_scene, ref_cam, ref_cfg, ref_fb, ref_ln = reference
    size = 12
    out = {"cluster_size": size,
           "ptxas": ptxas_summary(build.build_output("k1_render"))}
    for name, props in out["ptxas"].items():
        log(f"[culled] ptxas {name}: {props}")

    def counts():
        return (spans.counter("k1.launches"),
                spans.counter("k1.launches_global"),
                spans.counter("k1.launches_culled"))

    def culled_args(scene, cam, cfg, pids, plan):
        geom, attr, cull = k1._scene_tables(scene, plan)
        args = lane_args(scene, cam, cfg, pids)
        return (geom, attr) + args[2:], cull

    # The main path's leg: the flagship through render_mxu_balanced(plan=),
    # twice, with the counts set to 0 just before and read just after.
    flag_plan = cluster_scene(flag_scene, size)
    zero_launches("k1")
    cull_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        frame = k1.render_mxu_balanced(flag_scene, flag_cam, flag_cfg,
                                       plan=flag_plan)
        torch.cuda.synchronize()
        cull_s.append(time.perf_counter() - t0)
    leg = counts()
    log(f"[culled] flagship render_mxu_balanced(plan=cluster_scene(scene, "
        f"{size})), {flag_plan.n_clusters} chunks: "
        + ", ".join(f"{t:.3f} s" for t in cull_s) + " against dense "
        + ", ".join(f"{t:.3f} s" for t in flag_s)
        + f"; launches (K1, global, culled) {leg} on {smi}")
    check(leg == (4, 0, 4), f"the culled flagship leg launched {leg}, not "
          f"4 culled K1 (probe + rest, twice) on the staged table")
    check(torch.equal(frame, flag), "the culled flagship frame is not the "
          "dense frame bit for bit")
    out["flagship_frame_s"] = cull_s
    out["flagship_dense_frame_s"] = list(flag_s)

    # One stripe of the culled frame against the culled twin, and the culled
    # kernel on those lanes against the twin on the same inputs.
    lo = 400 * flag_cfg.width
    stripe = torch.arange(lo, lo + 16384, dtype=torch.int32, device=dev)
    args, cull = culled_args(flag_scene, flag_cam, flag_cfg, stripe,
                             flag_plan)
    stripe_ms, (fb_k, _) = cuda_ms(lambda: k1.render_lanes(*args, cull=cull),
                                   2)
    plain_ms, (fb_t, ln_t) = cuda_ms(
        lambda: k1.render_lanes_plain(*args, cull=cull), 1, warm=False)
    spp = flag_cfg.samples_per_pixel
    twin = (fb_t / spp).cpu().numpy()
    frame_vs = compare(frame.reshape(-1, 3)[lo:lo + 16384].cpu().numpy(),
                       twin, COMPILED)
    kernel_vs = compare((fb_k / spp).cpu().numpy(), twin, COMPILED)
    log(f"[culled] flagship stripe of 16384 pixels from row 400: frame vs "
        f"twin {frame_vs}; kernel {stripe_ms:.3f} ms vs twin {plain_ms:.1f} "
        f"ms {kernel_vs}")
    check(frame_vs["ok"] and kernel_vs["ok"],
          f"culled stripe vs twin: frame {frame_vs}, kernel {kernel_vs}")
    _, ln_k, live_k = k1.render_lanes(*args, cull=cull, count_live=True)
    s_rounds, s_live = float(ln_k.sum()), float(live_k.sum())
    check_entry = {
        "shape": "flagship stripe, 16384 pixels x256 depth 8, culled L=12",
        "mode": k1.forward_table_mode(
            "k1_render_culled", dev,
            flag_scene.count + flag_plan.n_clusters + len(flag_plan.prio)),
        "max_abs_err": kernel_vs["max_abs_err"], "ms": stripe_ms,
        "plain_ms": plain_ms, "rounds": s_rounds, "live_chunks": s_live,
        **culled_bound(flag_scene.count, flag_plan.n_clusters, size,
                       len(flag_plan.prio), 16384, spp, s_rounds, s_live)}
    check_entry["bound_share"] = check_entry["bound_ms"] / stripe_ms
    check(0.0 < check_entry["bound_ms"] <= stripe_ms,
          f"the culled check is faster than its bound: {check_entry}")
    del fb_t, ln_t, fb_k

    # The flagship's K1 on identity lanes, culled against dense (phase 6).
    pids = torch.arange(k1.lane_pad(flag_cfg.num_pixels), dtype=torch.int32,
                        device=dev)
    args, cull = culled_args(flag_scene, flag_cam, flag_cfg, pids, flag_plan)
    culled_ms, _ = cuda_ms(lambda: k1.render_lanes(*args, cull=cull), 2)
    _, ln_c, live_c = k1.render_lanes(*args, cull=cull, count_live=True)
    rounds, live = float(ln_c.sum()), float(live_c.sum())
    out["flagship_identity"] = {
        "ms": culled_ms, "dense_ms": flag_ms, "rounds": rounds,
        "live_chunks_per_round": live / rounds,
        "n_clusters": flag_plan.n_clusters,
        **culled_bound(flag_scene.count, flag_plan.n_clusters, size,
                       len(flag_plan.prio), flag_cfg.num_pixels, spp,
                       rounds, live)}
    b = out["flagship_identity"]["bound_ms"]
    out["flagship_identity"]["bound_share"] = b / culled_ms
    log(f"[culled] flagship K1 on identity lanes: culled {culled_ms:.3f} ms "
        f"against dense {flag_ms:.3f} ms ({flag_ms / culled_ms:.3f}x); "
        f"{live / rounds:.3f} of {flag_plan.n_clusters} chunks live a round; "
        f"culled bound {b:.3f} ms ({b / culled_ms:.1%}) on {smi}")
    check(0.0 < b <= culled_ms, f"culled flagship faster than its bound "
          f"{out['flagship_identity']}")
    del ln_c, live_c

    # The reference frame and 15,000 seeded spheres: culled bit for bit the
    # dense launch on the same lanes (phase 4a's for the reference frame).
    ref_pids = torch.arange(k1.lane_pad(ref_cfg.num_pixels),
                            dtype=torch.int32, device=dev)
    ref_plan = cluster_scene(ref_scene, size)
    args, cull = culled_args(ref_scene, ref_cam, ref_cfg, ref_pids, ref_plan)
    ref_culled_ms, (fb_c, ln_c) = cuda_ms(
        lambda: k1.render_lanes(*args, cull=cull), 2)
    dense_args = lane_args(ref_scene, ref_cam, ref_cfg, ref_pids)
    ref_dense_ms, _ = cuda_ms(lambda: k1.render_lanes(*dense_args), 2)
    same = torch.equal(fb_c, ref_fb) and torch.equal(ln_c, ref_ln)
    out["reference_frame"] = {"ms": ref_culled_ms, "dense_ms": ref_dense_ms,
                              "n_clusters": ref_plan.n_clusters}
    log(f"[culled] reference frame ({ref_scene.count} spheres, "
        f"{ref_plan.n_clusters} chunks): culled {ref_culled_ms:.3f} ms, dense "
        f"{ref_dense_ms:.3f} ms; bit for bit the dense launch: {same}")
    check(same, "the culled reference frame is not the dense one bit for bit")
    del fb_c, ln_c

    huge_cfg = flag_cfg.replace(width=320, height=240, samples_per_pixel=2,
                                max_depth=3)
    huge = random_scene(15000, seed=1)
    huge_cam = scenes.rtiow_final_camera(huge_cfg.aspect)
    huge_pids = torch.arange(k1.lane_pad(huge_cfg.num_pixels),
                             dtype=torch.int32, device=dev)
    huge_plan = cluster_scene(huge, size)
    args, cull = culled_args(huge, huge_cam, huge_cfg, huge_pids, huge_plan)
    before = counts()
    huge_ms, (fb_c, ln_c) = cuda_ms(lambda: k1.render_lanes(*args, cull=cull),
                                    1)
    global_launches = counts()[1] - before[1]
    dense_args = lane_args(huge, huge_cam, huge_cfg, huge_pids)
    huge_dense_ms, (fb_d, ln_d) = cuda_ms(lambda: k1.render_lanes(*dense_args),
                                          1)
    same = torch.equal(fb_c, fb_d) and torch.equal(ln_c, ln_d)
    out["seeded_15000"] = {"ms": huge_ms, "dense_ms": huge_dense_ms,
                           "n_clusters": huge_plan.n_clusters}
    log(f"[culled] 15000 seeded spheres at 320x240x2 depth 3 "
        f"({huge_plan.n_clusters} chunks, device-memory table: "
        f"{global_launches} of 2 launches): culled {huge_ms:.3f} ms, dense "
        f"{huge_dense_ms:.3f} ms; bit for bit the dense launch: {same}")
    check(same and global_launches == 2,
          f"15000 spheres: culled vs dense {same}, global launches "
          f"{global_launches}")
    del fb_c, ln_c, fb_d, ln_d

    # Cluster size 1: chunks of one small sphere, grazed from bounces far
    # away, where the member test's rounding takes hits just outside a
    # sphere that only the bound test's slack keeps live.
    one_cfg = flag_cfg.replace(width=96, height=64, samples_per_pixel=4,
                               max_depth=8)
    one = random_scene(2000, seed=3)
    one_cam = scenes.rtiow_final_camera(one_cfg.aspect)
    one_pids = torch.arange(k1.lane_pad(one_cfg.num_pixels),
                            dtype=torch.int32, device=dev)
    args, cull = culled_args(one, one_cam, one_cfg, one_pids,
                             cluster_scene(one, 1))
    before = counts()
    fb_c, ln_c = k1.render_lanes(*args, cull=cull)
    culled_launches = counts()[2] - before[2]
    fb_d, ln_d = k1.render_lanes(*lane_args(one, one_cam, one_cfg, one_pids))
    lanes = int(((fb_c != fb_d).any(1) | (ln_c != ln_d)).sum())
    out["seeded_2000_cluster_size_1"] = {"differing_lanes": lanes,
                                         "culled_launches": culled_launches}
    log(f"[culled] 2000 seeded spheres at 96x64x4 depth 8, cluster size 1 "
        f"({one.count} chunks): {culled_launches} culled launch; lanes that "
        f"differ from the dense launch: {lanes}")
    check(lanes == 0 and culled_launches == 1,
          f"cluster size 1: {lanes} lanes differ from dense, "
          f"{culled_launches} culled launches")

    # tools.livechunks at cluster sizes 12 and 64, 32 spp, every lane to
    # its end (so the dense launch is timed beside the culled one).
    out["livechunks"] = []
    for cs in ("12", "64"):
        check(livechunks.main([cs, "32", "0"]) == 0,
              f"tools.livechunks {cs} failed")
        out["livechunks"] += livechunks.RESULTS
    return leg[2], out, check_entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare
    from bevy_raytrace_tpu_torch.profile_grad import random_scene, smi_line
    from bevy_raytrace_tpu_torch.utils import spans
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed, render

    # The torch wavefront is the oracle: keep its matmuls in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. environment -------------------------------------------------
    t_start = time.perf_counter()
    smi = smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(f"[env] {smi}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log("[env] nvcc " + nvcc.stdout.strip().splitlines()[-1])

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load("k1_render")
    build_s = time.perf_counter() - t0
    log(f"[build] k1_render in {build_s:.2f} s "
        f"(nvcc {build.BUILD_LOG.get('k1_render', (0.0,))[0]:.2f} s)")
    for line in build.BUILD_LOG.get("k1_render", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    def lane_args(scene, cam, cfg, pids, frame=0):
        geom, attr = k1._scene_tables(scene)
        return (geom, attr, cam.pack().contiguous(), pids,
                frame_seed(cfg, frame), 0, cfg.samples_per_pixel,
                cfg.max_depth, cfg.t_min, cfg.width, cfg.height)

    def image(fb, cfg):
        return (fb[:cfg.num_pixels] / cfg.samples_per_pixel).reshape(
            cfg.height, cfg.width, 3).cpu().numpy()

    # ---- 3. parity at the verify config ---------------------------------
    verify = RenderConfig(width=240, height=160, samples_per_pixel=8,
                          max_depth=8)
    verify_times = {}
    for name, scene_fn, cam_fn in [
            ("rtiow_final", scenes.rtiow_final_scene, scenes.rtiow_final_camera),
            ("baseline_config2", scenes.baseline_config2_scene,
             scenes.baseline_config2_camera)]:
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(verify.aspect, device=dev)
        pids = torch.arange(k1.lane_pad(verify.num_pixels), dtype=torch.int32,
                            device=dev)
        args = lane_args(scene, cam, verify, pids)
        mode = k1.forward_table_mode("k1_render", dev, scene.count)
        kern_ms, (fb, _) = cuda_ms(lambda: k1.render_lanes(*args), 5)
        plain_ms, (fb_plain, _) = cuda_ms(
            lambda: k1.render_lanes_plain(*args), 1, warm=False)
        wave = render(scene, cam, verify).cpu().numpy()
        kimg = image(fb, verify)
        vs_twin = compare(kimg, image(fb_plain, verify), COMPILED)
        vs_wave = compare(kimg, wave, COMPILED)
        log(f"[verify] {name}: kernel ({mode} table) {kern_ms:.3f} ms, twin "
            f"{plain_ms:.1f} ms; vs twin {vs_twin}; vs wavefront {vs_wave}")
        check(vs_twin["ok"], f"{name}: kernel vs twin {vs_twin}")
        check(vs_wave["ok"], f"{name}: kernel vs torch wavefront {vs_wave}")
        perm = torch.randperm(verify.num_pixels, device=dev).to(torch.int32)
        check(torch.equal(k1.render_mxu(scene, cam, verify, perm=perm),
                          k1.render_mxu(scene, cam, verify)),
              f"{name}: a random perm changed the kernel image")
        verify_times[name] = (kern_ms, plain_ms, mode)

    # ---- 4a. K1 vs twin on the reference frame's lanes -------------------
    ref_cfg = RenderConfig(width=1920, height=1080, samples_per_pixel=64,
                           max_depth=3)
    ref_scene = scenes.reference_scene(0)[0]  # the default device: the card
    ref_cam = scenes.rtiow_final_camera(ref_cfg.aspect)
    ref_pids = torch.arange(k1.lane_pad(ref_cfg.num_pixels), dtype=torch.int32,
                            device=dev)
    args = lane_args(ref_scene, ref_cam, ref_cfg, ref_pids)
    ref_mode = k1.forward_table_mode("k1_render", dev, ref_scene.count)
    ref_ms, (ref_fb, ref_ln) = cuda_ms(lambda: k1.render_lanes(*args), 5)
    ref_rounds = float(ref_ln[:ref_cfg.num_pixels].sum())
    plain_ms, (fb_plain, _) = cuda_ms(lambda: k1.render_lanes_plain(*args), 1,
                                      warm=False)
    ref_vs_twin = compare(image(ref_fb, ref_cfg), image(fb_plain, ref_cfg),
                          COMPILED)
    log(f"[reference] kernel ({ref_mode} table) {ref_ms:.3f} ms, twin "
        f"{plain_ms:.1f} ms, {ref_scene.count} spheres; vs twin {ref_vs_twin}")
    check(ref_vs_twin["ok"], f"reference frame: kernel vs twin {ref_vs_twin}")
    del fb_plain

    # ---- 4. the main path: Renderer sessions + the flagship --------------
    zero_launches("k1")
    r = Renderer(ref_cfg)  # the defaults: backend "cuda" on the card
    check(r.backend == "cuda" and r.device.type == "cuda",
          "Renderer's defaults are not the CUDA kernel on the card")
    frame_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        img = r.render_frame(ref_scene, ref_cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    log("[reference] Renderer frames (probe, then cached perm): "
        + ", ".join(f"{m:.2f} ms" for m in frame_ms)
        + f"; {ref_cfg.rays_per_frame / (min(frame_ms[1:]) / 1e3) / 1e6:.1f}"
        f"M rays/s at the best cached-perm frame")
    check(tuple(img.shape) == (1080, 1920, 3), f"frame shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "reference frame not finite")
    last_frame = r.frame - 1

    flag_cfg = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                            max_depth=8)
    flag_scene = scenes.rtiow_final_scene(0)[0]
    flag_cam = scenes.rtiow_final_camera(flag_cfg.aspect)
    flag_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        flag = k1.render_mxu_balanced(flag_scene, flag_cam, flag_cfg)
        torch.cuda.synchronize()
        flag_s.append(time.perf_counter() - t0)
    launches = spans.counter("k1.launches")
    k1_modes = {"shared": launches - spans.counter("k1.launches_global"),
                "global": spans.counter("k1.launches_global")}
    check(tuple(flag.shape) == (800, 1200, 3) and bool(
        torch.isfinite(flag).all()), "flagship image not finite")
    flag_rps = flag_cfg.rays_per_frame / min(flag_s)
    log(f"[flagship] 1200x800x256 depth 8, {flag_scene.count} spheres: "
        + ", ".join(f"{s:.3f} s" for s in flag_s)
        + f" -> {flag_rps / 1e6:.1f}M rays/s on {smi}")

    # ---- 4b. one stripe of the last Renderer frame against the twin ------
    lo = 1000 * 1920  # 16,384 pixels from row 1000
    stripe = torch.arange(lo, lo + 16384, dtype=torch.int32, device=dev)
    fb_s, _ = k1.render_lanes_plain(*lane_args(ref_scene, ref_cam, ref_cfg,
                                               stripe, last_frame))
    got = img.reshape(-1, 3)[lo:lo + 16384].cpu().numpy()
    stripe_vs = compare(got, (fb_s / ref_cfg.samples_per_pixel).cpu().numpy(),
                        COMPILED)
    log(f"[reference] frame {last_frame} stripe vs twin {stripe_vs}")
    check(stripe_vs["ok"], f"reference stripe vs twin {stripe_vs}")

    # ---- 6. launches ------------------------------------------------------
    log(f"[launches] k1_render launches={launches} ({k1_modes}) over the "
        f"main path")
    check(launches > 0 and k1_modes["shared"] > 0,
          "K1 (staged table) was not launched by the main path")

    # The flagship frame's K1 time on identity lanes and its bound, from the
    # rounds this launch executed.
    flag_pids = torch.arange(k1.lane_pad(flag_cfg.num_pixels),
                             dtype=torch.int32, device=dev)
    flag_args = lane_args(flag_scene, flag_cam, flag_cfg, flag_pids)
    flag_ms, (_, ln) = cuda_ms(lambda: k1.render_lanes(*flag_args), 2)
    k1_flagship = {"ms": flag_ms, "rounds": float(ln.sum()),
                   **forward_bound("k1", flag_scene.count,
                                   flag_cfg.num_pixels,
                                   flag_cfg.samples_per_pixel,
                                   flag_cfg.max_depth, float(ln.sum()))}
    log(f"[flagship] K1 on identity lanes {flag_ms:.3f} ms, "
        f"{k1_flagship['rounds'] / flag_cfg.rays_per_frame:.4f} rounds per "
        f"path, bound {k1_flagship['bound_ms']:.3f} ms "
        f"({k1_flagship['bound_ms'] / flag_ms:.1%}) on {smi}")
    del ln

    # K1's global table on the same entry point: 15,000 seeded spheres
    # (240,000 bytes of rows, above what a block may stage), counted, and
    # held against the twin.
    huge_cfg = RenderConfig(width=64, height=48, samples_per_pixel=2,
                            max_depth=3)
    huge_scene = random_scene(15000, seed=1)
    huge_cam = scenes.rtiow_final_camera(huge_cfg.aspect)
    zero_launches("k1")
    huge_img = k1.render_mxu(huge_scene, huge_cam, huge_cfg)
    huge_counts = (spans.counter("k1.launches"),
                   spans.counter("k1.launches_global"))
    k1_modes["global"] += huge_counts[1]
    huge_pids = torch.arange(k1.lane_pad(huge_cfg.num_pixels),
                             dtype=torch.int32, device=dev)
    fb_h, _ = k1.render_lanes_plain(*lane_args(huge_scene, huge_cam, huge_cfg,
                                               huge_pids))
    huge_vs = compare(huge_img.cpu().numpy(), image(fb_h, huge_cfg), COMPILED)
    log(f"[k1] render_mxu on 15000 spheres {huge_cfg.width}x"
        f"{huge_cfg.height}x2 depth 3: launches (K1, global) {huge_counts}; "
        f"vs twin {huge_vs}")
    check(huge_counts == (1, 1) and huge_vs["ok"],
          f"K1's global table: launches {huge_counts}, vs twin {huge_vs}")

    # ---- 6b. K1's chunk-culled traversal (plan=) -------------------------
    culled_launches, k1_culled, k1_culled_check = culled_phase(
        dev, smi, (flag_scene, flag_cam, flag_cfg, flag, flag_s, flag_ms),
        (ref_scene, ref_cam, ref_cfg, ref_fb, ref_ln), lane_args)
    k1_modes["culled"] = culled_launches
    del ref_fb, ref_ln, flag

    k1_check = {
        "shape": "reference frame 1920x1080x64 depth 3", "mode": ref_mode,
        "max_abs_err": ref_vs_twin["max_abs_err"], "ms": ref_ms,
        "plain_ms": plain_ms,
        **forward_bound("k1", ref_scene.count, ref_cfg.num_pixels,
                        ref_cfg.samples_per_pixel, ref_cfg.max_depth,
                        ref_rounds)}
    phase_s = {"1-6": time.perf_counter() - t_start}

    def timed(phases, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phases] = time.perf_counter() - t0
        log(f"[time] phases {phases} in {phase_s[phases]:.1f} s")
        return out

    grad_launches, grad_stats, shared = timed("7-13", gradient_phases, dev,
                                              smi)
    ref = (ref_scene, ref_cam, ref_cfg)
    shard_launches, shard_stats = timed("14-17", sharded_phases, dev, smi,
                                        shared, ref)
    cli_launches, cli_stats = timed("18-22", cli_phases, dev, smi, shared,
                                    ref)
    tool_entries, tool_launches, tool_stats = timed("23-26", tool_phases,
                                                    dev, smi)
    bench_launches, bench_stats = timed("27", bench_phases, dev, smi)
    phase_s["total"] = time.perf_counter() - t_start
    log(f"[time] phases 1-6 in {phase_s['1-6']:.1f} s; the run in "
        f"{phase_s['total']:.1f} s")
    checks = shared["checks"]
    csrc = "bevy_raytrace_tpu_torch/csrc/"
    entries = [
        kernel_entry("k1_render", csrc + "k1_render.cu",
                     "bevy_raytrace_tpu/kernels/mxu_render.py:99", launches,
                     [k1_check]),
        kernel_entry("k2_record", csrc + "k2_record.cu",
                     "bevy_raytrace_tpu/kernels/pallas_render.py:123",
                     grad_launches["k2"], checks["k2"]),
        kernel_entry("k3_replay_grad", csrc + "k3_replay_grad.cu",
                     "bevy_raytrace_tpu/kernels/replay_grad.py:74",
                     grad_launches["k3"], checks["k3"]),
        kernel_entry("k4_sweep_record", csrc + "k4_sweep_record.cu",
                     "bevy_raytrace_tpu/kernels/sweep_record.py:60",
                     shard_launches["k4"], checks["k4"]),
    ]
    for entry, key in zip(entries, ("k1", "k2", "k3", "k4")):
        if key in grad_launches["recovery"]:
            entry["launches_recovery_path"] = grad_launches["recovery"][key]
        entry["launches_sharded_path"] = shard_launches[key]
        entry["launches_cli_path"] = cli_launches[key]
        entry["launches_tool_path"] = tool_launches[key]
        entry["launches_bench_path"] = bench_launches[key]
    entries[1]["launches_cli_path_clustered"] = cli_launches["k2_clustered"]
    # K1's and K4's table modes: the staged table on their main paths
    # (phases 4-5, 16), the global one on the 15,000-sphere scene through
    # the same entry points (render_mxu, render_sweep_record).
    entries[0]["launches_by_mode"] = k1_modes
    entries[3]["launches_by_mode"] = shard_launches["k4_modes"]
    entries[0]["flagship_frame"] = k1_flagship
    entries[0]["culled"] = k1_culled
    # The culled traversal is a kernel of its own (k1_culled_kernel, the
    # TPU kernel's n_cull > 0 branch), launched on phase 6b's leg.
    culled_entry = kernel_entry(
        "k1_render_culled", csrc + "k1_render.cu",
        "bevy_raytrace_tpu/kernels/mxu_render.py:364", k1_modes["culled"],
        [k1_culled_check])
    culled_entry["bound_share"] = k1_culled_check["bound_share"]
    culled_entry["flagship_identity"] = {
        k: k1_culled["flagship_identity"][k]
        for k in ("ms", "dense_ms", "bound_ms", "bound_share",
                  "live_chunks_per_round")}
    culled_entry["ptxas"] = k1_culled["ptxas"]
    for entry in (entries[0], entries[3]):
        check(all(v > 0 for v in entry["launches_by_mode"].values()),
              f"a {entry['name']} table mode was launched on no path: "
              f"{entry['launches_by_mode']}")
    # K3's table modes: the shared table over phases 10 and 12, the global one
    # on the large-scene gradient (both paths through make_fast_renderer).
    entries[2]["launches_by_mode"] = grad_launches["k3_modes"]
    check(all(v > 0 for v in grad_launches["k3_modes"].values()),
          f"a K3 table mode was launched on no path: "
          f"{grad_launches['k3_modes']}")
    entries += [culled_entry] + tool_entries
    for entry in entries:
        check(entry["launches"] > 0 and 0.0 < entry["bound_ms"]
              <= entry["ms"],
              f"{entry['name']}: not launched on its path, or faster than "
              f"its bound (the count of its work is wrong): {entry}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"phase_s": phase_s, "build_s": build_s,
                    "verify_ms": verify_times,
                    "reference_frame_ms": frame_ms,
                    "flagship_s": flag_s, "flagship_rays_per_s": flag_rps,
                    **grad_stats, **shard_stats, **cli_stats,
                    **tool_stats, **bench_stats}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
