#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and ``nvcc`` (found through ``CUDA_HOME`` or ``PATH``);
it imports no JAX. Phases, each reported on its own line:

1. device: the card's name, power limit and maximum SM clock (from
   ``nvidia-smi``), its SM count, the torch and CUDA versions; no CUDA
   device is a failure, never a CPU run;
2. build: compiles ``libwave_tpu_torch/csrc/segmm_g_a.cu``,
   ``libwave_tpu_torch/csrc/segmm_seg.cu``,
   ``libwave_tpu_torch/csrc/hamming.cu`` and
   ``libwave_tpu_torch/csrc/table_designs.cu`` (the first table kernel and
   the tensor-core rate probe) for sm_90a, one nvcc each, started together,
   and loads them;
3. kernel: the G/A kernel through its window entry point
   (``dense_g_a_window``: the full W, the landmark-sorted layout and Hinv,
   window bounds) at each band call of the headline problem's first
   linearization, against its plain version and against the plain G/A of
   the call's slices of W, ids and Hinv (the operands the build cut before),
   after checking that every slot the layout leaves out holds W exactly 0;
   then the reference-signature ``dense_g_a`` and the window entry on
   ``bench_problem.g_a_edge_cases`` (duplicate ids within a pose, ids -1
   and >= M, a run spanning 40 poses cut by the pose window, one-pose
   windows, empty runs, M = 77 with c1 - c0 not a multiple of 4): within
   1e-6 * max|plain| (both sum the same f32 terms, only the order may
   differ) and bit for bit at every cell with at most one nonzero slot; then
   both timed at the headline's 13 calls. Every kernel time here
   is device time: CUDA events around the replay of a CUDA graph of many
   calls (``bench_problem.device_ms``), apart from the plain segment
   reduce, which reads its longest run on the host and is timed on a
   synchronized host clock (``bench_problem.wall_ms``);
4. headline: ``solve_ba`` on the full headline problem (200 poses, 10,000
   landmarks, 300 observations per pose, f32, bands) with the benchmark's
   configuration. It must take the explicit-S path with exactly 13 G/A
   launches, 3 segment reduces and 1 segment broadcast per LM iteration,
   run with TF32 off and without a synchronizing
   CUDA call that PyTorch's sync debug mode detects, give finite costs that
   end below the initial cost, and follow the trajectory of the same solve
   with the plain G/A forced on the card (rtol 1e-3). It prints the CUDA
   kernels one explicit-S LM iteration runs (``torch.profiler``, in a child
   process running ``libwave_tpu_torch/launch_count.py``) beside the count
   of the tree before the window entry point. Then LM
   iterations/s for both, and a small f64 problem solved on the card
   against the CPU;
5. seg: the segment reduce and broadcast kernels against their plain
   versions at the headline's shapes (C = 3 and 6, K = 60,000, M = 10,000),
   the matrix-free profile's K = 480,000 and ``ba_large``'s problem
   (K = 600,000, M = 100,000, ids ordered by bearing), and on edge cases
   (ids < 0 and >= M, empty segments, C = 1 and 5, unaligned K, runs of
   ~120 slots at C = 6 in f64; for the broadcast
   ``bench_problem.broadcast_edge_cases``: K = 1, 3, 4,096, 4,097, C = 1,
   3, 5, 6, M = 300 and 22,000 (y past 384 KB), ids with storage offset 0
   and 1, f32 and f64):
   both bit for bit, the reduce bit-identical across two runs; then the
   kernel, the plain version and the one PyTorch call that computes the
   same function (``index_add_`` into zeros; ``index_select`` on y padded
   with a zero column), each timed as device time;
6. matrix_free: the 10-iteration headline solve with
   ``explicit_s="never"`` (matrix-free PCG): exactly 23 reduces and 22
   broadcasts per LM iteration (3 + 20 CG steps, 2 + 20) and no G/A launch,
   no synchronizing call, the first iteration within rtol 1e-3 of the same
   solve through the plain crossings, the final cost finite and below the
   initial; LM iterations/s through the kernels and through the plain
   crossings in alternating turns; and ``bench_problem.matvec_profile``
   (matvec ms at 300 to 2,400 observations per pose, the fit, the split by
   op);
7. vio: ``bench.py``'s ``bench_vio`` configuration (BASELINE config 4:
   120 landmarks, 600 steps, 10 Hz keyframes, 15 LM iterations, 60 CG steps,
   f32) built by the port from seeds, solved with ``solver="auto"`` (the
   dense path, one G/A launch per iteration) and ``solver="pcg"``: launch
   counts as worked out from the code, the synchronizing calls listed (only
   ``torch.linalg`` calls allowed), final cost and ATE below the initial
   perturbation's, keyframes/s, and the same solve on this machine's CPU
   through the plain versions (final cost within rtol 1e-2, keyframe
   positions within 1 cm: at f32 the stiff IMU information drowns the
   vision terms' last digits, and the port's own f32 and f64 solves on the
   CPU end about 1 mm apart in ATE);
8. euroc: ``bench.py``'s ``euroc`` configuration (an MH_01-like ASL
   sequence of 16 s, 200 landmarks, seed 3, written by the port's
   ``generate_euroc_sequence`` into a temporary directory;
   ``EurocVIOParams()`` and ``default_vio_config``: 25 LM iterations, the
   dense solver, f32) built and solved by the port on the card: 1 G/A, 3
   reduce and 1 broadcast launches per LM iteration, no synchronizing call
   inside ``solve_vio`` outside ``optim/schur.py``'s ``torch.linalg``
   lines, a finite final cost below the initial, ATE below the dead-reckoned
   start's and under 0.03 m (the JAX package's own bound,
   ``tests/test_euroc_vio.py``), and the same build and solve on this
   machine's CPU through the plain versions (final cost within rtol 1e-4,
   keyframe positions within 1 mm: a quarter of the ATE; the two solves
   have parted by 5.5e-6 in cost and 1.6e-4 m); keyframes, landmarks, ATE,
   RPE, build seconds and solve keyframes/s;
9. windowed: ``bench.py``'s ``euroc_long`` in full (130 s at 5 Hz, 600
   landmarks, seed 0: 651 keyframes; the sequence written with a CPU
   ``torch.Generator``, so a machine without a card writes the same
   directory: its sha256 must equal the one taken where the JAX package's
   ATE was read) through ``run_euroc_vio_windowed`` on the card, f32:
   ``WindowedVIOParams(window=80, overlap=10, passes=2)`` and the freeze
   ablation. Launches as worked out from the code (1 G/A, 3 reduces, 1
   broadcast per LM iteration; 1, 2, 1 per device Schur complement), no
   synchronizing call made inside a solver entry point outside
   ``optim/schur.py``'s ``torch.linalg`` lines (the host loop's, such as
   each window's transfers and the chunk's cost read, are listed), finite
   window costs, no complement falling back to the host, the 2-pass ATE
   below the freeze ablation's and under 0.05 m (the JAX package's bound,
   ``tests/test_windowed_vio.py``; its ATE on the same directory is
   printed beside), and the first 2 windows against the same
   on this machine's CPU (window costs within rtol 1e-4, positions within
   1 mm); solve and sequence keyframes/s, marginalization seconds;
10. mh01_scale: ``bench.py``'s ``euroc_mh01_scale`` at its widths (20 Hz
   camera, 200 Hz IMU, 900 landmarks, ``window=120, overlap=12``, one
   pass), its 182 s cut to 36 s (721 keyframes, 7 windows; sha256 checked
   as in windowed): the stiffness gate must widen the Hessian to f64
   (f32 state, f64 pose-block sums, Cholesky and carried prior), launches
   and syncs as in windowed, no host fallback, ATE within 1.5x + 1 mm of
   the JAX package's on the same directory, and the first 2 windows
   against the same widened path on this machine's CPU (window costs
   within rtol 1e-4, positions within 1 mm);
11. windowed_ba: the JAX package's windowed-BA test circle
   (``bench_problem.windowed_ba_circle``: 181 frames, 120 landmarks, noisy
   odometry and priors, numpy seeds) through ``solve_ba_windowed`` on the
   card, f32, ``window=60, overlap=10``, 40 LM iterations a window
   (explicit-S PCG): launches and syncs as worked out from the code,
   position error under 0.1 m and rotation error under 0.05 rad (the
   reference's bounds), and its first 2 windows against the CPU's with
   explicit S (costs within rtol 1e-4, positions within 1 mm);
12. hamming: both Hamming kernels against their plain versions on the card,
   exactly equal (integer outputs), at the frame's 512 x 512 x 16, at an
   unaligned 300 x 700 x 8 with ties, mask zeros, an all-masked bank and a
   single live column, at ``bench_frontend.top2_edge_cases`` (ties across
   and within the top-2's lanes, the only live column last, N2 = 1, 7, 33,
   100, 1,500, 4,500 and 2,200 query rows), the top-2 at 2,048^2 x 16 and
   16,384^2 x 16; the table also at ``bench_frontend.table_edge_cases``
   (W = 1, 2, 4, 8, 16, 32, N1 and N2 of 1, 7, 33, 100 and 4,097, a
   2,048-row bank) and on banks 4 bytes past a 16-byte boundary. Then the
   tensor cores' ``mma.sync`` rate on .b1 operands (and .s8), and each
   kernel timed as device time against its plain version: the top-2 at
   the frame, 2,048^2 and 16,384^2; the table at the frame, 4,096^2 and
   8,192^2 x 16 beside the first table kernel (CUDA cores) and
   ``torch.cdist(p=0)`` on the banks unpacked to 0/1 f32 bits, with two
   bounds: the bytes, and the bit operations at the measured .b1 rate (the
   first kernel's: the popcount issue rate);
13. pair: ``bench.py``'s two-frame pair (480x640 blobs and their (4, 7) roll,
   FAST-512, BRISK, knn ratio + RANSAC) on the card: one top-2 launch per
   pair, pairs/s with the kernel and with the plain top-2; then the same pair
   through the distance heuristic with cross check, one table launch per
   pair, the same matches as with the plain table;
14. sequence: the 25 EuRoC-resolution (752x480) frames of ``bench.py``'s
    front-end benchmark through ``track_sequence`` with ``FrontendParams()``:
    25 top-2 launches, tracks identical to the run with the plain top-2,
    contiguous tracks of mean length >= 3, rows and ids within 10% of the JAX
    package's figures on the same frames, frames/s for both runs, ms per
    frame by layer, and the synchronizing calls of one frame step (none
    allowed outside RANSAC's ``torch.linalg`` calls).

The line before the last is a JSON object describing each kernel (its
launches on its main path, its largest difference from the plain version,
its time, the plain version's and the library call's, and its bound: the
larger of the bytes it must move over 3.35 TB/s and its operations over
67 TFLOP/s, the H100 SXM's HBM rate and non-tensor f32 rate; the top-2's
XOR + popcount word operations over the popcount issue rate, 16 per SM per
clock at this card's SM count and maximum SM clock; the table's bit
operations, an AND and an add per bit pair, over the .b1 rate measured in
this run); the last
line is ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import inspect
import json
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import libwave_tpu_torch
from libwave_tpu_torch import (
    bench_designs,
    bench_frontend,
    bench_problem,
    bench_windowed,
)
from libwave_tpu_torch.ops import hamming, segmm
from libwave_tpu_torch.benchmark import Trajectory, absolute_trajectory_error
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim import ba, schur
from libwave_tpu_torch.optim.pose_graph import BetweenBank, PriorBank
from libwave_tpu_torch.pipelines import (
    euroc_vio,
    vio,
    visual_frontend,
    windowed_ba,
    windowed_vio,
)
from libwave_tpu_torch.sim import euroc_sim
from libwave_tpu_torch.utils import precision
from libwave_tpu_torch.vision import matcher
from libwave_tpu_torch.vision.descriptor import brisk_describe
from libwave_tpu_torch.vision.detector import FASTParams, detect_fast
from libwave_tpu_torch.vision.tracker import add_image_features, tracker_init

HERE = Path(__file__).resolve().parent
KERNEL_SOURCE = "libwave_tpu_torch/csrc/segmm_g_a.cu"
KERNEL_REPLACES = "libwave_tpu/ops/segmm.py:190"
HAMMING_SOURCE = "libwave_tpu_torch/csrc/hamming.cu"
TABLE_DESIGNS_SOURCE = "libwave_tpu_torch/csrc/table_designs.cu"
TOP2_REPLACES = "libwave_tpu/ops/hamming.py:103"
TABLE_REPLACES = "libwave_tpu/ops/hamming.py:27"
SEG_SOURCE = "libwave_tpu_torch/csrc/segmm_seg.cu"
REDUCE_REPLACES = "libwave_tpu/ops/segmm.py:65"
BROADCAST_REPLACES = "libwave_tpu/ops/segmm.py:117"
# the H100 SXM's published HBM rate and non-tensor f32 rate (NVIDIA's data
# sheet), the denominators of every kernel's bound
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# __popc issues at 16 per SM per clock on Hopper (sm_90): the Hamming
# kernels' rate is this times the SM count times the maximum SM clock
POPC_PER_SM_CLOCK = 16
LM_ITERS = 10
# kernels of one explicit-S LM iteration when the dense reduced system still
# copied W, lm_slot - c0 and Hinv per G/A call (3 per call, 39 per
# iteration): launch_count.py --root on a checkout of that tree, on an
# NVIDIA H100 80GB HBM3 with torch 2.11
KERNELS_BEFORE_WINDOW = 1455
BAND_CALLS = 13  # band plan entries x pose runs of the headline problem
REL_TOL = 1e-6
# The JAX package's track_sequence(frames, FrontendParams()) on the same 25
# frames (bench_frontend.make_euroc_frames(), bit-identical to its PNGs), run
# on a CPU with jax_enable_x64 in its default (scan) mode: 1,435 track rows,
# 373 landmark ids, mean track length 3.847. The card has no JAX.
JAX_TRACK_ROWS = 1435
JAX_TRACK_IDS = 373
SEQUENCE_FRAMES = 25
# bench.py's euroc phase (bench_euroc): the sequence and its seed
EUROC_SIM = euroc_sim.EurocSimParams(duration=16.0, nb_landmarks=200)
EUROC_SEED = 3
EUROC_ATE_BOUND_M = 0.03  # the JAX package's bound, tests/test_euroc_vio.py
# bench.py's euroc_long phase (bench_euroc_long), in full: 651 keyframes
WINDOWED_SIM = bench_windowed.LONG_SIM
WINDOWED_ATE_BOUND_M = 0.05  # the JAX package's, tests/test_windowed_vio.py
# bench.py's euroc_mh01_scale configuration at its widths (20 Hz camera,
# 200 Hz IMU, 900 landmarks, W=120, O=12), its 182 s cut to 36 s (721
# keyframes, 7 windows) to fit this script's time
MH01_SIM = dataclasses.replace(bench_windowed.MH01_SIM, duration=36.0)
# The JAX package's run_euroc_vio_windowed (f32 with explicit f64, as
# bench.py runs it) on the same directories, written by this port's
# generate_euroc_sequence with a CPU generator, on a CPU: ATE in m, and the
# sha256 of the directories' imu0/data.csv and cam0/tracks.csv there
# (tests/windowed_anchors.py long jax32, mh01_36 jax32).
JAX_WINDOWED_ATE = {"marginalize_2pass": 0.022929711267352104,
                    "freeze": 0.030840111896395683}
JAX_MH01_ATE = 0.057505033910274506
SEQUENCE_SHA256 = {
    "windowed": ("5c10acfb06069452169a36b28e3cec39a597312bc6a6c048ff73f8f26fa2ab67",
                 "def2627aba3eabad8923ef0bd5798e316385c14a11951b645f13b57bd87dcf29"),
    "mh01_scale": ("3b1ba5f05e9b34bbd0828ff98029b4213792c695a4867b769590587fddb3b586",
                   "ffb3097319cdfa8c71912bafed7195d3c450929e3eab2bea96e49ffd4d37739e"),
}
# windowed_ba: the JAX package's test circle, its bounds (the reference's
# gtsam_offline_example.cpp:150,155)
WBA_POS_BOUND_M = 0.1
WBA_ROT_BOUND_RAD = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: this script runs only "
          "on an NVIDIA GPU")
    check(
        Path(libwave_tpu_torch.__file__).resolve().parent.parent == HERE,
        f"libwave_tpu_torch imported from {libwave_tpu_torch.__file__}, not "
        f"from this checkout",
    )
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_rate = POPC_PER_SM_CLOCK * sms * float(clock) * 1e6
    print(f"device: {name} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s) | "
          f"{sms} SMs, max SM clock {clock} MHz: {popc_rate:.4e} popcounts/s "
          f"({POPC_PER_SM_CLOCK} per SM per clock)")
    print(f"nvidia-smi: {smi}")
    return name, smi, popc_rate


COUNTED = {
    "segmm_g_a": segmm.dense_g_a_window,
    "seg_reduce": segmm.seg_reduce_sorted,
    "seg_broadcast": segmm.seg_broadcast,
    "hamming_top2": hamming.hamming_top2,
    "hamming_table": hamming.hamming_distance,
}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts():
    """Every kernel's launch count since the last reset."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def bound(nbytes, ops=0.0, ops_per_s=ALU_OPS_PER_S):
    """(bound_ms, bound_by): the larger of moving ``nbytes`` over the HBM
    rate and doing ``ops`` at ``ops_per_s`` (by default the non-tensor f32
    rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_build(build):
    t0 = time.perf_counter()
    log = build()
    return log, time.perf_counter() - t0


def phase_build():
    """One nvcc per source, all started together."""
    builds = ((KERNEL_SOURCE, segmm.build), (SEG_SOURCE, segmm.build_seg),
              (HAMMING_SOURCE, hamming.build),
              (TABLE_DESIGNS_SOURCE,
               lambda: bench_designs.table_library()[1]))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(_timed_build, b) for _, b in builds]
        results = [f.result() for f in futures]
    for (source, _), (log, dt) in zip(builds, results):
        print(f"build: {source} built for sm_90a and loaded in {dt:.3f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas: {line.strip()}")


def _compare(case, G, A, Gr, Ar, worst, single=None):
    """Within 1e-6 * max|plain|; bit for bit at the cells in ``single``
    (those that take at most one nonzero slot)."""
    for what, x, ref in (("G", G, Gr), ("A", A, Ar)):
        scale = float(ref.abs().max())
        err = float((x - ref).abs().max())
        rel = err / scale if scale > 0 else err
        worst["abs"] = max(worst["abs"], err)
        worst["rel"] = max(worst["rel"], rel)
        check(
            err <= REL_TOL * scale,
            f"kernel {case} {what}: max abs err {err:.3e} > "
            f"{REL_TOL:g} * max|plain| = {REL_TOL * scale:.3e}",
        )
        if single is not None:
            bad = int((x != ref)[single.expand_as(x)].sum())
            check(bad == 0, f"kernel {case} {what}: {bad} cells with at most "
                  f"one nonzero slot differ from the plain version")


def _nonzero_slots(W, ids, M):
    """(N, 1, M) count of the slots with a nonzero W that name each column
    (ids outside [0, M) name none)."""
    ok = (ids >= 0) & (ids < M) & (W != 0).any(0)
    count = torch.zeros((ids.shape[0], M), dtype=torch.int32, device=W.device)
    count.scatter_add_(1, torch.where(ok, ids, 0).long(), ok.int())
    return count[:, None, :]


def _check_window(case, W, ell, lm_slot, hinv, window, worst):
    """The window kernel against its plain version and against the plain
    G/A of the window's slices of W, lm_slot - c0 and hinv (the operands
    the dense reduced system cut per build call before the window entry)."""
    c0, c1, plo, phi = window
    G, A = segmm.dense_g_a_window(W, ell, hinv, *window)
    Gw, Aw = segmm.dense_g_a_window_reference(W, ell, hinv, *window)
    ids = lm_slot[plo:phi] - c0
    Gr, Ar = segmm.dense_g_a_reference(W[:, plo:phi], ids, hinv[:, c0:c1])
    single = _nonzero_slots(W[:, plo:phi], ids, c1 - c0) <= 1
    torch.cuda.synchronize()
    _compare(case, G, A, Gw, Aw, worst, single)
    _compare(f"{case} (slices)", G, A, Gr, Ar, worst, single)


def _left_out(W, ell):
    """(slots the layout lists in no run, largest |W| among them)."""
    listed = torch.zeros(W.shape[1] * W.shape[2], dtype=torch.bool,
                         device=W.device)
    listed[ell.sigma[int(ell.offsets[0]):int(ell.offsets[-1])].long()] = True
    out = ~listed.reshape(W.shape[1:])
    return int(out.sum()), float(W[:, out].abs().max()) if out.any() else 0.0


def _time_calls(fn, operands, reps=20):
    """Device ms per pass over ``operands`` (``bench_problem.device_ms``:
    CUDA events around a CUDA graph's replay)."""
    def one_pass():
        for ops in operands:
            fn(*ops)

    return bench_problem.device_ms(one_pass, reps)


def phase_kernel(problem, state, cfg):
    lam = torch.tensor(cfg.init_lambda, dtype=state.p.dtype,
                       device=state.p.device)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, lam)
    calls = [
        (c0, c1, plo, phi)
        for (c0, c1, ranges) in problem.bands.entries
        for (plo, phi) in ranges
    ]
    check(len(calls) == BAND_CALLS,
          f"headline band plan has {len(calls)} G/A calls, expected "
          f"{BAND_CALLS}")
    W, ell, hinv = blocks.W, blocks.ell, blocks.Hll_inv
    N, P = W.shape[1:]
    lm_slot = blocks.lm_idx.reshape(N, P)
    # the kernel takes a slot's W only from the layout's runs: the slots the
    # layout leaves out (zero weight) must hold W exactly 0
    n_out, w_out = _left_out(W, ell)
    check(w_out == 0.0, f"kernel: {n_out} slots left out of the layout's runs "
          f"hold W up to {w_out:.3e}, not exactly 0")
    worst = {"abs": 0.0, "rel": 0.0}
    for c in calls:
        _check_window(f"band cols [{c[0]},{c[1]}) poses [{c[2]},{c[3]})",
                      W, ell, lm_slot, hinv, c, worst)
    cells = sum((phi - plo) * (c1 - c0) for (c0, c1, plo, phi) in calls)
    print(f"kernel: {len(calls)} headline band calls ({cells} pose x column "
          f"cells) through the window entry match its plain version and the "
          f"plain G/A of each call's slices of W, lm_slot and hinv: max abs "
          f"err {worst['abs']:.3e}, max rel err {worst['rel']:.3e}, equal "
          f"bit for bit at every cell with at most one nonzero slot; the "
          f"{n_out} slots left out of the layout's runs hold W exactly 0")
    names = []
    for name, *arrays, windows in bench_problem.g_a_edge_cases():
        Wc, ids, hc = (torch.as_tensor(a, device=state.p.device)
                       for a in arrays)
        M = hc.shape[1]
        G, A = segmm.dense_g_a(Wc, ids, hc)
        Gr, Ar = segmm.dense_g_a_reference(Wc, ids, hc)
        torch.cuda.synchronize()
        _compare(f"edge case {name} (reference signature)", G, A, Gr, Ar,
                 worst, _nonzero_slots(Wc, ids, M) <= 1)
        ell_c = segmm.sorted_layout(ids.reshape(-1), M)
        for window in windows:
            _check_window(f"edge case {name} window {window}", Wc, ell_c,
                          ids, hc, window, worst)
        names.append(f"{name}: {len(windows)} windows")
    print(f"kernel: edge cases through dense_g_a and dense_g_a_window ("
          f"{'; '.join(names)}) match: overall max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} (limit "
          f"{REL_TOL:g} * max|plain|)")
    operands = [(W, ell, hinv, *c) for c in calls]
    ms = _time_calls(segmm.dense_g_a_window, operands)
    plain_ms = _time_calls(segmm.dense_g_a_window_reference, operands)
    out_mb = 2 * 4 * 18 * cells / 1e6
    # bytes: each slot of a call's window read once (its 18 W values and
    # its sigma entry), the window's offsets and hinv columns, G and A
    # written once; operations: the G sums (one add per W value) and A's 3
    # multiply-adds per value
    pose = ell.sigma.long() // P
    slots = 0
    for c0, c1, plo, phi in calls:
        run = pose[int(ell.offsets[c0]):int(ell.offsets[c1])]
        slots += int(((run >= plo) & (run < phi)).sum())
    cols = sum(c1 - c0 for (c0, c1, _, _) in calls)
    nbytes = slots * (18 + 1) * 4 + cols * (6 + 1) * 4 + 2 * 4 * 18 * cells
    ops = 18 * slots + 18 * 6 * cells
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"kernel: one LM iteration's {len(calls)} G/A calls take {ms:.4f} "
          f"ms (kernel) vs {plain_ms:.4f} ms (plain); {out_mb:.1f} MB of G "
          f"and A written, {out_mb / ms / 1e3:.3f} TB/s (kernel); {slots} "
          f"slots in the windows; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {ops:.3e} ops); no single PyTorch call "
          f"computes G and A")
    return {"max_abs_err": worst["abs"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _g_a(plain):
    """Route the solve's G/A build to the kernel or to the plain version."""
    return mock.patch.object(
        schur, "dense_g_a_window",
        segmm.dense_g_a_window_reference if plain else segmm.dense_g_a_window,
    )


def _solve(problem, state, cfg, plain=False):
    with _g_a(plain):
        out, info = ba.solve_ba(problem, state, cfg)
    torch.cuda.synchronize()
    return out, info


def _launches_per_iteration():
    """The kernels of one explicit-S LM iteration of the headline problem,
    counted by ``libwave_tpu_torch/launch_count.py`` in a child process:
    ``torch.profiler`` leaves its hooks in the process that used it, which
    slowed every later launch of that process on the card, and so the rates
    this script measures."""
    proc = subprocess.run(
        [sys.executable, str(HERE / "libwave_tpu_torch" / "launch_count.py")],
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"launch_count.py failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_headline(problem, state, cfg, smi):
    N, M = problem.free_pose.shape[0], state.lm.shape[0]
    check(
        ba._use_explicit_s(cfg, N, 6, M, 4, problem.ell, None, problem.bands,
                           device=state.p.device),
        "the headline problem does not take the explicit-S path",
    )
    # the solve must turn TF32 off whatever the caller set
    tf32_seen = []
    real_pcg = schur.pcg

    def pcg_spy(*args, **kwargs):
        tf32_seen.append(precision.tf32_enabled())
        return real_pcg(*args, **kwargs)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # the LM and CG loops must never wait on the device: PyTorch's sync
        # debug mode warns on every synchronizing call it detects
        with mock.patch.object(schur, "pcg", pcg_spy), _g_a(plain=False), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_launches()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, info = ba.solve_ba(problem, state, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts = launch_counts()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise SmokeFailure(
            f"{len(syncs)} synchronizing CUDA calls inside solve_ba, first "
            f"at {syncs[0].filename}:{syncs[0].lineno}"
        )
    # per LM iteration: 13 G/A calls; the Hll and bl reduces of the normal
    # equations and back-substitution's reduce; schur_rhs's broadcast (the
    # explicit-S preconditioner is read off S: no broadcast)
    want = dict(segmm_g_a=BAND_CALLS * LM_ITERS, seg_reduce=3 * LM_ITERS,
                seg_broadcast=LM_ITERS, hamming_top2=0, hamming_table=0)
    check(counts == want, f"headline: launches {counts} in {LM_ITERS} LM "
          f"iterations, expected {want}")
    launches_ga = counts["segmm_g_a"]
    check(len(tf32_seen) == LM_ITERS and not any(tf32_seen),
          f"TF32 was on inside solve_ba ({tf32_seen})")
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all(),
          f"non-finite costs: {c0}, {costs}")
    check(costs[-1] < c0, f"final cost {costs[-1]} not below initial {c0}")
    print(f"headline: explicit-S path, {launches_ga} G/A, "
          f"{counts['seg_reduce']} reduce and {counts['seg_broadcast']} "
          f"broadcast kernel launches in {LM_ITERS} LM iterations, TF32 "
          f"off, no synchronizing call detected inside solve_ba; cost "
          f"{c0:.6e} -> "
          f"{costs[-1]:.6e}, accepted "
          f"{int(info['accepted'].sum())}/{LM_ITERS}")
    per_iter = _launches_per_iteration()
    print(f"headline: one explicit-S LM iteration runs {per_iter['kernels']} "
          f"CUDA kernels on the device ({per_iter['own_kernels']} of them "
          f"the package's: G/A, reduce, broadcast), "
          f"{per_iter['launch_calls']} runtime launch calls on the host "
          f"(torch.profiler, libwave_tpu_torch/launch_count.py); the tree "
          f"before the window entry point ran {KERNELS_BEFORE_WINDOW} "
          f"({KERNELS_BEFORE_WINDOW - per_iter['kernels']} more)")
    _, info_p = _solve(problem, state, cfg, plain=True)
    costs_p = info_p["costs"].cpu().numpy().astype(np.float64)
    rel = np.abs(costs - costs_p) / np.abs(costs_p)
    check(np.allclose(costs, costs_p, rtol=1e-3, atol=0.0),
          f"kernel trajectory {costs} vs plain G/A trajectory {costs_p}")
    print(f"headline: cost trajectory matches the plain-G/A solve on the "
          f"card (max rel diff {rel.max():.3e}, rtol 1e-3): "
          f"{' '.join(f'{c:.6e}' for c in costs)}")

    rates = {"kernel": [], "plain": []}
    final = {}
    for which in ("kernel", "plain", "plain", "kernel"):
        with _g_a(plain=which == "plain"):
            rate, cost = bench_problem.bench_backend(problem, state, LM_ITERS)
        rates[which].append(rate)
        final[which] = cost
    print(f"headline: {np.median(rates['kernel']):.4f} LM iterations/s with "
          f"the G/A kernel (runs {rates['kernel'][0]:.4f}, "
          f"{rates['kernel'][1]:.4f}), final cost {final['kernel']:.6e} | "
          f"{smi}")
    print(f"headline: {np.median(rates['plain']):.4f} LM iterations/s with "
          f"the plain G/A (runs {rates['plain'][0]:.4f}, "
          f"{rates['plain'][1]:.4f}), final cost {final['plain']:.6e} | "
          f"{smi}")
    return launches_ga


def phase_small_reference(dev):
    """The same small f64 solve on the card and on the CPU (matrix-free
    PCG: the f32-only G/A kernel is checked above)."""
    cfg = dataclasses.replace(bench_problem.bench_config(3),
                              explicit_s="never")
    out = {}
    for device in (torch.device("cpu"), dev):
        problem, state = bench_problem.make_problem(
            num_poses=20, num_landmarks=500, obs_per_pose=40, device=device
        )
        problem = problem._replace(
            K=problem.K.double(), uv=problem.uv.double(),
            weight=problem.weight.double(),
            free_pose=problem.free_pose.double(),
        )
        state = ba.BAState(*(x.double() for x in state))
        _, info = ba.solve_ba(problem, state, cfg)
        out[device.type] = info["costs"].cpu().numpy()
    check(np.allclose(out["cuda"], out["cpu"], rtol=1e-6, atol=0.0),
          f"small f64 solve: card {out['cuda']} vs CPU {out['cpu']}")
    print(f"reference: small f64 problem (20 poses, 500 landmarks) solves "
          f"alike on the card and the CPU (rtol 1e-6): "
          f"{' '.join(f'{c:.9e}' for c in out['cuda'])}")


def _seg_compare(case, kern, got, ref, stats):
    """Largest |kernel - plain|; the kernel must equal its plain version
    bit for bit (both add in slot order; the broadcast copies)."""
    err = (got.double() - ref.double()).abs()
    stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
    check(torch.equal(got, ref), f"seg {case}: {kern} kernel and plain "
          f"version differ at {int((got != ref).sum())} outputs (max abs "
          f"err {float(err.max()):.3e})")


def _seg_cases(problem, dev):
    """(name, C, dtype, sigma, offsets, idx, M) cases: the headline layout,
    the matrix-free profile's 2,400 observations per pose, ba_large's
    problem, and small edge cases."""
    ell = problem.ell
    M = problem.bands.entries[-1][1]
    big, _ = bench_problem.make_problem(obs_per_pose=2400, device=dev)
    large, _ = bench_problem.ba_large_problem(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    edge = torch.randint(-3, 780, (12_345,), generator=gen, device=dev,
                         dtype=torch.int32)
    edge[100:400] = 500  # a long run; ids 777..779 and < 0 are outside
    long_runs = torch.randint(0, 500, (60_000,), generator=gen, device=dev,
                              dtype=torch.int32)  # runs of ~120 slots
    return [
        ("headline C=3", 3, torch.float32, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("headline C=6", 6, torch.float32, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("headline C=3 f64", 3, torch.float64, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("profile K=480,000", 3, torch.float32, big.ell.sigma,
         big.ell.offsets, big.lm_idx, M),
        ("ba_large K=600,000 M=100,000", 3, torch.float32, large.ell.sigma,
         large.ell.offsets, large.lm_idx, 100_000),
        ("edge C=1 K=12,345 M=777, ids < 0 and >= M, empty segments", 1,
         torch.float32, *segmm.sorted_layout(edge, 777), edge, 777),
        ("edge long runs C=6 f64 K=60,000 M=500", 6, torch.float64,
         *segmm.sorted_layout(long_runs, 500), long_runs, 500),
        ("edge C=5 f64 K=12,345 M=777", 5,
         torch.float64, *segmm.sorted_layout(edge, 777), edge, 777),
    ]


def phase_seg(problem, dev, smi):
    stats = {k: {"max_abs_err": 0.0} for k in ("seg_reduce", "seg_broadcast")}
    gen = torch.Generator(device=dev).manual_seed(6)
    timed = {}
    for name, C, dtype, sigma, offsets, idx, M in _seg_cases(problem, dev):
        K = idx.shape[0]
        vals = torch.randn((C, K), generator=gen, device=dev, dtype=dtype)
        out = segmm.seg_reduce_sorted(vals, sigma, offsets)
        again = segmm.seg_reduce_sorted(vals, sigma, offsets)
        ref = segmm.seg_reduce_sorted_reference(vals, sigma, offsets)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"seg {name}: two reduce runs are not bit-identical")
        _seg_compare(name, "reduce", out, ref, stats["seg_reduce"])
        generic = segmm.seg_reduce(vals, idx, M)
        check(torch.equal(generic, segmm.seg_reduce_reference(vals, idx, M)),
              f"seg {name}: seg_reduce (device sort) differs from its plain "
              f"version")
        y = torch.randn((C, M), generator=gen, device=dev, dtype=dtype)
        # the broadcast also sees ids < 0 and >= M
        bidx = idx.clone()
        bidx[:7] = torch.tensor([-1, -5, M, M + 3, 0, M - 1, 2**30],
                                dtype=torch.int32, device=dev)
        _seg_compare(name, "broadcast", segmm.seg_broadcast(y, bidx),
                     segmm.seg_broadcast_reference(y, bidx),
                     stats["seg_broadcast"])
        timed[name] = (vals, sigma, offsets, idx, y, M)
    edges = 0
    for name, y, ids, off in bench_problem.broadcast_edge_cases():
        for dtype in (torch.float32, torch.float64):
            yt = torch.as_tensor(y, device=dev).to(dtype)
            idx = torch.as_tensor(ids, device=dev)[off:]
            _seg_compare(f"broadcast edge {name} {dtype}", "broadcast",
                         segmm.seg_broadcast(yt, idx),
                         segmm.seg_broadcast_reference(yt, idx),
                         stats["seg_broadcast"])
            edges += 1
    print(f"seg: reduce and broadcast equal their plain versions bit for bit "
          f"(max abs err {stats['seg_reduce']['max_abs_err']:.3e} and "
          f"{stats['seg_broadcast']['max_abs_err']:.3e}), the reduce "
          f"bit-identical across two runs, at {', '.join(timed)}; the "
          f"broadcast also at {edges} edge cases (K = 1, 3, 4,096, 4,097; "
          f"C = 1, 3, 5, 6; M = 300 and 22,000; ids with storage offset 0 "
          f"and 1; f32 and f64)")

    for name, (vals, sigma, offsets, idx, y, M) in timed.items():
        if name.startswith("edge") or "f64" in name:
            continue
        C, K = vals.shape
        used = int(offsets[-1])  # slots that belong to a segment
        idx_l = idx.long()
        zeros = torch.zeros((C, M), dtype=vals.dtype, device=dev)
        ypad = torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)
        clamped = torch.where((idx >= 0) & (idx < M), idx_l, M)
        t = {
            "seg_reduce": (
                bench_problem.device_ms(
                    lambda: segmm.seg_reduce_sorted(vals, sigma, offsets)),
                # it synchronizes: host clock
                bench_problem.wall_ms(
                    lambda: segmm.seg_reduce_sorted_reference(
                        vals, sigma, offsets), reps=5),
                bench_problem.device_ms(
                    lambda: zeros.clone().index_add_(1, idx_l, vals)),
                # the vals and sigma of the slots in a segment and the
                # offsets read once, the sums written once
                bound((C * used + C * M) * vals.element_size()
                      + (used + M + 1) * 4, C * used),
            ),
            "seg_broadcast": (
                bench_problem.device_ms(lambda: segmm.seg_broadcast(y, idx)),
                bench_problem.device_ms(
                    lambda: segmm.seg_broadcast_reference(y, idx), reps=20),
                bench_problem.device_ms(
                    lambda: ypad.index_select(1, clamped)),
                # y and the ids read once, the gathered values written once
                bound((C * M + C * K) * y.element_size() + K * 4),
            ),
        }
        # the reduce gathers vals[c, sigma[p]]: each 4- or 8-byte value in
        # its own 32-byte sector, C * used sector reads
        sectors_mb = C * used * 32 / 1e6
        for kern, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in t.items():
            gathers = (f"; its {sectors_mb:.1f} MB of gathered 32-byte "
                       f"sectors at {sectors_mb / ms / 1e3:.3f} TB/s"
                       if kern == "seg_reduce" else "")
            print(f"seg: {kern} {name}: {ms:.4f} ms (kernel) vs "
                  f"{plain_ms:.4f} ms (plain) vs {lib_ms:.4f} ms (library "
                  f"call); bound {bound_ms:.4f} ms ({bound_by}){gathers}, "
                  f"device time | {smi}")
            if name == "headline C=3":
                stats[kern].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
    return stats


def _plain_crossings(plain):
    """Route the Schur crossings to the segment kernels or to their plain
    versions."""
    if not plain:
        return contextlib.nullcontext()
    return mock.patch.multiple(
        segmm, seg_reduce_sorted=segmm.seg_reduce_sorted_reference,
        seg_broadcast=segmm.seg_broadcast_reference)


def _sync_free(fn, solvers=None):
    """Run ``fn`` under PyTorch's sync debug mode. Returns its result and
    the synchronizing calls seen, as {file:line: count}; with ``solvers``
    (a set of (resolved source file, function name)), two such counters:
    the calls made while one of those functions was on the stack, and the
    others (a windowed run's host loop)."""
    inside, other = collections.Counter(), collections.Counter()
    resolved = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = solvers and {
            (resolved.setdefault(f.filename, Path(f.filename).resolve()),
             f.name) for f in traceback.extract_stack()}
        site = f"{filename}:{lineno}"
        (inside if not solvers or frames & solvers else other)[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (out, inside, other) if solvers else (out, inside)


def phase_matrix_free(problem, state, smi):
    cfg = dataclasses.replace(bench_problem.bench_config(LM_ITERS),
                              explicit_s="never")
    cg = cfg.cg_max_iters
    reset_launches()
    (_, info), syncs = _sync_free(
        lambda: ba.solve_ba(problem, state, cfg))
    counts = launch_counts()
    check(not syncs, f"matrix_free: synchronizing calls inside solve_ba: "
          f"{dict(syncs)}")
    # per LM iteration: reduces of Hll, bl and back-substitution plus one
    # per CG matvec; broadcasts of schur_rhs and the preconditioner's self
    # blocks plus one per CG matvec
    want = dict(segmm_g_a=0, seg_reduce=(3 + cg) * LM_ITERS,
                seg_broadcast=(2 + cg) * LM_ITERS, hamming_top2=0,
                hamming_table=0)
    check(counts == want, f"matrix_free: launches {counts}, expected {want}")
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all() and costs[-1] < c0,
          f"matrix_free: costs {c0} -> {costs}")
    with _plain_crossings(True):
        _, info_p = ba.solve_ba(problem, state, cfg)
    costs_p = info_p["costs"].cpu().numpy().astype(np.float64)
    check(np.allclose(costs[0], costs_p[0], rtol=1e-3, atol=0.0),
          f"matrix_free: first iteration {costs[0]} vs {costs_p[0]} through "
          f"the plain crossings")
    rel = np.abs(costs - costs_p) / np.abs(costs_p)
    print(f"matrix_free: explicit_s='never', {counts['seg_reduce']} reduce "
          f"and {counts['seg_broadcast']} broadcast launches in {LM_ITERS} "
          f"LM iterations ({3 + cg} and {2 + cg} per iteration at {cg} CG "
          f"steps, as worked out from the code), no G/A launch, no "
          f"synchronizing call; cost {c0:.6e} -> {costs[-1]:.6e}; the plain "
          f"crossings' trajectory differs by at most {rel.max():.3e} "
          f"(first iteration {rel[0]:.3e}, rtol 1e-3): "
          f"{' '.join(f'{c:.6e}' for c in costs)}")
    rates = {"kernel": [], "plain": []}
    final = {}
    for which in ("kernel", "plain", "plain", "kernel"):
        with _plain_crossings(which == "plain"):
            rate, cost = bench_problem.bench_backend(problem, state, cfg=cfg)
        rates[which].append(rate)
        final[which] = cost
    for which in ("kernel", "plain"):
        r = rates[which]
        print(f"matrix_free: {np.median(r):.4f} LM iterations/s through the "
              f"{which} crossings (runs {r[0]:.4f}, {r[1]:.4f}), final cost "
              f"{final[which]:.6e} | {smi}")
    prof = bench_problem.matvec_profile(state.p.device)
    ops = prof.pop("ba_matvec_op_ms")
    print(f"matrix_free: matvec_profile (device time, 50 matvecs each; wall: host clock): "
          + ", ".join(f"{k} {v:.4f}" for k, v in prof.items())
          + " | per op at 300 obs/pose (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ops.items()) + f" | {smi}")
    return counts


def _move(x, dev):
    """A problem or state (NamedTuples of tensors) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_move(v, dev) for v in x))
    return x


def _ate(gt, est):
    t = torch.arange(gt.q.shape[0], dtype=torch.float64)
    truth = Trajectory(t, SE3(gt.q.double().cpu(), gt.p.double().cpu()))
    traj = Trajectory(t, SE3(est.q.double().cpu(), est.p.double().cpu()))
    return float(absolute_trajectory_error(truth, traj)[0])


def _schur_linalg_sites():
    """file:line of every ``torch.linalg`` call in ``optim/schur.py``: the
    dense solves' factorizations, the only synchronizing calls a VIO solve
    may make."""
    src = Path(inspect.getsourcefile(schur))
    return {f"{src}:{i}" for i, line in
            enumerate(src.read_text().splitlines(), 1)
            if "torch.linalg." in line}


def phase_vio(dev, smi):
    problem, gt, init = bench_problem.make_vio_problem(device=dev)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    K = problem.lm_idx.shape[0]
    it = bench_problem.vio_config().max_iterations
    cg = bench_problem.vio_config().cg_max_iters
    ate0 = _ate(gt, init)
    aligned = K % 4 == 0 and problem.lm_idx.data_ptr() % 16 == 0
    print(f"vio: bench_vio's problem built by the port from seeds 2, 3, 4 "
          f"(its own draws, not the JAX package's): {N} keyframes, {M} "
          f"landmarks, {K} observation slots (K % 4 = {K % 4}: the broadcast "
          f"takes its {'16-byte' if aligned else 'scalar'} path), f32; ATE "
          f"of the start {ate0:.6f} m")
    linalg_sites = _schur_linalg_sites()
    # per LM iteration, dense: reduces of Hll, bl and back-substitution,
    # schur_rhs's broadcast, one G/A build; PCG: as the matrix-free BA
    # path, with cg_max_iters matvecs
    wants = {
        "auto": dict(segmm_g_a=it, seg_reduce=3 * it, seg_broadcast=it,
                     hamming_top2=0, hamming_table=0),
        "pcg": dict(segmm_g_a=0, seg_reduce=(3 + cg) * it,
                    seg_broadcast=(2 + cg) * it, hamming_top2=0,
                    hamming_table=0),
    }
    cpu = torch.device("cpu")
    problem_cpu, init_cpu = _move(problem, cpu), _move(init, cpu)
    out = {}
    for solver, want in wants.items():
        cfg = bench_problem.vio_config(solver)
        reset_launches()
        (est, info), syncs = _sync_free(
            lambda: vio.solve_vio(problem, init, cfg))
        counts = launch_counts()
        check(counts == want, f"vio {solver}: launches {counts}, expected "
              f"{want}")
        stray = sorted(set(syncs) - linalg_sites)
        check(not stray, f"vio {solver}: synchronizing calls outside "
              f"torch.linalg: {stray}")
        c0 = float(info["initial_cost"])
        cost = float(info["final_cost"])
        ate = _ate(gt, est)
        check(np.isfinite(cost) and cost < c0 and ate < ate0,
              f"vio {solver}: cost {c0} -> {cost}, ATE {ate0} -> {ate}")
        est_cpu, info_cpu = vio.solve_vio(problem_cpu, init_cpu, cfg)
        cost_cpu = float(info_cpu["final_cost"])
        dp = float((est.p.cpu() - est_cpu.p).abs().max())
        check(abs(cost - cost_cpu) <= 1e-2 * abs(cost_cpu) and dp <= 1e-2,
              f"vio {solver}: card final cost {cost} vs CPU {cost_cpu}, "
              f"keyframe positions differ by {dp} m")
        rates = []
        for _ in range(2):
            rate, _ = bench_problem.bench_vio(problem, init, solver)
            rates.append(rate)
        listed = ", ".join(f"{Path(k).name}:{k.rsplit(':', 1)[1]} x{v}"
                           for k, v in sorted(syncs.items())) or "none"
        print(f"vio {solver}: {counts['segmm_g_a']} G/A, "
              f"{counts['seg_reduce']} reduce and {counts['seg_broadcast']} "
              f"broadcast launches in {it} LM iterations (as worked out from "
              f"the code); synchronizing calls: {listed}; cost {c0:.6e} -> "
              f"{cost:.6e} (CPU, plain versions: {cost_cpu:.6e}, ATE "
              f"{_ate(gt, est_cpu):.6f} m; keyframe positions within "
              f"{dp:.3e} m); ATE {ate0:.6f} -> {ate:.6f} m; "
              f"{np.median(rates):.3f} keyframes/s (runs "
              f"{', '.join(f'{r:.3f}' for r in rates)}) | {smi}")
        out[solver] = counts
    return out


def _euroc_build(root, params, device):
    """``build_euroc_vio_problem`` on ``device`` (f32) and its seconds, the
    device synchronized."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    built = euroc_vio.build_euroc_vio_problem(root, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return built, time.perf_counter() - t0


def phase_euroc(dev, smi):
    params = euroc_vio.EurocVIOParams()
    cfg = euroc_vio.default_vio_config(params)
    it = cfg.max_iterations
    with tempfile.TemporaryDirectory(prefix="euroc_") as root:
        t0 = time.perf_counter()
        euroc_sim.generate_euroc_sequence(root, EUROC_SIM, seed=EUROC_SEED,
                                          device=dev)
        gen_s = time.perf_counter() - t0
        (problem, init, gt_traj, kf_times), build_s = _euroc_build(
            root, params, dev)
        N, M = init.q.shape[0], init.lm.shape[0]
        check(init.q.dtype == torch.float32 and kf_times.dtype ==
              torch.float64, "euroc: the problem is not f32 or the times "
              "are not f64")
        # per LM iteration on the dense path (N * 15 <= dense_max_pose_dim
        # and M <= dense_max_landmarks): one G/A build, the reduces of Hll,
        # bl and back-substitution, schur_rhs's broadcast
        want = dict(segmm_g_a=it, seg_reduce=3 * it, seg_broadcast=it,
                    hamming_top2=0, hamming_table=0)
        reset_launches()
        (state, info), syncs = _sync_free(
            lambda: vio.solve_vio(problem, init, cfg))
        counts = launch_counts()
        check(counts == want, f"euroc: launches {counts} in {it} LM "
              f"iterations, expected {want}")
        stray = sorted(set(syncs) - _schur_linalg_sites())
        check(not stray, f"euroc: synchronizing calls inside solve_vio "
              f"outside torch.linalg: {stray}")
        rep = euroc_vio.euroc_report(gt_traj, kf_times, init, state, info)
        c0, cost = rep["initial_cost"], rep["final_cost"]
        ate, ate0 = rep["ate_rmse"], rep["ate_rmse_deadreckon"]
        check(np.isfinite(cost) and cost < c0,
              f"euroc: cost {c0} -> {cost}")
        check(ate < ate0 and ate < EUROC_ATE_BOUND_M,
              f"euroc: ATE {ate} m (dead reckoning {ate0} m, bound "
              f"{EUROC_ATE_BOUND_M} m)")
        cpu = torch.device("cpu")
        (problem_c, init_c, gt_c, kf_c), build_cpu_s = _euroc_build(
            root, params, cpu)
        est_c, info_c = vio.solve_vio(problem_c, init_c, cfg)
        rep_c = euroc_vio.euroc_report(gt_c, kf_c, init_c, est_c, info_c)
        dp = float((state.p.cpu() - est_c.p).abs().max())
        check(abs(cost - rep_c["final_cost"]) <= 1e-4 * abs(rep_c["final_cost"])
              and dp <= 1e-3, f"euroc: card final cost {cost} vs CPU "
              f"{rep_c['final_cost']}, keyframe positions differ by {dp} m")
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, info_t = vio.solve_vio(problem, init, cfg)
            float(info_t["final_cost"])
            times.append(time.perf_counter() - t0)
    listed = ", ".join(f"{Path(k).name}:{k.rsplit(':', 1)[1]} x{v}"
                       for k, v in sorted(syncs.items())) or "none"
    print(f"euroc: bench.py's euroc sequence (16 s, 200 Hz IMU, 5 Hz camera, "
          f"200 landmarks, seed {EUROC_SEED}) written by the port in "
          f"{gen_s:.3f} s; {N} keyframes, {M} landmarks, "
          f"{int((problem.obs_weight > 0).sum())} live observations; built "
          f"in {build_s:.3f} s on the card ({build_cpu_s:.3f} s on the CPU), "
          f"f32 | {smi}")
    print(f"euroc: {counts['segmm_g_a']} G/A, {counts['seg_reduce']} reduce "
          f"and {counts['seg_broadcast']} broadcast launches in {it} LM "
          f"iterations (dense path, as worked out from the code); "
          f"synchronizing calls: {listed}; cost {c0:.6e} -> {cost:.6e} (CPU, "
          f"plain versions: {rep_c['final_cost']:.6e}, relative difference "
          f"{abs(cost / rep_c['final_cost'] - 1):.3e} (rtol 1e-4), ATE "
          f"{rep_c['ate_rmse']:.6f} m; keyframe positions within {dp:.3e} m, "
          f"bound 1e-3 m)")
    print(f"euroc: ATE {ate:.6f} m (dead reckoning {ate0:.6f} m, bound "
          f"{EUROC_ATE_BOUND_M} m), RPE {rep['rpe_trans_rmse']:.6f} m "
          f"{rep['rpe_rot_rmse']:.6f} rad; solve "
          f"{N / np.median(times):.3f} keyframes/s (runs "
          f"{', '.join(f'{N / t:.3f}' for t in times)}), build + solve "
          f"{N / (build_s + np.median(times)):.3f} keyframes/s | {smi}")
    return counts


def _solver_entry_points():
    """(file, name) of the solver entry points a windowed run calls: a
    synchronizing call made while one of them is on the stack fails."""
    return {(Path(inspect.getsourcefile(m)).resolve(), name)
            for m, names in ((vio, ("solve_vio", "vio_marginalize_device",
                                    "vio_reduced_hessian")),
                             (ba, ("solve_ba", "ba_reduced_hessian")))
            for name in names}


def _sites(counter):
    return ", ".join(f"{Path(k).name} x{v}"
                     for k, v in sorted(counter.items())) or "none"


def _windowed_launches(iters, n_marg):
    """Per dense LM iteration: 1 G/A build, the reduces of Hll, bl and
    back-substitution, schur_rhs's broadcast; per Schur complement
    (``vio_marginalize_device``, ``vio_reduced_hessian`` or
    ``ba_reduced_hessian``): 1 G/A, the reduces of Hll and bl, 1
    broadcast."""
    return dict(segmm_g_a=iters + n_marg, seg_reduce=3 * iters + 2 * n_marg,
                seg_broadcast=iters + n_marg, hamming_top2=0,
                hamming_table=0)


def _solver_checked(what, fn, n_marg_of, sync_debug=True):
    """Drive ``fn`` (a windowed solve returning its report last) with the
    launch counts set to 0 and, with ``sync_debug``, PyTorch's sync debug
    mode on (it slows each LM iteration by a third to a half); check the
    launches against the code's (``n_marg_of(report)`` complements) and
    that no solver entry point synchronized outside ``torch.linalg``."""
    reset_launches()
    if sync_debug:
        out, inside, host = _sync_free(fn, _solver_entry_points())
    else:
        out, inside, host = fn(), None, None
    counts = launch_counts()
    rep = out[-1]
    iters = sum(rep["window_iterations"])
    want = _windowed_launches(iters, n_marg_of(rep))
    check(counts == want, f"{what}: launches {counts} in {iters} LM "
          f"iterations, expected {want}")
    stray = sorted(set(inside or ()) - _schur_linalg_sites())
    check(not stray, f"{what}: synchronizing calls inside the solvers "
          f"outside torch.linalg: {stray}")
    return out, counts, inside, host


def _vio_marg_count(rep):
    """Complements a windowed VIO run made: every solved window but the
    last of a pass (marginalization mode), plus the host fallbacks."""
    if rep["mode"] != "marginalize":
        return 0
    solved = len(rep["window_iterations"])
    return solved - solved // rep["num_windows"] + rep["marg_host_fallbacks"]


def _write_sequence(root, sim, name):
    """Write ``sim`` with ``bench_windowed.write_sequence`` (the port's
    generator on a CPU ``torch.Generator``: the directory a machine without
    a card writes too); its hashes must be those of the directory the JAX
    package's ATE was read on."""
    gen_s, hashes = bench_windowed.write_sequence(root, sim)
    hashes = tuple(hashes[f] for f in ("imu0/data.csv", "cam0/tracks.csv"))
    print(f"{name}: sequence written in {gen_s:.3f} s (CPU generator, seed "
          f"{bench_windowed.SEED}): sha256 imu0/data.csv {hashes[0]}, "
          f"cam0/tracks.csv {hashes[1]}")
    check(hashes == SEQUENCE_SHA256[name], f"{name}: the sequence is not "
          f"the directory the JAX package's ATE was read on (sha256 "
          f"{SEQUENCE_SHA256[name]})")
    return gen_s


def _windowed_run(root, wp, device, stop=None):
    return windowed_vio.run_euroc_vio_windowed(
        root, euroc_vio.EurocVIOParams(), wp, device=device,
        stop_after_windows=stop)


def _check_dense(what, rep):
    cfg = euroc_vio.default_vio_config(euroc_vio.EurocVIOParams())
    check(ba._use_dense_schur(cfg, rep["window"], 15, 6,
                              rep["num_landmarks_padded"], 4, None),
          f"{what}: the windows do not take the dense path "
          f"(W {rep['window']}, M {rep['num_landmarks_padded']})")


def _rates(rep):
    return (f"solve {rep['solve_keyframes_per_s']:.3f} keyframes/s, "
            f"sequence {rep['sequence_keyframes_per_s']:.3f} keyframes/s, "
            f"solve {rep['solve_seconds']:.3f} s, marginalization "
            f"{rep['marginalization_seconds']:.3f} s, "
            f"marg_host_fallbacks {rep['marg_host_fallbacks']}")


def _card_vs_cpu(what, root, wp, card):
    """``card``, the (estimate, report) of the first 2 windows of ``wp`` on
    the card, against the same on this machine's CPU through the plain
    versions: the same Hessian dtype, no host fallback, window costs within
    rtol 1e-4 and keyframe positions within 1 mm."""
    est, rep = card
    t0 = time.perf_counter()
    est_c, rep_c = _windowed_run(root, wp, torch.device("cpu"), 2)
    cpu_s = time.perf_counter() - t0
    check(rep["hessian_dtype"] == rep_c["hessian_dtype"],
          f"{what}: hessian_dtype {rep['hessian_dtype']} on the card, "
          f"{rep_c['hessian_dtype']} on the CPU")
    check(rep["marg_host_fallbacks"] == 0, f"{what}: "
          f"{rep['marg_host_fallbacks']} complements of the first 2 windows "
          f"fell back to the host")
    c_card = np.asarray(rep["window_final_costs"])
    c_cpu = np.asarray(rep_c["window_final_costs"])
    rel = float(np.abs(c_card / c_cpu - 1).max())
    dp = float((est.poses.t - est_c.poses.t).abs().max())
    check(rel <= 1e-4 and dp <= 1e-3, f"{what}: first 2 windows' costs "
          f"{c_card} on the card vs {c_cpu} on the CPU, positions within "
          f"{dp} m")
    print(f"{what}: first 2 windows, card vs this machine's CPU (plain "
          f"versions, hessian_dtype {rep['hessian_dtype']}, {cpu_s:.3f} s): "
          f"costs {' '.join(f'{c:.6e}' for c in c_card)} vs "
          f"{' '.join(f'{c:.6e}' for c in c_cpu)}, relative difference "
          f"{rel:.3e} (rtol 1e-4), positions within {dp:.3e} m (bound 1e-3 "
          f"m); iterations {rep['window_iterations']} vs "
          f"{rep_c['window_iterations']}")


def phase_windowed(dev, smi):
    wp, wf = bench_windowed.LONG_WINDOWS, bench_windowed.LONG_FREEZE
    with tempfile.TemporaryDirectory(prefix="euroc_long_") as root:
        _write_sequence(root, WINDOWED_SIM, "windowed")
        # the rates come from runs without sync debug mode
        (_, rep), counts, _, _ = _solver_checked(
            "windowed", lambda: _windowed_run(root, wp, dev), _vio_marg_count,
            sync_debug=False)
        (_, rep_f), counts_f, _, _ = _solver_checked(
            "windowed freeze", lambda: _windowed_run(root, wf, dev),
            _vio_marg_count, sync_debug=False)
        # sync debug mode over the first 2 windows, which are also held
        # against the CPU
        two, counts2, inside, host = _solver_checked(
            "windowed 2 windows", lambda: _windowed_run(root, wp, dev, 2),
            _vio_marg_count)
        _card_vs_cpu("windowed", root, wp, two)
    for what, r in (("2-pass", rep), ("freeze", rep_f)):
        _check_dense(f"windowed {what}", r)
        costs = np.asarray(r["window_final_costs"])
        check(np.isfinite(costs).all(), f"windowed {what}: costs {costs}")
    check(rep["marg_host_fallbacks"] == 0,
          f"windowed: {rep['marg_host_fallbacks']} complements fell back to "
          f"the host")
    ate, ate_f = rep["ate_rmse"], rep_f["ate_rmse"]
    check(ate < ate_f and ate < WINDOWED_ATE_BOUND_M,
          f"windowed: 2-pass ATE {ate} m, freeze {ate_f} m, bound "
          f"{WINDOWED_ATE_BOUND_M} m")
    iters = sum(rep["window_iterations"])
    print(f"windowed: bench.py's euroc_long in full: {rep['num_keyframes']} "
          f"keyframes, {rep['num_windows']} windows of {rep['window']} "
          f"(overlap {rep['overlap']}), 2 passes, f32 (hessian_dtype "
          f"{rep['hessian_dtype']}), {rep['num_landmarks_padded']} landmark "
          f"slots a window | {smi}")
    print(f"windowed: {counts['segmm_g_a']} G/A, {counts['seg_reduce']} "
          f"reduce and {counts['seg_broadcast']} broadcast launches in "
          f"{iters} LM iterations and {_vio_marg_count(rep)} device "
          f"complements (as worked out from the code; freeze: "
          f"{counts_f['segmm_g_a']}/{counts_f['seg_reduce']}/"
          f"{counts_f['seg_broadcast']} in "
          f"{sum(rep_f['window_iterations'])} iterations; the first 2 "
          f"windows: {counts2['segmm_g_a']}/{counts2['seg_reduce']}/"
          f"{counts2['seg_broadcast']} in "
          f"{sum(two[1]['window_iterations'])} iterations and "
          f"{_vio_marg_count(two[1])} complements); "
          f"synchronizing calls over those 2 windows (sync debug mode) "
          f"inside the solvers: {_sites(inside)}; in the host loop: "
          f"{_sites(host)}")
    jax = JAX_WINDOWED_ATE
    print(f"windowed: ATE 2-pass {ate:.6f} m, freeze {ate_f:.6f} m (bound "
          f"{WINDOWED_ATE_BOUND_M} m; the JAX package on this directory: "
          f"{jax['marginalize_2pass']} and {jax['freeze']} m), RPE "
          f"{rep['rpe_trans_rmse']:.6f} m; 2-pass {_rates(rep)}; freeze "
          f"{_rates(rep_f)} | {smi}")
    return counts


def phase_mh01_scale(dev, smi):
    wp = bench_windowed.MH01_WINDOWS
    with tempfile.TemporaryDirectory(prefix="euroc_mh01_") as root:
        _write_sequence(root, MH01_SIM, "mh01_scale")
        (_, rep), counts, inside, host = _solver_checked(
            "mh01_scale", lambda: _windowed_run(root, wp, dev),
            _vio_marg_count)
        two, counts2, _, _ = _solver_checked(
            "mh01_scale 2 windows", lambda: _windowed_run(root, wp, dev, 2),
            _vio_marg_count, sync_debug=False)
        _card_vs_cpu("mh01_scale", root, wp, two)
    _check_dense("mh01_scale", rep)
    costs = np.asarray(rep["window_final_costs"])
    check(np.isfinite(costs).all(), f"mh01_scale: costs {costs}")
    check(rep["hessian_dtype"] == "float64", f"mh01_scale: hessian_dtype "
          f"{rep['hessian_dtype']}, the stiffness gate did not widen")
    check(rep["marg_host_fallbacks"] == 0, f"mh01_scale: "
          f"{rep['marg_host_fallbacks']} complements fell back to the host")
    ate = rep["ate_rmse"]
    check(ate <= 1.5 * JAX_MH01_ATE + 1e-3, f"mh01_scale: ATE {ate} m, the "
          f"JAX package's {JAX_MH01_ATE} m on this directory")
    print(f"mh01_scale: bench.py's euroc_mh01_scale at its widths, cut to "
          f"{MH01_SIM.duration:g} s: {rep['num_keyframes']} keyframes, "
          f"{rep['num_windows']} windows of {rep['window']} (overlap "
          f"{rep['overlap']}), f32 with hessian_dtype "
          f"{rep['hessian_dtype']}; {counts['segmm_g_a']} G/A, "
          f"{counts['seg_reduce']} reduce and {counts['seg_broadcast']} "
          f"broadcast launches in {sum(rep['window_iterations'])} LM "
          f"iterations and {_vio_marg_count(rep)} device complements (as "
          f"worked out from the code; the first 2 windows: "
          f"{counts2['segmm_g_a']}/{counts2['seg_reduce']}/"
          f"{counts2['seg_broadcast']} in "
          f"{sum(two[1]['window_iterations'])} iterations and "
          f"{_vio_marg_count(two[1])} complements); synchronizing calls "
          f"inside the solvers: {_sites(inside)}; in the host loop: "
          f"{_sites(host)}")
    print(f"mh01_scale: ATE {ate:.6f} m (the JAX package on this directory: "
          f"{JAX_MH01_ATE} m; bound 1.5x + 1 mm), RPE "
          f"{rep['rpe_trans_rmse']:.6f} m; under sync debug mode: "
          f"{_rates(rep)} | {smi}")
    return counts


def _wba_run(c, frames, wp, cfg, device):
    def bank(cls, fields):
        return cls(**{k: torch.as_tensor(v).to(device)
                      for k, v in fields.items()})

    return windowed_ba.solve_ba_windowed(
        c["K"], c["tracks"], frames, c["q_init"], c["p_init"],
        between=bank(BetweenBank, c["between"]),
        priors=bank(PriorBank, c["priors"]), wparams=wp, cfg=cfg,
        device=device)


def phase_windowed_ba(dev, smi):
    c = bench_problem.windowed_ba_circle()
    N = c["num_frames"]
    wp = windowed_ba.WindowedBAParams(window=60, overlap=10)
    cfg = ba.BAConfig(max_iterations=40, cg_max_iters=150, huber_delta=3.0)
    (q, p, rep), counts, inside, host = _solver_checked(
        "windowed_ba", lambda: _wba_run(c, N, wp, cfg, dev),
        lambda r: r["num_windows"] - 1)
    pos = float(np.linalg.norm(p - c["p_gt"], axis=-1).max())
    rot = float(so3.rotation_distance(torch.as_tensor(q),
                                      torch.as_tensor(c["q_gt"])).max())
    costs = np.asarray(rep["window_final_costs"])
    check(np.isfinite(costs).all() and pos < WBA_POS_BOUND_M
          and rot < WBA_ROT_BOUND_RAD, f"windowed_ba: costs {costs}, "
          f"position error {pos} m, rotation error {rot} rad")
    # card against CPU: the first two windows' frames; the CPU takes the
    # card's explicit-S PCG ("auto" picks it only on a CUDA device)
    two = wp.window + (wp.window - wp.overlap)
    (_, p2, rep2), _, _, _ = _solver_checked(
        "windowed_ba 2 windows", lambda: _wba_run(c, two, wp, cfg, dev),
        lambda r: r["num_windows"] - 1)
    t0 = time.perf_counter()
    _, p_c, rep_c = _wba_run(c, two, wp, dataclasses.replace(
        cfg, explicit_s="always"), torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    c_card = np.asarray(rep2["window_final_costs"])
    c_cpu = np.asarray(rep_c["window_final_costs"])
    rel = float(np.abs(c_card / c_cpu - 1).max())
    dp = float(np.abs(p2 - p_c).max())
    check(rel <= 1e-4 and dp <= 1e-3, f"windowed_ba: first 2 windows' costs "
          f"{c_card} on the card vs {c_cpu} on the CPU, positions within "
          f"{dp} m")
    iters = sum(rep["window_iterations"])
    print(f"windowed_ba: the JAX package's test circle (VoSimParams("
          f"nb_landmarks=120, steps=2000, fx=fy=200, hz=10), numpy seeds 0 "
          f"and 1): {N} frames, {len(c['tracks'])} observations, "
          f"{rep['num_windows']} windows of {rep['window']} (overlap "
          f"{rep['overlap']}), f32; {counts['segmm_g_a']} G/A, "
          f"{counts['seg_reduce']} reduce and {counts['seg_broadcast']} "
          f"broadcast launches in {iters} LM iterations and "
          f"{rep['num_windows'] - 1} reduced Hessians (explicit-S PCG, as "
          f"worked out from the code); synchronizing calls inside the "
          f"solvers: {_sites(inside)}; in the host loop: {_sites(host)}")
    print(f"windowed_ba: position error max {pos:.6f} m (bound "
          f"{WBA_POS_BOUND_M}), rotation error max {rot:.6f} rad (bound "
          f"{WBA_ROT_BOUND_RAD}); under sync debug mode: solve "
          f"{rep['solve_seconds']:.3f} s "
          f"({N * rep['passes'] / rep['solve_seconds']:.3f} frames/s), "
          f"marginalization {rep['marginalization_seconds']:.3f} s; first 2 "
          f"windows card vs CPU ({cpu_s:.3f} s): costs "
          f"{' '.join(f'{x:.6e}' for x in c_card)} vs "
          f"{' '.join(f'{x:.6e}' for x in c_cpu)}, relative {rel:.3e} (rtol "
          f"1e-4), positions within {dp:.3e} m (bound 1e-3 m) | {smi}")
    return counts


def _frame_bank(frame, dev, params=FASTParams(threshold=20.0, num_features=512)):
    img = torch.as_tensor(frame, device=dev).to(torch.float32)
    xy, _, m = detect_fast(img, params)
    desc, m = brisk_describe(img, xy, m)
    return xy, desc, m


def _hamming_cases(frames, dev):
    """(name, d1, d2, mask2) int32 banks on the card. The frame case is two
    consecutive frames' BRISK banks, as the tracker matches them."""
    rng = np.random.default_rng(2)

    def bank(n, w):
        words = rng.integers(0, 2**32, (n, w), dtype=np.uint64)
        return words.astype(np.uint32).view(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    _, d_prev, _ = _frame_bank(frames[0], dev)
    _, d_curr, m_curr = _frame_bank(frames[1], dev)
    d2 = bank(700, 8)
    d2[500:] = d2[:200]  # duplicate reference rows: ties at the best
    d1 = np.concatenate([d2[:100], bank(200, 8)])
    mask = rng.random(700) < 0.7
    one = np.zeros(700, bool)
    one[333] = True
    big2 = bank(16384, 16)
    big1 = big2[rng.permutation(16384)].copy()
    big1 ^= (rng.random(big1.shape) < 0.05).astype(np.int32) << 7  # near copies
    edges = [(f"edge: {name}", t(a.view(np.int32)), t(b.view(np.int32)),
              None if m is None else t(m))
             for name, a, b, m in bench_frontend.top2_edge_cases()]
    return {
        "both": [
            ("frame 512x512x16", d_prev, d_curr, m_curr),
            ("300x700x8 ties, mask zeros", t(d1), t(d2), t(mask)),
            ("300x700x8 all masked", t(d1), t(d2), t(np.zeros(700, bool))),
            ("300x700x8 one live column", t(d1), t(d2), t(one)),
            *edges,
        ],
        "top2": ("16384x16384x16", t(big1), t(big2), None),
    }


def _exact(case, got, ref, stats):
    """Integer outputs: count mismatches and the largest difference."""
    for g, r in zip(got, ref):
        diff = (g.to(torch.int64) - r.to(torch.int64)).abs()
        stats["mismatches"] += int((diff != 0).sum())
        stats["max_abs_err"] = max(stats["max_abs_err"], float(diff.max()))
    check(stats["mismatches"] == 0,
          f"{case}: kernel and plain version differ in {stats['mismatches']} "
          f"entries (max abs err {stats['max_abs_err']:g})")


def _bits(d):
    """(N, W) int32 words -> (N, 32 W) f32 0/1 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], -1).float()


def _table_library(d1, d2, reps):
    """Device ms of ``torch.cdist(a, b, p=0)`` on the banks unpacked to 0/1
    f32 bits, the unpack outside the timed region: the one PyTorch call
    that computes the Hamming table; and whether it equals the plain table.
    (None, None), with the reason printed, where it does not run on the
    card."""
    a, b = _bits(d1), _bits(d2)
    try:
        table = torch.cdist(a, b, p=0)
        torch.cuda.synchronize()
        ms = bench_problem.device_ms(lambda: torch.cdist(a, b, p=0), reps)
    except RuntimeError as e:
        print(f"hamming: library call: none, torch.cdist(p=0) does not run on "
              f"the card here: {str(e).splitlines()[0]}")
        return None, None
    same = torch.equal(table.to(torch.int32),
                       hamming.hamming_distance_reference(d1, d2))
    return ms, same


def _unaligned(d, dev):
    """A contiguous copy of ``d`` 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(d.numel() + 1, dtype=d.dtype, device=dev)
    view = flat[1:].view(d.shape)
    view.copy_(d)
    return view


def phase_hamming(frames, dev, smi, popc_rate):
    cases = _hamming_cases(frames, dev)
    out = {k: {"mismatches": 0, "max_abs_err": 0.0} for k in ("top2", "table")}
    big1, big2 = cases["top2"][1:3]
    mid = ("2048x2048x16", big1[:2048], big2[:2048], None)
    for name, d1, d2, m2 in cases["both"] + [mid, cases["top2"]]:
        got = hamming.hamming_top2(d1, d2, m2)
        ref = hamming.hamming_top2_reference(d1, d2, m2)
        torch.cuda.synchronize()
        _exact(f"top-2 {name}", got, ref, out["top2"])
    table_edges = [(name, *(torch.as_tensor(x.view(np.int32), device=dev)
                            for x in banks), None)
                   for name, *banks in bench_frontend.table_edge_cases()]
    d_unaligned = _unaligned(big2[:600], dev)
    check(d_unaligned.data_ptr() % 16 != 0, "hamming: the unaligned bank is "
          "16-byte aligned")
    tables = [(f"{n}x{n}x16", big1[:n], big2[:n], None) for n in (4096, 8192)]
    for name, d1, d2, m2 in (cases["both"] + table_edges + tables + [
            ("600x600x16 banks 4 bytes past a 16-byte boundary",
             d_unaligned, d_unaligned, None)]):
        got = hamming.hamming_distance(d1, d2)
        ref = hamming.hamming_distance_reference(d1, d2)
        torch.cuda.synchronize()
        _exact(f"table {name}", (got,), (ref,), out["table"])
        del got, ref
    print(f"hamming: top-2 and table kernels equal their plain versions "
          f"exactly at {', '.join(c[0] for c in cases['both'])}; the top-2 "
          f"also at {mid[0]} and {cases['top2'][0]}; the table also at "
          f"{', '.join(c[0] for c in table_edges + tables)} and on banks 4 "
          f"bytes past a 16-byte boundary")

    rates = bench_designs.mma_rates(dev)
    b1_rate = rates["b1"]
    print("hamming: mma.sync on register operands, 8 blocks of 8 warps per "
          "SM, device time: " + ", ".join(
              f"{k} {v:.4e} operations/s" for k, v in rates.items())
          + f" | {smi}")

    frame = cases["both"][0][1:]
    for name, ops, reps, plain_reps in (
            ("frame 512x512x16", frame, 50, 50),
            (mid[0], mid[1:], 20, 2),
            (cases["top2"][0], cases["top2"][1:], 5, 1)):
        ms = _time_calls(hamming.hamming_top2, [ops], reps)
        plain_ms = _time_calls(hamming.hamming_top2_reference, [ops],
                               plain_reps)
        # bytes: both banks and the mask read once, three int32 outputs
        # written once; operations: one XOR + popcount per word pair, at
        # the popcount issue rate
        n1, w = ops[0].shape
        n2 = ops[1].shape[0]
        mask_bytes = n2 if ops[2] is not None else 0
        bound_ms, bound_by = bound((n1 + n2) * w * 4 + mask_bytes + 3 * n1 * 4,
                                   n1 * n2 * w, popc_rate)
        if name.startswith("frame"):
            out["top2"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
        print(f"hamming: top2 {name}: {ms:.4f} ms (kernel) vs "
              f"{plain_ms:.4f} ms (plain); bound {bound_ms:.4f} ms "
              f"({bound_by}), device time | {smi}")
    out["top2"]["library_ms"] = None  # no one PyTorch call computes a top-2

    for name, (d1, d2), reps, plain_reps in (
            ("frame 512x512x16", frame[:2], 50, 50),
            (tables[0][0], tables[0][1:3], 10, 2),
            (tables[1][0], tables[1][1:3], 5, 1)):
        ms = _time_calls(hamming.hamming_distance, [(d1, d2)], reps)
        first_ms = _time_calls(lambda a, b: bench_designs.table_design(0, a, b),
                               [(d1, d2)], reps)
        plain_ms = _time_calls(hamming.hamming_distance_reference, [(d1, d2)],
                               plain_reps)
        lib_ms, lib_same = _table_library(d1, d2, plain_reps)
        # bytes: both banks read once, the int32 table written once;
        # operations: an AND and an add per bit pair, at the .b1 rate
        # measured above (the first kernel's: one XOR + popcount per word
        # pair at the popcount issue rate)
        n1, w = d1.shape
        n2 = d2.shape[0]
        bytes_ms, _ = bound((n1 + n2) * w * 4 + n1 * n2 * 4)
        ops_ms = 2 * n1 * n2 * 32 * w / b1_rate * 1e3
        popc_ms = n1 * n2 * w / popc_rate * 1e3
        bound_ms, bound_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                              else (ops_ms, "operations"))
        if name.startswith("frame"):
            out["table"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=lib_ms)
        lib = ("none" if lib_ms is None else
               f"{lib_ms:.4f} ms (torch.cdist(p=0) on 0/1 f32 bits, equal to "
               f"the plain table: {lib_same})")
        print(f"hamming: table {name}: {ms:.4f} ms (kernel) vs {first_ms:.4f} "
              f"ms (first kernel, CUDA cores) vs {plain_ms:.4f} ms (plain) vs "
              f"{lib} (library); bounds {bytes_ms:.6f} ms (bytes), "
              f"{ops_ms:.6f} ms (bit operations at the .b1 rate), "
              f"{popc_ms:.6f} ms (word operations at the popcount rate); "
              f"{n1 * n2 * 4 / ms / 1e9:.3f} TB/s of table written; device "
              f"time | {smi}")
    return out


def _top2(plain):
    """Route the matcher's top-2 to the kernel or to the plain version."""
    return mock.patch.object(
        hamming, "hamming_top2",
        hamming.hamming_top2_reference if plain else hamming.hamming_top2,
    )


def _table(plain):
    """Route the matcher's distance table to the kernel or the plain one."""
    return mock.patch.object(
        hamming, "hamming_distance",
        hamming.hamming_distance_reference if plain else hamming.hamming_distance,
    )


def phase_pair(dev, smi):
    img1, img2 = (torch.as_tensor(a, device=dev)
                  for a in bench_frontend.pair_images(0))
    fast_p = FASTParams(num_features=512)

    def pair(mp):
        gen = torch.Generator(device=dev).manual_seed(0)
        xy1, _, m1 = detect_fast(img1, fast_p)
        xy2, _, m2 = detect_fast(img2, fast_p)
        d1, _ = brisk_describe(img1, xy1, m1)
        d2, _ = brisk_describe(img2, xy2, m2)
        _, valid, diag = matcher.match_descriptors(
            d1, d2, xy1, xy2, m1, m2, gen, mp)
        return diag["num_good_matches"], valid

    knn = matcher.MatcherParams()
    reps = 20
    rates, good = {}, {}
    for which in ("kernel", "plain"):
        with _top2(which == "plain"):
            hamming.hamming_top2.launches = 0
            dt, (n_good, valid) = bench_frontend.time_call(pair, knn, reps=reps)
            launches = hamming.hamming_top2.launches
        want = reps + 1 if which == "kernel" else 0
        check(launches == want, f"pair ({which} top-2): {launches} top-2 "
              f"kernel launches in {reps + 1} pairs, expected {want}")
        rates[which], good[which] = 1.0 / dt, (int(n_good), valid.cpu())
    check(good["kernel"][0] >= 50 and torch.equal(good["kernel"][1],
                                                   good["plain"][1]),
          f"pair: {good['kernel'][0]} good matches with the kernel, "
          f"{good['plain'][0]} with the plain top-2")
    for which, note in (("kernel", ", one top-2 launch per pair"),
                        ("plain", "")):
        print(f"pair: 480x640 blob pair, FAST-512 + BRISK + knn ratio + "
              f"RANSAC: {good[which][0]} good matches, {rates[which]:.3f} "
              f"pairs/s with the {which} top-2{note} | {smi}")

    heur = matcher.MatcherParams(use_knn=False, cross_check=True)
    hamming.hamming_distance.launches = 0
    n_good, valid = pair(heur)
    table_launches = hamming.hamming_distance.launches
    check(table_launches == 1,
          f"pair (distance heuristic): {table_launches} table launches")
    with _table(plain=True):
        n_plain, valid_plain = pair(heur)
    check(hamming.hamming_distance.launches == 1
          and torch.equal(valid, valid_plain),
          "pair (distance heuristic): kernel and plain table disagree")
    print(f"pair: the same pair through the distance heuristic with cross "
          f"check: 1 table kernel launch, {int(n_good)} good matches, the "
          f"same as with the plain table")
    return table_launches


def _track(frames, dev, plain):
    gen = torch.Generator(device=dev).manual_seed(0)
    with _top2(plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks = visual_frontend.track_sequence(
            frames, params=visual_frontend.FrontendParams(), generator=gen,
            device=dev)
        dt = time.perf_counter() - t0  # the tracks are on the host
    return tracks, dt


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _frame_layers(frames, dev, smi):
    """ms per frame of each layer of one tracker step (frame 1 after frame
    0), CUDA-synchronized host clock, median of 20."""
    params = visual_frontend.FrontendParams()
    tp = params.tracker
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tracker_init(tp, visual_frontend._desc_words(params), device=dev)
    img0 = torch.as_tensor(frames[0], device=dev)
    img1 = torch.as_tensor(frames[1], device=dev)
    state = visual_frontend._frontend_step(state, img0, 0.0, gen, params)
    img = img1.to(torch.float32)
    xy, _, m = detect_fast(img, params.fast)
    desc, m = brisk_describe(img, xy, m, params.brisk)
    best, second, idx2 = hamming.hamming_top2(state.prev_desc, desc, m)
    valid = (best.float() <= tp.matcher.ratio_threshold * second.float()) & \
        (best < hamming.BIG) & state.prev_mask
    p2 = xy[idx2.long()]
    layers = {
        "detect": lambda: detect_fast(img, params.fast),
        "describe": lambda: brisk_describe(img, xy, m, params.brisk),
        "top-2 match": lambda: hamming.hamming_top2(state.prev_desc, desc, m),
        "RANSAC": lambda: matcher.find_fundamental_ransac(
            state.prev_xy, p2, valid, gen),
        "tracker update (match + RANSAC + ids + buffer)":
            lambda: add_image_features(state, xy, desc, m, 1.0, gen, tp),
        "whole frame step": lambda: visual_frontend._frontend_step(
            state, img1, 1.0, gen, params),
    }
    parts = [f"{k} {_median_ms(fn):.3f}" for k, fn in layers.items()]
    print(f"sequence: ms per 752x480 frame by layer: {'; '.join(parts)} | "
          f"{smi}")
    return state, img1


def _sync_sites(state, img, dev):
    """Synchronizing calls that PyTorch's sync debug mode sees in one frame
    step, as {file name:line: count}."""
    params = visual_frontend.FrontendParams()
    gen = torch.Generator(device=dev).manual_seed(1)
    _, syncs = _sync_free(lambda: visual_frontend._frontend_step(
        state, img, 1.0, gen, params))
    sites = collections.Counter()
    for k, v in syncs.items():
        sites[Path(k).name] += v
    return sites


def phase_sequence(frames, dev, smi):
    hamming.hamming_top2.launches = 0
    tracks, _ = _track(frames, dev, plain=False)
    launches = hamming.hamming_top2.launches
    check(launches == SEQUENCE_FRAMES,
          f"sequence: {launches} top-2 launches in {SEQUENCE_FRAMES} frames")
    tracks_p, _ = _track(frames, dev, plain=True)
    check(hamming.hamming_top2.launches == launches,
          "sequence: the plain run launched the top-2 kernel")
    check(np.array_equal(tracks, tracks_p),
          f"sequence: tracks with the kernel ({len(tracks)} rows) and with "
          f"the plain top-2 ({len(tracks_p)} rows) differ")
    check(np.isfinite(tracks).all(), "sequence: non-finite track rows")
    ids = np.unique(tracks[:, 1])
    lengths = np.bincount(tracks[:, 1].astype(int))
    lengths = lengths[lengths > 0]
    longest = tracks[tracks[:, 1] == ids[np.argmax(lengths)]]
    check((np.diff(np.sort(longest[:, 0].astype(int))) == 1).all(),
          "sequence: the longest track skips frames")
    check(lengths.mean() >= 3.0,
          f"sequence: mean track length {lengths.mean():.3f} < 3")
    for what, got, ref in (("track rows", len(tracks), JAX_TRACK_ROWS),
                           ("landmark ids", len(ids), JAX_TRACK_IDS)):
        check(abs(got - ref) <= 0.1 * max(got, ref),
              f"sequence: {got} {what} against the JAX package's {ref}")
    print(f"sequence: {SEQUENCE_FRAMES} frames 752x480, FrontendParams(): "
          f"{launches} top-2 kernel launches, tracks identical to the plain "
          f"top-2 run: {len(tracks)} track rows (JAX {JAX_TRACK_ROWS}), "
          f"{len(ids)} ids (JAX {JAX_TRACK_IDS}), mean length "
          f"{lengths.mean():.3f}, longest {lengths.max()} contiguous frames")
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        _, dt = _track(frames, dev, plain=which == "plain")
        rates[which].append(SEQUENCE_FRAMES / dt)
    for which in ("kernel", "plain"):
        r = rates[which]
        print(f"sequence: {np.mean(r):.3f} frames/s with the {which} top-2 "
              f"(runs {r[0]:.3f}, {r[1]:.3f}), whole track_sequence incl. "
              f"upload and track export | {smi}")
    state, img = _frame_layers(frames, dev, smi)
    sites = _sync_sites(state, img, dev)
    src = Path(inspect.getsourcefile(matcher))
    allowed = {f"{src.name}:{i}" for i, line in
               enumerate(src.read_text().splitlines(), 1)
               if "torch.linalg." in line}
    listed = ", ".join(f"{k} x{v}" for k, v in sorted(sites.items())) or "none"
    print(f"sequence: synchronizing calls in one frame step: {listed}")
    stray = sorted(set(sites) - allowed)
    check(not stray, f"sequence: synchronizing calls outside RANSAC's "
          f"torch.linalg calls: {stray}")
    return launches


def _kernel_entry(name, source, replaces, n_launches, stats):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches}
    entry.update({k: stats[k] for k in keys})
    return entry


def main():
    t_start = time.perf_counter()
    name, smi, popc_rate = phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    problem, state = bench_problem.make_problem(device=dev)
    print(f"problem: headline problem (200 poses, 10,000 landmarks, 300 "
          f"observations per pose, {len(problem.bands.entries)} band "
          f"entries) built in {time.perf_counter() - t0:.3f} s")
    cfg = bench_problem.bench_config(LM_ITERS)
    g_a = phase_kernel(problem, state, cfg)
    ga_launches = phase_headline(problem, state, cfg, smi)
    phase_small_reference(dev)
    seg = phase_seg(problem, dev, smi)
    mf_counts = phase_matrix_free(problem, state, smi)
    del problem, state
    phase_vio(dev, smi)
    phase_euroc(dev, smi)
    phase_windowed(dev, smi)
    phase_mh01_scale(dev, smi)
    phase_windowed_ba(dev, smi)
    t0 = time.perf_counter()
    frames = bench_frontend.make_euroc_frames()
    check(frames.shape == (SEQUENCE_FRAMES, 480, 752),
          f"EuRoC frames have shape {frames.shape}")
    print(f"frames: {SEQUENCE_FRAMES} EuRoC cam0 frames (752x480, 400 "
          f"landmarks, seed 0) rendered in {time.perf_counter() - t0:.3f} s")
    ham = phase_hamming(frames, dev, smi, popc_rate)
    table_launches = phase_pair(dev, smi)
    top2_launches = phase_sequence(frames, dev, smi)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        _kernel_entry("segmm_g_a", KERNEL_SOURCE, KERNEL_REPLACES,
                      ga_launches, g_a),
        _kernel_entry("seg_reduce", SEG_SOURCE, REDUCE_REPLACES,
                      mf_counts["seg_reduce"], seg["seg_reduce"]),
        _kernel_entry("seg_broadcast", SEG_SOURCE, BROADCAST_REPLACES,
                      mf_counts["seg_broadcast"], seg["seg_broadcast"]),
        _kernel_entry("hamming_top2", HAMMING_SOURCE, TOP2_REPLACES,
                      top2_launches, ham["top2"]),
        _kernel_entry("hamming_table", HAMMING_SOURCE, TABLE_REPLACES,
                      table_launches, ham["table"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))

if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
