#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's bundle-adjustment back end once on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and ``nvcc`` (found through ``CUDA_HOME`` or ``PATH``);
it imports no JAX. Phases, each reported on its own line:

1. device: the card's name and power limit (from ``nvidia-smi``), the
   torch and CUDA versions; no CUDA device is a failure, never a CPU run;
2. build: compiles ``libwave_tpu_torch/csrc/segmm_g_a.cu`` for sm_90a and
   loads it;
3. kernel: the G/A kernel against its plain PyTorch version on the card, at
   each band call of the headline problem's first linearization and on edge
   cases (duplicate ids, ids -1 and >= M, Pmax = 37, M = 1000), within
   1e-6 * max|plain| (both sum the same f32 terms, only the order may
   differ); then both timed with CUDA events at the headline shapes;
4. headline: ``solve_ba`` on the full headline problem (200 poses, 10,000
   landmarks, 300 observations per pose, f32, bands) with the benchmark's
   configuration. It must take the explicit-S path with exactly 13 kernel
   launches per LM iteration, run with TF32 off and without a synchronizing
   CUDA call that PyTorch's sync debug mode detects, give finite costs that
   end below the initial cost, and follow the trajectory of the same solve
   with the plain G/A forced on the card (rtol 1e-3). Then LM iterations/s for
   both, and a small f64 problem solved on the card against the CPU.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import libwave_tpu_torch
from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.optim import ba, schur
from libwave_tpu_torch.utils import precision

HERE = Path(__file__).resolve().parent
KERNEL_SOURCE = "libwave_tpu_torch/csrc/segmm_g_a.cu"
KERNEL_REPLACES = "libwave_tpu/ops/segmm.py:190"
LM_ITERS = 10
BAND_CALLS = 13  # band plan entries x pose runs of the headline problem
REL_TOL = 1e-6


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
    print(f"device: {name} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    print(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    log = segmm.build()
    dt = time.perf_counter() - t0
    print(f"build: {KERNEL_SOURCE} built for sm_90a and loaded in {dt:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas: {line.strip()}")


def _compare(case, G, A, Gr, Ar, worst):
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


def _edge_cases(dev):
    """(name, W, lm_slot, hinv) inputs the headline problem does not make."""
    rng = np.random.default_rng(1)
    cases = []
    for N, P, M in ((5, 37, 1000), (3, 300, 1000), (2, 600, 77)):
        W = rng.standard_normal((18, N, P)).astype(np.float32)
        ids = rng.integers(-1, M + 3, (N, P)).astype(np.int32)
        ids[:, : P // 4] = ids[:, :1]  # duplicates of the first slot's id
        ids[0, :3] = -1
        ids[-1, -3:] = M
        ids[min(1, N - 1)] = -1  # a pose row with every id out of range
        hinv = rng.standard_normal((6, M)).astype(np.float32)
        cases.append((f"N={N} Pmax={P} M={M}", W, ids, hinv))
    return [
        (name, *(torch.as_tensor(a, device=dev) for a in arrays))
        for name, *arrays in cases
    ]


def _time_calls(fn, operands, reps=20):
    """ms per pass over ``operands``, CUDA events around ``reps`` passes."""
    for _ in range(3):
        for ops in operands:
            fn(*ops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        for ops in operands:
            fn(*ops)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    operands = [schur.g_a_operands(blocks, *c) for c in calls]
    worst = {"abs": 0.0, "rel": 0.0}
    for (c0, c1, plo, phi), ops in zip(calls, operands):
        G, A = segmm.dense_g_a(*ops)
        Gr, Ar = segmm.dense_g_a_reference(*ops)
        torch.cuda.synchronize()
        _compare(f"band cols [{c0},{c1}) poses [{plo},{phi})", G, A, Gr, Ar,
                 worst)
    cells = sum((phi - plo) * (c1 - c0) for (c0, c1, plo, phi) in calls)
    print(f"kernel: {len(calls)} headline band calls ({cells} pose x column "
          f"cells) match the plain G/A: max abs err {worst['abs']:.3e}, max "
          f"rel err {worst['rel']:.3e}")
    for name, W, ids, hinv in _edge_cases(state.p.device):
        G, A = segmm.dense_g_a(W, ids, hinv)
        Gr, Ar = segmm.dense_g_a_reference(W, ids, hinv)
        torch.cuda.synchronize()
        _compare(f"edge case {name}", G, A, Gr, Ar, worst)
    print(f"kernel: edge cases (duplicates, ids -1 and >= M, Pmax=37, "
          f"M=1000) match: overall max abs err {worst['abs']:.3e}, max rel "
          f"err {worst['rel']:.3e} (limit {REL_TOL:g} * max|plain|)")
    ms = _time_calls(segmm.dense_g_a, operands)
    plain_ms = _time_calls(segmm.dense_g_a_reference, operands)
    out_mb = 2 * 4 * 18 * cells / 1e6
    print(f"kernel: one LM iteration's {len(calls)} G/A calls take {ms:.4f} "
          f"ms (kernel) vs {plain_ms:.4f} ms (plain); {out_mb:.1f} MB of G "
          f"and A written, {out_mb / ms / 1e3:.3f} TB/s (kernel)")
    return worst, ms, plain_ms


def _g_a(plain):
    """Route the solve's G/A build to the kernel or to the plain version."""
    return mock.patch.object(
        schur, "dense_g_a",
        segmm.dense_g_a_reference if plain else segmm.dense_g_a,
    )


def _solve(problem, state, cfg, plain=False):
    with _g_a(plain):
        out, info = ba.solve_ba(problem, state, cfg)
    torch.cuda.synchronize()
    return out, info


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
            segmm.dense_g_a.launches = 0
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, info = ba.solve_ba(problem, state, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches = segmm.dense_g_a.launches
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
    check(launches == BAND_CALLS * LM_ITERS,
          f"{launches} G/A kernel launches in {LM_ITERS} LM iterations, "
          f"expected {BAND_CALLS * LM_ITERS}")
    check(len(tf32_seen) == LM_ITERS and not any(tf32_seen),
          f"TF32 was on inside solve_ba ({tf32_seen})")
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all(),
          f"non-finite costs: {c0}, {costs}")
    check(costs[-1] < c0, f"final cost {costs[-1]} not below initial {c0}")
    print(f"headline: explicit-S path, {launches} G/A kernel launches in "
          f"{LM_ITERS} LM iterations, TF32 off, no synchronizing call "
          f"detected inside solve_ba; cost {c0:.6e} -> "
          f"{costs[-1]:.6e}, accepted "
          f"{int(info['accepted'].sum())}/{LM_ITERS}")
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
    return launches


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


def main():
    name, smi = phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    problem, state = bench_problem.make_problem(device=dev)
    print(f"problem: headline problem (200 poses, 10,000 landmarks, 300 "
          f"observations per pose, {len(problem.bands.entries)} band "
          f"entries) built in {time.perf_counter() - t0:.3f} s")
    cfg = bench_problem.bench_config(LM_ITERS)
    worst, ms, plain_ms = phase_kernel(problem, state, cfg)
    launches = phase_headline(problem, state, cfg, smi)
    phase_small_reference(dev)
    print(json.dumps({"kernels": [{
        "name": "segmm_g_a",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": worst["abs"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
