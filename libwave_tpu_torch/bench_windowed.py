"""Run the windowed VIO solver's two full-length phases on the card.

    python3 libwave_tpu_torch/bench_windowed.py [long] [mh01] [mh01_f64]
        [witness] [profile]

(``long`` and ``mh01`` without arguments) writes each sequence with the
port's own ASL writer, its IMU noise drawn from a CPU ``torch.Generator``
(so a machine without a card writes the same directory), solves it with
``pipelines.windowed_vio.run_euroc_vio_windowed`` on the card in f32, and
prints ``bench.py``'s keys for the phase as one JSON line:

- ``long``: ``bench.py``'s ``bench_euroc_long``: 130 s at a 5 Hz camera,
  600 landmarks, seed 0 (651 keyframes), ``WindowedVIOParams(window=80,
  overlap=10, mode="marginalize", passes=2)`` and the freeze ablation;
- ``mh01``: ``bench.py``'s ``bench_euroc_mh01_scale``: 182 s at a 20 Hz
  camera and 200 Hz IMU, 900 landmarks, seed 0 (3,641 keyframes),
  ``WindowedVIOParams(window=120, overlap=12, mode="marginalize",
  passes=1)``, where the stiffness gate widens the Hessian to f64.

Each line also carries the sha256 of the sequence's ``imu0/data.csv`` and
``cam0/tracks.csv``, the number of device complements that fell back to
the host, the LM iterations, and each run's wall split into solve,
marginalization and the rest (the host loop: initialization,
triangulation, packing, transfers). ``mh01_f64`` (not run by default)
is ``mh01`` with an f64 state (the G/A build stays f32, the kernel's
contract). ``witness`` (not run by default) runs MH_01's first 6 windows
four ways, f32 with the kernels twice, f32 through the plain versions and
f64, and prints each run's window costs and LM iterations: where the
card's chain parts from the CPU's, and whether the kernels move it.
``profile`` (not run by default)
traces the first two windows of ``long`` with ``torch.profiler`` after a
warm-up and one unprofiled run of them, and prints the card's busy share, the kernel count
and the kernels that take the most device time. The first line names the
card and its power limit as ``nvidia-smi`` reports them. Needs a CUDA
device and ``nvcc``. ``chip_smoke.py``'s windowed phases take their
configurations and the sequence writer from here.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    # run as a script: import the package from the checkout this file is in
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from libwave_tpu_torch.pipelines.euroc_vio import EurocVIOParams  # noqa: E402
from libwave_tpu_torch.pipelines.windowed_vio import (  # noqa: E402
    WindowedVIOParams,
    run_euroc_vio_windowed,
)
from libwave_tpu_torch.sim.euroc_sim import (  # noqa: E402
    EurocSimParams,
    generate_euroc_sequence,
)

SEED = 0
# bench.py's bench_euroc_long, in full: 651 keyframes, and its freeze
# ablation
LONG_SIM = EurocSimParams(duration=130.0, cam_hz=5.0, nb_landmarks=600)
LONG_WINDOWS = WindowedVIOParams(window=80, overlap=10, mode="marginalize",
                                 passes=2)
LONG_FREEZE = WindowedVIOParams(window=80, overlap=10, mode="freeze")
# bench.py's bench_euroc_mh01_scale, in full: 3,641 keyframes
MH01_SIM = EurocSimParams(duration=182.0, cam_hz=20.0, imu_hz=200.0,
                          nb_landmarks=900)
MH01_WINDOWS = WindowedVIOParams(window=120, overlap=12, mode="marginalize",
                                 passes=1)


def write_sequence(root, sim):
    """Write ``sim`` (seed ``SEED``, IMU noise from a CPU generator); its
    seconds and the sha256 of ``imu0/data.csv`` and ``cam0/tracks.csv``."""
    t0 = time.perf_counter()
    generate_euroc_sequence(root, sim, seed=SEED, device="cpu")
    seconds = time.perf_counter() - t0
    return seconds, {
        name: hashlib.sha256(Path(root, "mav0", name).read_bytes()).hexdigest()
        for name in ("imu0/data.csv", "cam0/tracks.csv")
    }


def _timed(root, wparams, **kw):
    """``run_euroc_vio_windowed`` on the card; its report with the run's
    wall and the host loop's share of it."""
    t0 = time.perf_counter()
    _, rep = run_euroc_vio_windowed(root, EurocVIOParams(), wparams, **kw)
    rep["wall_s"] = time.perf_counter() - t0
    rep["host_s"] = (rep["wall_s"] - rep["solve_seconds"]
                     - rep["marginalization_seconds"])
    return rep


def _split(prefix, rep):
    return {
        f"{prefix}_wall_s": rep["wall_s"],
        f"{prefix}_solve_wall_s": rep["solve_seconds"],
        f"{prefix}_host_s": rep["host_s"],
        f"{prefix}_lm_iterations": sum(rep["window_iterations"]),
        f"{prefix}_ms_per_lm_iteration": 1e3 * rep["solve_seconds"] / max(
            sum(rep["window_iterations"]), 1),
        f"{prefix}_marg_host_fallbacks": rep["marg_host_fallbacks"],
        f"{prefix}_window_iterations": rep["window_iterations"],
        f"{prefix}_window_final_costs": rep["window_final_costs"],
    }


def bench_long(root):
    t_gen, hashes = write_sequence(root, LONG_SIM)
    rep = _timed(root, LONG_WINDOWS)
    rep_f = _timed(root, LONG_FREEZE)
    return {
        "euroc_long_keyframes": rep["num_keyframes"],
        "euroc_long_windows": rep["num_windows"],
        "euroc_long_passes": rep["passes"],
        "euroc_long_ate_rmse_m": rep["ate_rmse"],
        "euroc_long_rpe_trans_rmse_m": rep["rpe_trans_rmse"],
        "euroc_long_solve_keyframes_per_s": rep["solve_keyframes_per_s"],
        "euroc_long_sequence_keyframes_per_s":
            rep["sequence_keyframes_per_s"],
        "euroc_long_marginalization_s": rep["marginalization_seconds"],
        "euroc_long_ate_rmse_m_freeze_ablation": rep_f["ate_rmse"],
        "euroc_long_freeze_solve_keyframes_per_s":
            rep_f["solve_keyframes_per_s"],
        **_split("euroc_long", rep),
        **_split("euroc_long_freeze", rep_f),
        "euroc_long_generation_s": t_gen,
        "euroc_long_sha256": hashes,
    }


def bench_mh01(root, dtype="float32"):
    import torch

    t_gen, hashes = write_sequence(root, MH01_SIM)
    rep = _timed(root, MH01_WINDOWS, dtype=getattr(torch, dtype))
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return {
        "euroc_mh01_scale_dtype": dtype,
        "euroc_mh01_scale_hessian_dtype": rep["hessian_dtype"],
        "euroc_mh01_scale_passes": rep["passes"],
        "euroc_mh01_scale_keyframes": rep["num_keyframes"],
        "euroc_mh01_scale_duration_s": MH01_SIM.duration,
        "euroc_mh01_scale_windows": rep["num_windows"],
        "euroc_mh01_scale_ate_rmse_m": rep["ate_rmse"],
        "euroc_mh01_scale_rpe_trans_rmse_m": rep["rpe_trans_rmse"],
        "euroc_mh01_scale_solve_keyframes_per_s":
            rep["solve_keyframes_per_s"],
        "euroc_mh01_scale_sequence_keyframes_per_s":
            rep["sequence_keyframes_per_s"],
        "euroc_mh01_scale_marginalization_s": rep["marginalization_seconds"],
        "euroc_mh01_scale_generation_s": t_gen,
        "euroc_mh01_scale_peak_host_rss_gb": peak_rss_gb,
        **_split("euroc_mh01_scale", rep),
        "euroc_mh01_scale_sha256": hashes,
    }


@contextlib.contextmanager
def plain_versions():
    """Route the solves' G/A build and segment crossings to their plain
    PyTorch versions, on the card too."""
    from unittest import mock

    from libwave_tpu_torch.ops import segmm
    from libwave_tpu_torch.optim import schur

    with mock.patch.object(schur, "dense_g_a_window",
                           segmm.dense_g_a_window_reference), \
            mock.patch.multiple(
                segmm, seg_reduce_sorted=segmm.seg_reduce_sorted_reference,
                seg_broadcast=segmm.seg_broadcast_reference):
        yield


def bench_witness(root, windows=6):
    import torch

    _, hashes = write_sequence(root, MH01_SIM)
    out = {"witness_windows": windows, "witness_sha256": hashes}
    for name, dtype, plain in (("f32", torch.float32, False),
                               ("f32_again", torch.float32, False),
                               ("f32_plain", torch.float32, True),
                               ("f64", torch.float64, False)):
        with plain_versions() if plain else contextlib.nullcontext():
            rep = _timed(root, MH01_WINDOWS, dtype=dtype,
                         stop_after_windows=windows)
        out[f"witness_{name}_window_final_costs"] = rep["window_final_costs"]
        out[f"witness_{name}_window_iterations"] = rep["window_iterations"]
        out[f"witness_{name}_wall_s"] = rep["wall_s"]
    return out


def bench_profile(root, top=12):
    import torch
    from torch.profiler import ProfilerActivity, profile

    write_sequence(root, LONG_SIM)
    wp = LONG_WINDOWS
    _timed(root, wp, stop_after_windows=1)  # builds and loads the kernels
    rep = _timed(root, wp, stop_after_windows=2)  # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _timed(root, wp, stop_after_windows=2)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    iters = sum(rep["window_iterations"])
    return {
        "profile_windows": 2,
        "profile_lm_iterations": iters,
        "profile_wall_s_unprofiled": rep["wall_s"],
        "profile_solve_s_unprofiled": rep["solve_seconds"],
        "profile_marginalization_s_unprofiled":
            rep["marginalization_seconds"],
        "profile_host_s_unprofiled": rep["host_s"],
        "profile_device_ms": device_us / 1e3,
        "profile_busy_share_of_unprofiled_wall":
            device_us / 1e6 / rep["wall_s"],
        "profile_kernels": sum(e.count for e in kernels),
        "profile_kernels_per_lm_iteration":
            sum(e.count for e in kernels) / max(iters, 1),
        "profile_top": [(e.key[:80], e.count,
                         e.self_device_time_total / 1e3)
                        for e in kernels[:top]],
    }


PHASES = {"long": bench_long, "mh01": bench_mh01,
          "mh01_f64": functools.partial(bench_mh01, dtype="float64"),
          "witness": bench_witness, "profile": bench_profile}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_windowed: no CUDA device: this script runs only on "
                 "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    for name in argv or ["long", "mh01"]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"euroc_{name}_") as root:
            out = PHASES[name](root)
        out["phase_seconds"] = time.perf_counter() - t0
        out["device"] = smi
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
