"""Which piece of the f32 windowed VIO chain parts MH_01 from the f64 one.

    python3 tests/witness_parts.py [WINDOWS]

runs on the card (it exits when there is none). It writes MH_01 as
``libwave_tpu_torch/bench_windowed.py`` does and runs its first WINDOWS
(default 4) windows five ways: f32; f32 with one piece moved to f64 (the
IMU preintegration, the linearization, the cost: :func:`f64_part`); and
f64. It prints one JSON line: each run's window costs, LM iterations and
wall, and each f32 run's relative departure from the f64 run's costs,
window by window, with the card's name and power limit.

The f64 pieces are put in by patching the port's private functions
(``windowed_vio._preintegrate_intervals``, ``vio._linearize_vio``,
``vio.vio_cost``): a probe, not a test (pytest does not collect it), to be
brought up to date when those functions change.
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

if __name__ == "__main__":
    # run as a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from libwave_tpu_torch.bench_windowed import (  # noqa: E402
    MH01_SIM,
    MH01_WINDOWS,
    _timed,
    write_sequence,
)
from libwave_tpu_torch.pipelines import vio, windowed_vio  # noqa: E402


def _cast(x, dtype):
    """Every floating tensor of ``x`` (a tensor, or NamedTuples of them,
    nested) in ``dtype``; everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cast(v, dtype) for v in x))
    return x


@contextlib.contextmanager
def f64_part(part):
    """Run one piece of the f32 windowed chain in f64, its results rounded
    back to the dtypes the f32 chain gives them: ``"preintegration"``
    (every keyframe interval's preintegration and its information),
    ``"linearization"`` (``vio._linearize_vio``: residuals, Jacobians and
    normal-equation blocks, also the complement's), or ``"cost"``
    (``vio.vio_cost``: residuals and every sum, the LM accept test's)."""
    f64 = torch.float64
    if part == "preintegration":
        orig = windowed_vio._preintegrate_intervals

        def wide(imu, cam_times, N, params, device, dtype=torch.float32):
            pim, sqrt_infos = orig(imu, cam_times, N, params, device, f64)
            return _cast(pim, dtype), sqrt_infos.to(dtype)

        target = (windowed_vio, "_preintegrate_intervals", wide)
    elif part == "linearization":
        orig = vio._linearize_vio

        def wide(problem, state, lam, *args, **kw):
            like = orig(problem, state, lam, *args, **kw)
            got = orig(_cast(problem, f64), _cast(state, f64), lam, *args,
                       **kw)
            return type(like)(*(
                g.to(r.dtype) if isinstance(g, torch.Tensor)
                and g.is_floating_point() else r
                for g, r in zip(got, like)))

        target = (vio, "_linearize_vio", wide)
    elif part == "cost":
        orig = vio.vio_cost

        def wide(problem, state, *args, **kw):
            return orig(_cast(problem, f64), _cast(state, f64), *args, **kw)

        target = (vio, "vio_cost", wide)
    else:
        raise ValueError(f"unknown part {part!r}")
    with mock.patch.object(*target):
        yield


def witness_parts(root, windows=4):
    """MH_01's first ``windows`` windows the five ways the module says."""
    _, hashes = write_sequence(root, MH01_SIM)
    out = {"witness_parts_windows": windows, "witness_parts_sha256": hashes}
    runs = {}
    for name, dtype, part in (("f32", torch.float32, None),
                              ("f32_preintegration_f64", torch.float32,
                               "preintegration"),
                              ("f32_linearization_f64", torch.float32,
                               "linearization"),
                              ("f32_cost_f64", torch.float32, "cost"),
                              ("f64", torch.float64, None)):
        with f64_part(part) if part else contextlib.nullcontext():
            rep = _timed(root, MH01_WINDOWS, dtype=dtype,
                         stop_after_windows=windows)
        runs[name] = rep["window_final_costs"]
        out[f"witness_{name}_window_final_costs"] = rep["window_final_costs"]
        out[f"witness_{name}_window_iterations"] = rep["window_iterations"]
        out[f"witness_{name}_wall_s"] = rep["wall_s"]
    for name, costs in runs.items():
        if name != "f64":
            out[f"witness_{name}_departure_from_f64"] = [
                abs(a / b - 1) for a, b in zip(costs, runs["f64"])]
    return out


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("witness_parts: no CUDA device: this script runs only on "
                 "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="euroc_witness_parts_") as root:
        out = witness_parts(root, int(argv[0]) if argv else 4)
    out["seconds"] = time.perf_counter() - t0
    out["device"] = smi
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
