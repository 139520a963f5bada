"""The CPU witnesses of the windowed phases on the card.

    JAX_PLATFORMS=cpu python tests/windowed_anchors.py SEQ RUN [RUN ...]

writes one of the sequences of ``chip_smoke.py`` and
``libwave_tpu_torch/bench_windowed.py`` with the port's writer on a CPU
``torch.Generator`` (the directory the card writes too), prints the sha256
of its ``imu0/data.csv`` and ``cam0/tracks.csv``, runs
``run_euroc_vio_windowed`` on it and prints each run's ATE, RPE, window
costs and seconds as one JSON line.

SEQ: ``long`` (euroc_long: the 2-pass run and the freeze ablation),
``mh01_36`` (MH_01 cut to 36 s, as ``chip_smoke.py`` runs it) or ``mh01``
(MH_01 in full, 3,641 keyframes).

RUN: ``jax32`` (the JAX package as ``bench.py`` runs it: x64 off, its
explicit f64 allowed), ``jax64`` (x64 on), ``port32`` or ``port64`` (the
port on the CPU, 4 torch threads: an f32 chain's last bits depend on the
thread count), ``port32dev`` (``port32`` with the Schur complement the
card takes, ``vio_marginalize_device``, instead of the host's).

The JAX package's ATE on these directories anchors ``chip_smoke.py``'s
gates (``JAX_WINDOWED_ATE``, ``JAX_MH01_ATE``). Not a test (pytest does
not collect it): a run takes minutes (``long``, ``mh01_36``) to an hour
(``mh01`` at f64).
"""

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    # run as a script: import both packages from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import torch  # noqa: E402

from libwave_tpu.pipelines import euroc_vio as jeuroc  # noqa: E402
from libwave_tpu.pipelines import windowed_vio as jw  # noqa: E402
from libwave_tpu_torch import bench_windowed as bw  # noqa: E402
from libwave_tpu_torch.pipelines import euroc_vio as teuroc  # noqa: E402
from libwave_tpu_torch.pipelines import windowed_vio as tw  # noqa: E402

SEQUENCES = {
    "long": (bw.LONG_SIM, {"marginalize_2pass": bw.LONG_WINDOWS,
                           "freeze": bw.LONG_FREEZE}),
    "mh01_36": (dataclasses.replace(bw.MH01_SIM, duration=36.0),
                {"marginalize": bw.MH01_WINDOWS}),
    "mh01": (bw.MH01_SIM, {"marginalize": bw.MH01_WINDOWS}),
}


def _run(root, run, wp):
    if run.startswith("jax"):
        with jax.enable_x64(run == "jax64"):
            _, rep = jw.run_euroc_vio_windowed(
                root, jeuroc.EurocVIOParams(),
                jw.WindowedVIOParams(**dataclasses.asdict(wp)))
        return rep
    torch.set_num_threads(4)
    if run == "port32dev":
        wp = dataclasses.replace(wp, marg_device=True)
    _, rep = tw.run_euroc_vio_windowed(
        root, teuroc.EurocVIOParams(), wp, device="cpu",
        dtype=torch.float64 if run == "port64" else torch.float32)
    return rep


def main(seq, runs):
    sim, configs = SEQUENCES[seq]
    with tempfile.TemporaryDirectory(prefix=f"anchors_{seq}_") as root:
        _, hashes = bw.write_sequence(root, sim)
        print(json.dumps({"sequence": seq, "sha256": hashes}), flush=True)
        for run in runs:
            for name, wp in configs.items():
                t0 = time.perf_counter()
                rep = _run(root, run, wp)
                print(json.dumps({
                    "sequence": seq, "run": run, "config": name,
                    "seconds": time.perf_counter() - t0,
                    **{k: rep[k] for k in (
                        "ate_rmse", "rpe_trans_rmse", "num_keyframes",
                        "num_windows", "hessian_dtype",
                        "window_final_costs")},
                }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
