"""How far the pixels sequence's f32 VIO solve sits from its minimum.

    JAX_PLATFORMS=cpu python tests/pixels_f32_spread.py

writes ``chip_smoke.py``'s pixels sequence (376x240, 8 s, 41 frames, seed
0) with the port's writer, tracks it with the port's front end on the CPU
(generator seeded 0), and solves the one track bank with the default 25
LM iterations in the JAX package at f32 and at f64 and in the port at f32
on 1 and on 8 torch threads and at f64. It prints each solve's final
cost, ATE and the largest keyframe-position gap to the port's f64 solve,
as one JSON line: why ``chip_smoke.py`` holds the card's pixels solve to
the CPU's by cost and ATE, not by positions. Not a test (pytest does not
collect it); about a minute.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # run as a script: import both packages from this checkout
    sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

_JAX = """
import json, sys
import jax
jax.config.update("jax_enable_x64", sys.argv[2] == "64")
import numpy as np
from libwave_tpu.pipelines import euroc_vio
K = np.array(json.loads(sys.argv[3]))
tracks = np.load(sys.argv[4])
state, rep = euroc_vio.run_euroc_vio(sys.argv[1], euroc_vio.EurocVIOParams(),
                                     K=K, tracks=tracks)
np.save(sys.argv[5], np.asarray(state.p, np.float64))
print(json.dumps({"final_cost": float(rep["final_cost"]),
                  "ate_rmse": float(rep["ate_rmse"])}))
"""


def main():
    import chip_smoke
    from libwave_tpu_torch.datasets.euroc import load_euroc_camera_index
    from libwave_tpu_torch.pipelines import euroc_vio, vio, visual_frontend
    from libwave_tpu_torch.sim import euroc_sim
    from libwave_tpu_torch.vision import images

    p = chip_smoke.PIXELS_SIM
    K = np.array([[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1.0]])
    params = euroc_vio.EurocVIOParams()
    cfg = euroc_vio.default_vio_config(params)
    out, pos = {}, {}
    with tempfile.TemporaryDirectory(prefix="pixels_spread_") as root:
        euroc_sim.generate_euroc_sequence(root, p, seed=0, device="cpu")
        _, paths = load_euroc_camera_index(root)
        frames = images.read_image_sequence(paths)
        torch.set_num_threads(8)
        tracks = visual_frontend.track_sequence(
            frames, generator=torch.Generator().manual_seed(0), device="cpu")
        for name, threads, dtype in (("port_f32_1_thread", 1, torch.float32),
                                     ("port_f32_8_threads", 8, torch.float32),
                                     ("port_f64", 8, torch.float64)):
            torch.set_num_threads(threads)
            problem, init, gt, kf = euroc_vio.build_euroc_vio_problem(
                root, params, K, tracks=tracks, device="cpu", dtype=dtype)
            state, info = vio.solve_vio(problem, init, cfg)
            rep = euroc_vio.euroc_report(gt, kf, init, state, info)
            out[name] = {"final_cost": rep["final_cost"],
                         "ate_rmse": rep["ate_rmse"]}
            pos[name] = state.p.double().numpy()
        np.save(Path(root, "tracks.npy"), tracks)
        for bits in ("32", "64"):
            # one process each: x64 is set once, before JAX computes
            res = subprocess.run(
                [sys.executable, "-c", _JAX, root, bits,
                 json.dumps(K.tolist()), str(Path(root, "tracks.npy")),
                 str(Path(root, f"p{bits}.npy"))],
                capture_output=True, text=True, check=True, timeout=900,
                env={**os.environ, "PYTHONPATH": str(HERE),
                     "JAX_PLATFORMS": "cpu"})
            name = f"jax_f{bits}"
            out[name] = json.loads(res.stdout.strip().splitlines()[-1])
            pos[name] = np.load(Path(root, f"p{bits}.npy"))
    for name in out:
        out[name]["max_position_gap_to_port_f64_m"] = float(
            np.abs(pos[name] - pos["port_f64"]).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
