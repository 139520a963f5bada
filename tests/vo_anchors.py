"""The JAX package's two-frame VO figure on ``bench_frontend.vo_pair``'s
frames: the anchor of ``chip_smoke.py``'s vo_pair phase.

    JAX_PLATFORMS=cpu python tests/vo_anchors.py

renders frames 0 and 2 of ``bench.py``'s front-end sequence (752x480, 4.8 s
at 5 Hz, 400 landmarks, seed 0) with ``libwave_tpu_torch.bench_frontend``
(the frames the JAX package's simulator writes as PNGs), runs the JAX
package's ``two_frame_pose`` (``VOFrontendConfig()``, under ``jax.jit``, f32
with x64 off, as ``bench.py`` runs) with ``jax.random.key(s)`` for s = 0..7
on this machine's CPU, and prints one JSON line: the rotation error (rad)
against the simulator's true relative rotation for each key and their
median. RANSAC's draw decides which consensus set wins on a pair with a few
dozen matches, so the anchor is the median over keys.

Not collected by pytest (no ``test_`` prefix). About a minute on a CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libwave_tpu.pipelines import vo_frontend as jv  # noqa: E402
from libwave_tpu_torch import bench_frontend  # noqa: E402

KEYS = range(8)


def main():
    jax.config.update("jax_enable_x64", False)
    a, b, K, R_true = bench_frontend.vo_pair(bench_frontend.EUROC_FRONTEND,
                                             seed=0, i=0, j=2)
    run = jax.jit(jv.two_frame_pose, static_argnums=4)
    errs = [bench_frontend.rotation_error(
        np.asarray(run(jnp.asarray(a, jnp.float32),
                       jnp.asarray(b, jnp.float32),
                       jnp.asarray(K, jnp.float32), jax.random.key(s),
                       jv.VOFrontendConfig()).T_21.rotation()), R_true)
        for s in KEYS]
    print(json.dumps({"vo_pair_rotation_err_rad": errs,
                      "median": float(np.median(errs)),
                      "true_rotation_rad": bench_frontend.rotation_error(
                          np.eye(3), R_true)}))


if __name__ == "__main__":
    main()
