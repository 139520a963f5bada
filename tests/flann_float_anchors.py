"""The JAX package's float-FLANN recalls on ``bench_trajectory``'s planted
banks: the anchors of ``chip_smoke.py``'s float_flann phase.

    JAX_PLATFORMS=cpu python tests/flann_float_anchors.py

runs the JAX package's ``build_float_index`` and ``float_match`` (under
``jax.jit``) on the CPU for kdtree, kmeans and composite, on
``bench_trajectory.planted_float`` with ``default_rng(42)``: at
tests/test_flann.py's own size (2,048 train rows, 256 queries) with its
parameters (``bench_trajectory.FLANN_TEST``), and at 16,384 x 16,384 with
those parameters and with ``key_bits=9`` (the test's 32 train rows per
bucket at the larger bank). The queries are matched 1,024 at a time (each
row's match depends only on the index and the row). Prints one JSON line:
recall (the share of queries matched to their planted row) and the largest
candidate count per configuration and method.

Not collected by pytest (no ``test_`` prefix). About two minutes on a CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libwave_tpu.vision import flann_float as jff  # noqa: E402
from libwave_tpu_torch import bench_trajectory as bt  # noqa: E402

CONFIGS = {"test_2048": (2048, 256, {}),
           "test_16384": (16384, 16384, {}),
           "bits9_16384": (16384, 16384, {"key_bits": 9})}
CHUNK = 1024


def recall(n_train, n_query, extra, method):
    d1, d2, src = bt.planted_float(np.random.default_rng(bt.FLANN_SEED),
                                   n_train=n_train, n_query=n_query)
    p = jff.FloatIndexParams(method=method, **{**bt.FLANN_TEST, **extra})
    index = jax.jit(jff.build_float_index, static_argnums=2)(
        jnp.asarray(d2), jnp.ones(n_train, bool), p)
    match = jax.jit(jff.float_match, static_argnums=3)
    idx, cand = [], 0
    for k in range(0, n_query, CHUNK):
        q = jnp.asarray(d1[k:k + CHUNK])
        i, _, diag = match(q, jnp.ones(q.shape[0], bool), index, p)
        idx.append(np.asarray(i))
        cand = max(cand, int(np.asarray(diag["num_candidates"]).max()))
    return float(np.mean(np.concatenate(idx) == src)), cand


def main():
    out = {}
    for name, (n_train, n_query, extra) in CONFIGS.items():
        for method in ("kdtree", "kmeans", "composite"):
            rec, cand = recall(n_train, n_query, extra, method)
            out[f"{name}/{method}"] = {"recall": rec, "max_candidates": cand}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
