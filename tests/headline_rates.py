"""The headline problem's explicit-S and matrix-free LM iterations/s of one
checkout, timed as ``chip_smoke.py``'s headline and matrix_free phases time
them (``bench_problem.bench_backend``, 10 LM iterations, four runs each).

    python tests/headline_rates.py ROOT LABEL [utils_first]

ROOT: a checkout (this one, or another unpacked with ``git archive`` into
the git-ignored ``_checkout/``); its ``chip_smoke.py`` builds the kernels.
``utils_first`` runs that script's ``phase_utils(dev, smi)`` in this
process first, as a tree that profiled in its own process before the
solves did. Prints one line, ``RATES {json}``, with the card's name and
power limit. To compare trees, run them in one call in the order A, B, B,
A. Card only; not a test (pytest does not collect it); ~35 s a tree.
"""

import dataclasses
import json
import os
import sys


def main(root, label, utils_first):
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from libwave_tpu_torch import bench_problem

    _, smi, _ = cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda:0")
    if utils_first:
        cs.phase_utils(dev, smi)
    problem, state = bench_problem.make_problem(device=dev)
    cfg = dataclasses.replace(bench_problem.bench_config(10),
                              explicit_s="never")
    out = {"label": label, "utils_first": utils_first, "smi": smi,
           "headline": [bench_problem.bench_backend(problem, state, 10)[0]
                        for _ in range(4)],
           "matrix_free": [bench_problem.bench_backend(problem, state,
                                                       cfg=cfg)[0]
                           for _ in range(4)]}
    for k in ("headline", "matrix_free"):
        out[f"{k}_median"] = float(np.median(out[k]))
    print("RATES " + json.dumps(out))


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]), sys.argv[2],
         sys.argv[3:4] == ["utils_first"])
