"""Spawn the ranks of ``tests/torch_dist_worker.py`` for a CPU test."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"


def run_ranks(case, world, tmp, inputs=None, timeout=300):
    """Run ``case`` on ``world`` gloo ranks in ``tmp``; returns each rank's
    results (dicts of numpy arrays). A rank that fails or outlives
    ``timeout`` seconds fails the test (every rank is killed)."""
    tmp = Path(tmp)
    inp = "-"
    if inputs is not None:
        inp = str(tmp / "inputs.npz")
        np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world),
         str(tmp / "store"), inp, str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{case} on {world} ranks did not finish in {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            pytest.fail(f"{case} rank {r} exited {p.returncode}:\n"
                        f"{log[-3000:]}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
