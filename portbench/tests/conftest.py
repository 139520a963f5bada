"""Shared pieces of the benchmark's CPU tests: a tiny configuration of the
same kind as the cells' (a ring of cameras, tracks, the same solver
settings), small enough for the CPU, and the cell built from it."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402


def tiny_config():
    cfg = json.loads((ROOT / "portbench/configs/dubrovnik-size-sequential.json")
                     .read_text())
    cfg.update(name="tiny", cameras=48, points=900, observations=3300)
    cfg["scene"]["max_track"] = 5
    return cfg


# The mixes' start is perturbed so that a map of the cells' size still
# descends in every one of its LM iterations. A tiny map's reduced system is
# solved almost exactly in each step, so a tenth of that perturbation keeps
# its five iterations descending (and a full one leaves it far from its
# minimum after five).
TINY_START = {"landmark_perturb_of_depth": 0.01,
              "pose_rotation_perturb_deg": 0.2,
              "pose_position_perturb_of_spacing": 0.01}


def tiny_cell(traffic="lm5_matrix_free", limits=None):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tr = json.loads((ROOT / f"portbench/traffic/{traffic}.json").read_text())
    tr.update(TINY_START)
    return spec.Cell(
        name="tiny", chips=1, config=tiny_config(), traffic=tr,
        limits=limits or json.loads(
            (ROOT / "portbench/limits/venice-mf.json").read_text()),
        end_to_end=tuple(bench["end_to_end"]),
        per_layer=tuple(m for m in bench["per_layer"]
                        if "workloads" not in m),
    )


@pytest.fixture
def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

