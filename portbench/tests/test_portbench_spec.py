"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and entries, and load without any file being edited."""

import json
import shutil

from conftest import ROOT
from portbench.harness import spec


def _copy_tree(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]).read)


def test_a_cell_added_as_files(tmp_path):
    _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    root = tmp_path
    cfg = json.loads((root / "portbench/configs/dubrovnik-size-sequential.json")
                     .read_text())
    cfg["name"] = "bal-ladybug-49"
    cfg.update(cameras=49, points=7776, observations=31843)
    (root / "portbench/configs/bal-ladybug-49.json").write_text(
        json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/lm5_matrix_free.json")
                    .read_text())
    tr["lm_iterations"] = 3
    (root / "portbench/traffic/lm3_matrix_free.json").write_text(
        json.dumps(tr))
    (root / "portbench/limits/ladybug-mf.json").write_text(json.dumps(
        {"cost_gap": 1e-4, "reported_gap": 1e-4, "trajectory_gap": 1e-3,
         "state_gap": 1e-2}))
    (root / "portbench/metrics/solves_traced.py").write_text(
        "def read(trace):\n    return float(len(trace.solves))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bal-ladybug-49", "source": "x",
                             "file": "portbench/configs/bal-ladybug-49.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ladybug-mf",
                               "config": "bal-ladybug-49",
                               "traffic": "lm3_matrix_free", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "solves_traced", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "LM loop (optim/ba.py solve_ba)",
                               "moves": "lm_iter_per_s",
                               "workloads": ["ladybug-mf"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("ladybug-mf", root=root)
    assert cell.config["cameras"] == 49 and cell.traffic["lm_iterations"] == 3
    assert cell.limits["trajectory_gap"] == 1e-3
    names = [m["name"] for m in cell.per_layer]
    assert "solves_traced" in names
    assert not {"pcg_live_share", "seg_reduce_roofline"} & set(names)
    reader = spec.load_reader("solves_traced", root=root)
    assert reader.read(type("T", (), {"solves": [1, 2]})()) == 2.0
    # no file of the benchmark changed but BENCHMARK.json
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
