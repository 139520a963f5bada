"""The ``final-size-sequential`` configuration and its cell
``final-13682-mf``: the cell loads from its files alone, the scene's
structure at BAL Final's full counts is the one the configuration records,
and at a size the CPU holds, with Final's mean track, the port's solve
passes the cell's limits against the plain reference."""

import json

import numpy as np

from conftest import ROOT, TINY_START
from portbench.harness import check, port, spec
from portbench.harness import scene as S
from portbench.harness.scene import make_scene
from portbench.reference import ba_ref

CELL = "final-13682-mf"
CONFIG = json.loads(
    (ROOT / "portbench/configs/final-size-sequential.json").read_text())


def test_the_cell_loads_from_its_files():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config == CONFIG
    assert (cell.config["cameras"], cell.config["points"],
            cell.config["observations"]) == (13_682, 4_456_117, 28_987_644)
    assert cell.traffic == json.loads(
        (ROOT / "portbench/traffic/lm5_matrix_free.json").read_text())
    assert cell.traffic["explicit_s"] == "never"
    assert not cell.traffic["band_plan"]
    assert set(cell.limits) == set(check.NAMES)
    assert [m["name"] for m in cell.end_to_end] == [
        "lm_iter_per_s", "peak_mem_gib", "setup_s"]
    # the per-layer metrics without a list of cells, and none of the listed
    assert [m["name"] for m in cell.per_layer] == [
        "kernels_per_iter", "device_idle", "device_ms_per_iter"]
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]).read)


def _camera_counts(start, length, num_cameras):
    """Observations per camera of tracks (start, length) around the ring,
    counted from the tracks' ends without listing the observations."""
    edges = np.zeros(2 * num_cameras + 1, dtype=np.int64)
    np.add.at(edges, start, 1)
    np.add.at(edges, start + length, -1)
    covered = np.cumsum(edges)[:2 * num_cameras]
    return covered[:num_cameras] + covered[num_cameras:]


def test_camera_counts_match_the_listed_observations():
    start, length = S.track_structure(40, 700, 3_000, 6, 11)
    cam, _ = S.observations(start, length, 40)
    assert np.array_equal(_camera_counts(start, length, 40),
                          np.bincount(cam, minlength=40))


def test_structure_at_full_counts():
    N, M, K = (CONFIG[k] for k in ("cameras", "points", "observations"))
    start, length = S.track_structure(N, M, K, CONFIG["scene"]["max_track"],
                                      CONFIG["scene"]["structure_seed"])
    assert int(length.sum()) == K == 28_987_644
    assert length.min() == 2 and length.max() == 48
    counts = _camera_counts(start, length, N)
    assert int(counts.sum()) == K
    recorded = CONFIG["synthetic_scene"]
    pmax = int(counts.max())
    assert pmax == recorded["largest_camera_observations"] == 2_302
    assert N * pmax == recorded["pose_ell_slots"] == 31_495_964
    assert round(1.0 - K / (N * pmax), 4) == recorded[
        "pose_ell_padding_share"]
    assert round(K / N, 1) == recorded["mean_observations_per_camera"]
    assert round(K / M, 4) == recorded["mean_observations_per_point"]


def test_final_settings_solve_within_the_cells_limits(cpu):
    """96 cameras, tracks of at most 8, 1,800 points and 11,709
    observations (Final's mean track, 6.505), the configuration's scene and
    solver settings otherwise, from the tiny start."""
    cell = spec.load_cell(CELL)
    config = json.loads(json.dumps(CONFIG))
    config.update(cameras=96, points=1_800, observations=11_709)
    config["scene"]["max_track"] = 8
    traffic = {**cell.traffic, **TINY_START}
    scene = make_scene(config, traffic, 2**35 + 17, cpu)
    assert scene.max_camera_observations == 145
    assert round(scene.ell_padding_share, 3) == 0.159
    problem, state0, cfg = port.build(scene, config, traffic, cpu)
    assert problem.bands is None and cfg.explicit_s == "never"
    state, info = port.solve(problem, state0, cfg)
    settings = port.settings(config, traffic)
    reference = check.reference_solve(scene, settings)
    got = check.readings(scene, check.answer_of(state, info), reference)
    ok, lines = check.judge(got, cell.limits)
    assert ok, lines
    assert bool(info["accepted"].all())
    start = ba_ref.exact_cost(check.observations(scene), scene.q0, scene.p0,
                              scene.X0)
    assert reference[3] < 0.1 * start  # the solve does real work
