"""The port's mesh, multi-host wiring, sharded multi-matching and
pipelined windows (``libwave_tpu_torch.parallel``, ``matching.multi``,
``pipelines.overlap``) on the CPU.

Multi-rank cases run on gloo processes (``tests/torch_dist_worker.py``):
the mesh at 4 ranks (shapes, the factorization error, each axis's
collectives, the host mesh and its flattening), ``multi_match_sharded``
at 2 ranks against the JAX package's on a 2-device sub-mesh of the
conftest's 8 virtual CPU devices (f64: equal iterations and
correspondences, transforms within 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import matching as jm
from libwave_tpu import parallel as jpar
from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu_torch import bench_parallel
from libwave_tpu_torch import matching as tm
from libwave_tpu_torch import parallel as tpar
from libwave_tpu_torch.pipelines.overlap import (
    pipelined_windows,
    serial_windows,
)
from torch_dist_run import run_ranks

CPU = torch.device("cpu")
ICP = dict(res=0.2, multiscale_steps=0, max_iter=20, max_corr=3.0)


def test_exports_match_the_reference():
    names = {n for n in dir(jpar) if not n.startswith("_")}
    modules = {"mesh", "dist_ba", "dist_vio", "dist_pose_graph",
               "multihost"}
    assert names - modules <= set(dir(tpar))
    assert callable(tm.multi_match_sharded)


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    return run_ranks("mesh", 4, tmp_path_factory.mktemp("mesh4"))


def test_mesh_shapes_and_errors(mesh4):
    for r, out in enumerate(mesh4):
        np.testing.assert_array_equal(out["shape"], [2, 2])
        np.testing.assert_array_equal(out["index"], [r // 2, r % 2])
        assert int(out["bad"]) == 1  # a 3x2 mesh over 4 ranks raises
        np.testing.assert_array_equal(out["host_shape"], [1, 4])
        assert int(out["flat_size"]) == 4 and int(out["flat_index"]) == r


def test_mesh_collectives(mesh4):
    for r, out in enumerate(mesh4):
        d, t = r // 2, r % 2
        tp_ranks = [2 * d, 2 * d + 1]
        np.testing.assert_array_equal(out["psum_tp"],
                                      [sum(k + 1 for k in tp_ranks)] * 2)
        np.testing.assert_array_equal(out["psum_all"], [10.0, 10.0])
        np.testing.assert_array_equal(out["gather_dp"][:, 0],
                                      [t + 1, 2 + t + 1])
        # ring ppermute along dp: the other dp index's value
        np.testing.assert_array_equal(out["ppermute_dp"],
                                      [2 * (1 - d) + t + 1] * 2)


def test_make_mesh_single_process():
    mesh = tpar.make_mesh(device=CPU)
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.size == 1
    x = torch.arange(3.0)
    axis = mesh.axis("dp")
    assert axis.psum(x) is x and axis.all_gather(x) is x
    assert torch.equal(axis.ppermute(x, [(0, 0)]), x)
    with pytest.raises(ValueError):
        tpar.make_mesh(tpar.MeshConfig(dp=3, tp=2), device=CPU)
    with pytest.raises(ValueError):
        tpar.MeshConfig(tp=0).validate()
    with pytest.raises(ValueError, match="axes"):
        mesh.axis("sp")
    flat = tpar.flatten_mesh(mesh, "sp")
    assert flat.axis_names == ("sp",) and flat.axis("sp").size == 1


def test_multihost_config_and_single_process():
    for cfg in (tpar.MultiHostConfig(coordinator_address="file:///x"),
                tpar.MultiHostConfig(num_processes=2)):
        with pytest.raises(ValueError, match="together"):
            cfg.validate()
        with pytest.raises(ValueError, match="together"):
            jpar.MultiHostConfig(
                coordinator_address=cfg.coordinator_address,
                num_processes=cfg.num_processes).validate()
    tpar.MultiHostConfig().validate()
    tpar.MultiHostConfig(coordinator_address="tcp://h:1234",
                         num_processes=2, process_id=0).validate()
    assert tpar.initialize_multihost() is False
    assert jpar.initialize_multihost() is False
    assert tpar.host_block_range(100) == (0, 100) \
        == jpar.host_block_range(100)
    host = tpar.make_host_mesh(device=CPU)
    assert host.axis_names == ("dcn", "ici") and host.ranks.shape == (1, 1)


def _clouds(B=4, n=256):
    """B (ref, target) pairs: the port's synthetic scan moved by a pose
    per pair (the same numpy arrays go to both packages)."""
    refs, tgts = [], []
    for k in range(B):
        scan = tm.synthetic_scan(k, n=n, dtype=torch.float64,
                                 device="cpu").points.numpy()
        T = JSE3(q=jso3.exp_quat(jnp.asarray([0.0, 0.0, 0.02 * k])),
                 t=jnp.asarray([0.1 * k, 0.05, 0.0]))
        refs.append(scan)
        tgts.append(np.asarray(T.apply(jnp.asarray(scan))))
    return np.stack(refs), np.stack(tgts)


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    refs, tgts = _clouds()
    mask = np.ones(refs.shape[:2], bool)
    z = dict(refs_points=refs, refs_mask=mask, targets_points=tgts,
             targets_mask=mask, **ICP)
    ranks = run_ranks("match", 2, tmp_path_factory.mktemp("match"), z)
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2), devices=jax.devices()[:2])
    jres = jm.multi_match_sharded(
        jm.PointCloud(points=jnp.asarray(refs), mask=jnp.asarray(mask)),
        jm.PointCloud(points=jnp.asarray(tgts), mask=jnp.asarray(mask)),
        mesh, jm.ICPParams(**ICP))
    return ranks, jax.tree.map(np.asarray, jres)


def test_multi_match_sharded_matches_jax(matched):
    ranks, jres = matched
    r = ranks[0]
    np.testing.assert_array_equal(r["iterations"], jres.iterations)
    np.testing.assert_array_equal(r["converged"], jres.converged)
    np.testing.assert_array_equal(r["correspondences"], jres.correspondences)
    np.testing.assert_allclose(r["t"], jres.transform.t, atol=1e-9)
    np.testing.assert_allclose(r["q"], jres.transform.q, atol=1e-9)
    for k in r:  # every rank holds the whole batch's result
        np.testing.assert_array_equal(r[k], ranks[1][k], err_msg=k)


def test_pipelined_windows_equal_serial():
    frames = bench_parallel.pp_frames(3, size=(96, 128))
    fe, be = bench_parallel.pp_stages(num_features=64, num_hypotheses=128)
    serial = serial_windows(fe, be, frames)
    piped = pipelined_windows(fe, be, frames)
    assert len(serial) == len(piped) == 3
    for a, b in zip(serial, piped):
        assert torch.equal(a, b)
    assert pipelined_windows(fe, be, []) == []
