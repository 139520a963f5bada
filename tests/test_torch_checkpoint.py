"""The port's checkpoint files (``libwave_tpu_torch.utils.checkpoint``)
against the JAX package's (``libwave_tpu.utils.checkpoint``).

- round trips of a NamedTuple state, a dict and a tuple (with ``None``)
  restore every leaf exactly, in the file's dtype, on the device of the
  leaf it replaces;
- leaves are numbered as ``jax.tree.flatten`` numbers them (dict keys
  sorted), so a file written by either package loads in the other, exactly;
- ``solve_with_checkpoints`` around a chunked port BA solve (the JAX
  package's ``tests/test_aux.py:101-170``): stopping after 6 of 12
  iterations and resuming reaches the uninterrupted solve's state within
  1e-10 (both run the same f64 arithmetic on the CPU; measured 0).
"""

import os
import shutil
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.optim import ba_from_dataset
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu.utils import checkpoint as jck
from libwave_tpu_torch import interop
from libwave_tpu_torch.optim.ba import BAConfig, BAState, solve_ba
from libwave_tpu_torch.utils import checkpoint as tck


class Pair(NamedTuple):
    a: torch.Tensor
    b: object


def _tree_equal(got, ref):
    if ref is None:
        assert got is None
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref)  # restored in sorted order, as JAX
        for k in ref:
            _tree_equal(got[k], ref[k])
    elif isinstance(ref, tuple):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _tree_equal(g, r)
    else:
        assert isinstance(got, torch.Tensor)
        r = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
        assert got.numpy().dtype == r.dtype
        np.testing.assert_array_equal(got.numpy(), r)


def _trees(rng):
    return {
        "namedtuple": BAState(q=torch.as_tensor(rng.normal(size=(5, 4))),
                              p=torch.as_tensor(rng.normal(size=(5, 3))),
                              lm=torch.as_tensor(rng.normal(size=(7, 3)))),
        # inserted out of sorted order, nested, with ints and a None
        "dict": {"zeta": np.arange(4, dtype=np.int64),
                 "alpha": torch.as_tensor(rng.normal(size=(2, 2))),
                 "mid": Pair(a=torch.ones(3, dtype=torch.float32), b=None),
                 "beta": np.asarray(7)},
        "tuple": (torch.as_tensor(rng.normal(size=3)), None,
                  (np.zeros((2, 0)), torch.arange(5, dtype=torch.int32))),
    }


@pytest.mark.parametrize("kind", ["namedtuple", "dict", "tuple"])
def test_round_trip(tmp_path, rng, kind):
    tree = _trees(rng)[kind]
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, tree)
    assert sorted(os.listdir(tmp_path)) == ["c.npz"]  # the temp file moved
    _tree_equal(tck.load_checkpoint(path, tree), tree)


def test_leaves_in_jax_order(tmp_path, rng):
    tree = _trees(rng)["dict"]
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, tree)
    ref, _ = jax.tree.flatten(jax.tree.map(np.asarray, {
        k: (Pair(a=np.asarray(v.a), b=None) if isinstance(v, Pair) else
            np.asarray(v)) for k, v in tree.items()}))
    with np.load(path) as data:
        assert len([k for k in data if k.startswith("leaf_")]) == len(ref)
        for i, r in enumerate(ref):
            np.testing.assert_array_equal(data[f"leaf_{i}"], r)


def _numpy_tree(tree):
    return jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree)


@pytest.mark.parametrize("kind", ["namedtuple", "dict", "tuple"])
def test_files_interchange_with_jax(tmp_path, rng, kind):
    tree = _trees(rng)[kind]
    jtree = _numpy_tree(tree)
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, jtree)
    _tree_equal(tck.load_checkpoint(jpath, tree), tree)
    # the port writes, JAX reads
    tpath = str(tmp_path / "torch.npz")
    tck.save_checkpoint(tpath, tree)
    got = jck.load_checkpoint(tpath, jtree)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(g), r)


def test_load_restores_on_the_like_device(tmp_path):
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, {"x": np.arange(3.0)})
    got = tck.load_checkpoint(path, {"x": torch.zeros(3, device="meta")})
    assert got["x"].device.type == "meta"
    assert got["x"].dtype == torch.float64


def test_latest_checkpoint(tmp_path):
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tck.latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_00000003.npz", "ckpt_00000012.npz", "other_9.npz",
                 "ckpt_00000006.npz", "ckpt_00000020.txt"):
        (tmp_path / name).write_bytes(b"")
    assert tck.latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "ckpt_00000012.npz")
    assert tck.latest_checkpoint(str(tmp_path), prefix="other_") == str(
        tmp_path / "other_9.npz")


@pytest.fixture(scope="module")
def ba_case():
    """The JAX package's test problem (``tests/test_aux.py``), carried into
    the port; the init perturbed by numpy noise."""
    ds = generate_vo_dataset(
        VoSimParams(nb_landmarks=40, steps=100, fx=200.0, fy=200.0,
                    hz=10.0),
        jax.random.key(31),
    )
    problem, gt = ba_from_dataset(ds)
    problem, gt = interop.from_jax_numpy(
        jax.tree.map(np.asarray, problem), jax.tree.map(np.asarray, gt),
        "cpu", torch.float64)
    rng = np.random.default_rng(32)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    free = problem.free_pose[:, None].numpy()
    from libwave_tpu_torch.geometry import so3

    init = BAState(
        q=so3.quat_boxplus(gt.q, torch.as_tensor(
            0.02 * rng.standard_normal((N, 3)) * free)),
        p=gt.p + torch.as_tensor(0.05 * rng.standard_normal((N, 3)) * free),
        lm=gt.lm + torch.as_tensor(0.2 * rng.standard_normal((M, 3))),
    )

    def solve_chunk(state, carry, n):
        lam = carry[0] if carry is not None else torch.tensor(1e-4)
        cfg = BAConfig(max_iterations=n, cg_max_iters=40,
                       init_lambda=float(lam))
        state, info = solve_ba(problem, state, cfg)
        return state, (info["final_lambda"],)

    return init, solve_chunk


def test_solve_with_checkpoints_resumes(tmp_path, ba_case):
    init, solve_chunk = ba_case
    d = str(tmp_path / "ckpts")
    # the first 6 of 12 iterations, then a "crash"
    _, carry_mid, start = tck.solve_with_checkpoints(
        solve_chunk, init, total_iterations=6, directory=d, every=3)
    assert start == 0
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz", "ckpt_00000006.npz"]
    # resume: picks up at iteration 6 and finishes
    s_end, carry_end, start2 = tck.solve_with_checkpoints(
        solve_chunk, init, total_iterations=12, directory=d, every=3)
    assert start2 == 6
    assert len(os.listdir(d)) == 4
    assert isinstance(carry_end, tuple) and carry_end[0].dim() == 0
    # the uninterrupted run
    shutil.rmtree(d)
    s_ref, carry_ref, _ = tck.solve_with_checkpoints(
        solve_chunk, init, total_iterations=12, directory=d, every=3,
        resume=False)
    for f in BAState._fields:
        np.testing.assert_allclose(getattr(s_end, f).numpy(),
                                   getattr(s_ref, f).numpy(), atol=1e-10)
    assert float(carry_end[0]) == float(carry_ref[0])
    # the snapshot the resume read is a JAX-readable (state, carry) file
    state, carry = jck._load_state_carry(
        os.path.join(d, "ckpt_00000006.npz"),
        jax.tree.map(lambda x: x.numpy(), init))
    assert len(carry) == 1 and state.q.shape == init.q.shape
