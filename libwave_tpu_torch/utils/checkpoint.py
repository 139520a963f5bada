"""Checkpoint / resume for long-running solves and pipelines.

Port of ``libwave_tpu.utils.checkpoint``: any tree of arrays (a solver
state, a chain's estimates, a trajectory) round-trips through one ``.npz``
file, written to a temporary name and moved into place with an atomic
``os.replace``. The leaves are stored as ``leaf_<i>`` in the order
``jax.tree.flatten`` visits them — dict keys sorted, NamedTuple, tuple and
list fields in place, ``None`` an empty subtree — so a file written by
either package loads in the other. (``torch.utils._pytree`` keeps a dict's
insertion order instead, which would misnumber the leaves of the flat
dicts ``pipelines.windowed_vio`` saves.) The ``__treedef__`` entry describes
the structure for a reader; loading rebuilds it from ``like``, as the
reference does.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "solve_with_checkpoints"]


def _flatten(tree):
    """(leaves, structure) in ``jax.tree.flatten``'s order."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        kind = "namedtuple" if hasattr(tree, "_fields") else type(tree)
        return ([x for leaves, _ in parts for x in leaves],
                (kind, type(tree), [s for _, s in parts]))
    return [tree], "leaf"


def _unflatten(structure, leaves):
    """Rebuild the tree of ``structure`` from the iterator ``leaves``."""
    if structure is None:
        return None
    if structure == "leaf":
        return next(leaves)
    kind, meta, subs = structure
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(meta, subs)}
    children = [_unflatten(s, leaves) for s in subs]
    return meta(*children) if kind == "namedtuple" else meta(children)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _restore(arr: np.ndarray, like_leaf):
    """A stored array as a tensor, on the device of the leaf it replaces
    (the CPU for a numpy or scalar leaf), in the file's dtype."""
    device = like_leaf.device if isinstance(like_leaf, torch.Tensor) else "cpu"
    return torch.as_tensor(arr).to(device)


def save_checkpoint(path: str, tree) -> None:
    """Snapshot a tree of tensors or arrays to ``<path>`` (npz)."""
    leaves, structure = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(str(structure)).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp.npz"  # savez appends .npz unless already suffixed
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """Restore a snapshot into the structure of ``like`` (same tree shape;
    the stored arrays replace its leaves, as tensors on each leaf's
    device)."""
    leaves, structure = _flatten(like)
    with np.load(path) as data:
        restored = [_restore(data[f"leaf_{i}"], x)
                    for i, x in enumerate(leaves)]
    return _unflatten(structure, iter(restored))


def latest_checkpoint(directory: str, prefix: str = "ckpt_"):
    """Newest checkpoint path under ``directory`` or None."""
    if not os.path.isdir(directory):
        return None
    cands = [
        f for f in os.listdir(directory)
        if f.startswith(prefix) and f.endswith(".npz")
    ]
    if not cands:
        return None
    cands.sort()
    return os.path.join(directory, cands[-1])


def solve_with_checkpoints(
    solve_chunk,
    state,
    total_iterations: int,
    directory: str,
    every: int = 5,
    prefix: str = "ckpt_",
    resume: bool = True,
):
    """Periodic solver-state snapshots around a chunked solve loop.

    ``solve_chunk(state, carry, num_iterations) -> (state, carry)`` runs
    ``num_iterations`` solver iterations; ``carry`` threads solver scalars
    such as the LM lambda between chunks and is a tree of tensors or None.
    After each chunk the (state, carry) pair lands in
    ``directory/<prefix><iter>.npz`` through an atomic rename; with
    ``resume`` the newest snapshot is loaded and the loop continues from its
    iteration count.

    Returns (state, carry, start_iteration_of_last_run).
    """
    os.makedirs(directory, exist_ok=True)
    carry = None
    start = 0
    if resume:
        latest = latest_checkpoint(directory, prefix)
        if latest is not None:
            start = int(os.path.basename(latest)[len(prefix):-4])
            state, carry = _load_state_carry(latest, state)
    it = start
    while it < total_iterations:
        n = min(every, total_iterations - it)
        state, carry = solve_chunk(state, carry, n)
        it += n
        _save_state_carry(
            os.path.join(directory, f"{prefix}{it:08d}.npz"), state, carry
        )
    return state, carry, start


def _save_state_carry(path, state, carry):
    # tuple order matters: state leaves first, carry leaves after (the
    # loader splits by the state's leaf count)
    save_checkpoint(path, (state, carry))


def _load_state_carry(path, like_state):
    """Restore (state, carry). Leaves beyond the state's belong to the
    carry, which comes back as a flat tuple (None when there are none), on
    the device of the state's first leaf."""
    state_leaves, structure = _flatten(like_state)
    n = len(state_leaves)
    first = state_leaves[0] if state_leaves else None
    leaves = []
    with np.load(path) as data:
        while f"leaf_{len(leaves)}" in data:
            i = len(leaves)
            like = state_leaves[i] if i < n else first
            leaves.append(_restore(data[f"leaf_{i}"], like))
    state = _unflatten(structure, iter(leaves[:n]))
    carry_leaves = leaves[n:]
    carry = tuple(carry_leaves) if carry_leaves else None
    return state, carry
