"""Checkpoints of a simulation's or a problem's committed state as ``.npz``
files.

    save_checkpoint(path, sim.state_dict())
    sim.load_state_dict(load_checkpoint(path))

    save_checkpoint(path, state_dict(problem))      # IncrSmallStrainProblem
    load_state_dict(problem, load_checkpoint(path))

The file format is the JAX package's (``fenics_constitutive_tpu.utils.
checkpoint``): one array per leaf, keyed by its path in the tree joined with
``::`` and ending in ``#leaf`` (or ``#none`` for a None leaf). So a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

__all__ = ["load_checkpoint", "load_state_dict", "restore_like", "save_checkpoint", "state_dict"]

_SEP = "::"


def save_checkpoint(path, tree) -> None:
    """Save a tree of tensors and arrays (dicts, tuples, lists, None leaves)
    to ``path`` (.npz); tensors are copied to the host."""
    flat = {}

    def visit(subtree, prefix):
        if subtree is None:
            flat[prefix + "#none"] = np.zeros(0)
        elif isinstance(subtree, dict):
            for k, v in subtree.items():
                visit(v, f"{prefix}{k}{_SEP}")
        elif isinstance(subtree, (tuple, list)):
            for i, v in enumerate(subtree):
                visit(v, f"{prefix}{i}{_SEP}")
        elif isinstance(subtree, torch.Tensor):
            flat[prefix + "#leaf"] = subtree.detach().cpu().numpy()
        else:
            flat[prefix + "#leaf"] = np.asarray(subtree)

    visit(tree, "")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path) -> dict:
    """Load a checkpoint into a nested dict of numpy arrays.

    Tuples and lists come back as dicts keyed by their stringified indices
    and None leaves as None; ``PackedSimulation.load_state_dict`` and
    :func:`load_state_dict` restore the tree against the live state
    (:func:`restore_like`), so they never have to guess which is which.
    """
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            body, kind = key.rsplit("#", 1)
            parts = [p for p in body.split(_SEP) if p]
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            leafname = parts[-1] if parts else ""
            node[leafname] = None if kind == "none" else data[key]
    return root


def restore_like(node, like, where: str = "state"):
    """``node`` (a loaded tree: tensors or numpy arrays, with tuples possibly
    as index-keyed dicts) restored against the live tree ``like``: the same
    structure, tuples by index and dicts by name, every leaf of like's shape,
    copied to like's dtype and device. Raises ValueError on a mismatch."""
    if like is None:
        if node is not None and not (isinstance(node, dict) and not node):
            msg = f"checkpoint {where}: values where the state has none"
            raise ValueError(msg)
        return None
    if isinstance(like, torch.Tensor):
        if node is None:
            msg = f"checkpoint {where}: missing"
            raise ValueError(msg)
        if not isinstance(node, torch.Tensor):
            node = torch.as_tensor(np.asarray(node))
        if tuple(node.shape) != tuple(like.shape):
            msg = (f"checkpoint {where}: shape {tuple(node.shape)}, the live state has "
                   f"{tuple(like.shape)}")
            raise ValueError(msg)
        return node.detach().to(dtype=like.dtype, device=like.device).clone()
    if isinstance(like, (tuple, list)):
        if isinstance(node, dict):
            keys = [str(i) for i in range(len(like))]
            if set(node) != set(keys):
                msg = f"checkpoint {where}: entries {sorted(node)}, expected {keys}"
                raise ValueError(msg)
            node = [node[k] for k in keys]
        if not isinstance(node, (tuple, list)) or len(node) != len(like):
            msg = f"checkpoint {where}: expected {len(like)} entries"
            raise ValueError(msg)
        return type(like)(restore_like(n, li, f"{where}[{i}]")
                          for i, (n, li) in enumerate(zip(node, like)))
    if not isinstance(node, dict) or set(node) != set(like):
        msg = f"checkpoint {where}: expected the entries {sorted(like)}"
        raise ValueError(msg)
    return {k: restore_like(node[k], like[k], f"{where}.{k}") for k in like}


def state_dict(problem) -> dict:
    """The committed state of an ``IncrSmallStrainProblem``: displacements,
    the committed stress (a tuple of per-law fields on the packed engine,
    one [C, Q, s] tensor on the AoS engine), the histories, time and dt.

    A sharded problem gives the one-process layout, the same on every rank
    (a collective: call it in every rank), so its checkpoint restores into
    a one-process problem or one sharded over any number of ranks."""
    stress, histories = problem._stress_prev, tuple(problem._histories)
    if problem._shard is not None:
        stress, histories = problem._shard.whole_state(problem, stress, histories)
    return {
        "engine": problem.engine,
        "u": problem.u,
        "u_prev": problem.u_prev,
        "stress_prev": stress,
        "histories": tuple(histories),
        "t": torch.tensor(float(problem.sim_time.current), dtype=torch.float64),
        "dt": torch.tensor(float(problem.sim_time.dt), dtype=torch.float64),
    }


def load_state_dict(problem, state: dict) -> None:
    """Restore a :func:`state_dict` (or ``load_checkpoint`` of one) into a
    problem of the same engine and mesh, against its own state: the stress
    layout of its engine, histories by name; a sharded problem takes the
    one-process layout and keeps its rank's part. Raises ValueError on
    another engine's checkpoint or a mismatched tree."""
    marker = state.get("engine")
    if marker is not None and str(np.asarray(marker)) != problem.engine:
        msg = f"checkpoint of the {np.asarray(marker)} engine, problem on {problem.engine}"
        raise ValueError(msg)
    shard = problem._shard
    stress, histories = problem._stress_prev, tuple(problem._histories)
    if shard is not None:  # restored in the one-process layout, then split
        stress, histories = shard.whole_like(problem)
    stress = restore_like(state["stress_prev"], stress, "stress_prev")
    histories = restore_like(state["histories"], tuple(histories), "histories")
    if shard is not None:
        stress, histories = shard.local_state(problem, stress, histories)
    problem.u = restore_like(state["u"], problem.u, "u")
    problem.u_prev = restore_like(state["u_prev"], problem.u_prev, "u_prev")
    problem._stress_prev = problem._stress_curr = stress
    problem._histories = problem._histories_trial = tuple(histories)
    problem.sim_time.current = float(np.asarray(state["t"]))
    problem.sim_time.dt = float(np.asarray(state["dt"]))
