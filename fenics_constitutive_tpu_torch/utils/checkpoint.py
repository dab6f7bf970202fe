"""Checkpoints of a simulation's committed state as ``.npz`` files.

    save_checkpoint(path, sim.state_dict())
    sim.load_state_dict(load_checkpoint(path))

The file format is the JAX package's (``fenics_constitutive_tpu.utils.
checkpoint``): one array per leaf, keyed by its path in the tree joined with
``::`` and ending in ``#leaf`` (or ``#none`` for a None leaf). So a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

__all__ = ["load_checkpoint", "save_checkpoint"]

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
    and None leaves as None; ``PackedSimulation.load_state_dict`` restores
    the tree against its own state, so it never has to guess which is which.
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
