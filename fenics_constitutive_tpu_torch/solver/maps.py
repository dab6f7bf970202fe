"""Cell-subset maps: a law's block of ``[C_parent, Q, ...]`` QP fields.

Indexing on the leading cell axis, with the whole-mesh identity fast path
(the map hands the parent back as it is)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CellSubsetMap", "build_cell_subset_map"]


@dataclass(frozen=True)
class CellSubsetMap:
    """Maps [C_parent, Q, ...] QP fields to and from a cell subset block."""

    cells: np.ndarray  # subset cell indices (parent numbering)
    n_parent: int
    identity: bool

    def _index(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.cells, dtype=torch.int64, device=like.device)

    def map_to_sub(self, parent: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return parent
        return parent[self._index(parent)]

    def map_to_parent(self, sub: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
        """The parent with the subset block overwritten (a copy)."""
        if self.identity:
            return sub
        out = parent.clone()
        out[self._index(parent)] = sub
        return out


def build_cell_subset_map(cells, n_parent: int) -> CellSubsetMap:
    """The map of ``cells`` in a parent of ``n_parent`` cells; the identity
    when ``cells`` is every cell in order."""
    cells = np.asarray(cells, np.int64)
    identity = len(cells) == n_parent and np.array_equal(cells, np.arange(n_parent))
    return CellSubsetMap(cells=cells, n_parent=n_parent, identity=identity)
