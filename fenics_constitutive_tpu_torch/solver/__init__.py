"""Newton-Krylov stepping on the structured engine."""

from .linear import cg_solve
from .multigrid import MultigridPreconditioner, build_multigrid
from .packed_step import PackedState, build_packed_problem, make_packed_step
from .simulation import PackedSimulation

__all__ = [
    "MultigridPreconditioner",
    "PackedSimulation",
    "PackedState",
    "build_multigrid",
    "build_packed_problem",
    "cg_solve",
    "make_packed_step",
]
