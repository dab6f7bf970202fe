"""Newton-Krylov stepping on the structured, structured-tet, windowed and
gather engines."""

from .amg import AmgPreconditioner, WindowedAmgPreconditioner, build_amg
from .linear import cg_solve
from .multigrid import MultigridPreconditioner, build_multigrid
from .packed_step import (
    WINDOWED_MIN_CELLS,
    PackedState,
    build_packed_problem,
    make_packed_step,
    resolve_engine,
)
from .simulation import PackedSimulation

__all__ = [
    "WINDOWED_MIN_CELLS",
    "AmgPreconditioner",
    "MultigridPreconditioner",
    "PackedSimulation",
    "PackedState",
    "WindowedAmgPreconditioner",
    "build_amg",
    "build_multigrid",
    "build_packed_problem",
    "cg_solve",
    "make_packed_step",
    "resolve_engine",
]
