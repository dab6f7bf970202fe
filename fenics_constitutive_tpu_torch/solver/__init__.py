"""Newton-Krylov stepping on the structured, structured-tet, lattice,
windowed and gather engines, and the reference-parity problem
(``IncrSmallStrainProblem``, ``make_load_step``) on them or on the AoS
layouts."""

from .amg import AmgPreconditioner, WindowedAmgPreconditioner, build_amg
from .compiled import CompiledStep, compile_step, device_while, disable_capture
from .linear import cg_solve
from .multigrid import MultigridPreconditioner, build_multigrid
from .packed_step import (
    WINDOWED_MIN_CELLS,
    PackedState,
    build_packed_problem,
    make_packed_step,
    resolve_engine,
)
from .problem import IncrSmallStrainProblem, SimulationTime
from .simulation import PackedSimulation
from .step import StepState, make_load_step

__all__ = [
    "WINDOWED_MIN_CELLS",
    "AmgPreconditioner",
    "CompiledStep",
    "IncrSmallStrainProblem",
    "MultigridPreconditioner",
    "PackedSimulation",
    "PackedState",
    "SimulationTime",
    "StepState",
    "WindowedAmgPreconditioner",
    "build_amg",
    "build_multigrid",
    "build_packed_problem",
    "cg_solve",
    "compile_step",
    "device_while",
    "disable_capture",
    "make_load_step",
    "make_packed_step",
    "resolve_engine",
]
