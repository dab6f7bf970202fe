"""PyTorch and CUDA port of fenics_constitutive_tpu, for NVIDIA Hopper GPUs.

The same layout and names as the JAX package (``fem``, ``models``, ``ops``,
``solver``, ``postprocessing``, ``utils``, and ``native``, imported on
demand). This package imports ``torch`` and numpy and never ``jax``; the
JAX package is the reference it is tested against. Its main path is the
structured-hex Newton step (``solver.make_packed_step``,
``solver.PackedSimulation``); general meshes run on the windowed engine.
The reference-parity entry point is ``solver.IncrSmallStrainProblem``.
The hand-written CUDA kernels, built from ``csrc/`` by nvcc at first use:
``ops.cuda_matvec`` (the fused CG operator), ``ops.cuda_eval`` (the fused
VonMises3D eval and assembly), ``ops.cuda_smoother`` (the multigrid
smoothing chains) and ``ops.cuda_window`` (the windowed gather, scatter and
BSR SpMV).
"""

from . import fem, models, ops, postprocessing, solver, utils
from .models import (
    Constraint,
    IncrSmallStrainModel,
    LinearElasticityModel,
    MisesPlasticityLinearHardening3D,
    PlaneStrainFrom3D,
    SpringKelvinModel,
    SpringMaxwellModel,
    StressStrainConstraint,
    UniaxialStrainFrom3D,
    VonMises3D,
)

# the JAX package's top-level names (its __init__ re-exports the model library)
__all__ = [
    "Constraint",
    "IncrSmallStrainModel",
    "LinearElasticityModel",
    "MisesPlasticityLinearHardening3D",
    "PlaneStrainFrom3D",
    "SpringKelvinModel",
    "SpringMaxwellModel",
    "StressStrainConstraint",
    "UniaxialStrainFrom3D",
    "VonMises3D",
    "fem",
    "models",
    "ops",
    "postprocessing",
    "solver",
    "utils",
]
