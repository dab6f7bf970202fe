"""PyTorch and CUDA port of fenics_constitutive_tpu, for NVIDIA Hopper GPUs.

The same layout and names as the JAX package (``fem``, ``models``, ``ops``,
``solver``, ``utils``). This package imports ``torch`` and numpy and never
``jax``; the JAX package is the reference it is tested against. Its main
path is the structured-hex Newton step (``solver.make_packed_step``,
``solver.PackedSimulation``) with two hand-written CUDA kernels:
``ops.cuda_matvec`` (the fused CG operator) and ``ops.cuda_eval`` (the fused
VonMises3D eval and assembly), built from ``csrc/`` by nvcc at first use.
"""

from . import fem, models, ops, solver, utils

__all__ = ["fem", "models", "ops", "solver", "utils"]
