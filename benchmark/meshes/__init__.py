"""Mesh kinds, one module each: ``inputs(spec)`` (the nodes and cells the
reference reads; for a configuration whose space has degree above 1 also
``spacing``, the lattice its dof nodes are matched on), ``prepare(inputs,
spec, workdir)`` (any file written before the set-up clock starts) and
``program_mesh(inputs, spec, workdir)`` (the program's own mesh, built or
read in its set-up)."""

import importlib


def mesh_module(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")
