"""Runs that hold a sharded problem to the one-process run of the same
inputs: both sides are built by the same functions, so they share every input.

A run is described by a ``spec`` dict of plain data (picklable, so spawned
ranks receive it):

* ``mesh``: ``("box", (nx, ny, nz), cell_type)``, ``("shuffled", n, seed)``
  (a Kuhn tet box with its node numbering shuffled and no box metadata, as
  an imported mesh arrives) or ``("gmsh", path)``; ``degree`` (default 1);
* ``law``: "mises" (VonMises3D, exponential hardening), "elastic",
  "hardening" (linear, h = 40000) or "two" (elastic below z = 0.5, mises
  above); ``q``: the quadrature degree;
* ``engine``: the problem's ("auto", "aos") or, for the packed step, the
  packed engine ("auto", "windowed", "gather");
* ``preconditioner``: None, "amg" (the problem's own) or "amg_windowed" (a
  node-major windowed-level hierarchy passed as a callable);
* ``loads``: the pulled face's displacement per step; ``solve``: keyword
  options of ``solve()``;
* ``observe``: also return the observation surface; ``check_window_kernels``
  (on the card): also hold K4 and K5 to their plain versions on each
  windowed plan the run used (the rank's own when sharded).

``problem_run(spec, device, mesh=None)`` drives ``IncrSmallStrainProblem``
and ``packed_step_run(spec, device, mesh=None)`` ``make_packed_step``; with
a DeviceMesh they shard first. ``cases_rank`` is the rank program of
``launch.run_ranks`` that runs several of them in one process group.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import sharding
from .sharding import (
    make_device_mesh,
    shard_packed_state,
    shard_problem,
    whole_packed_state,
)

__all__ = [
    "ELASTIC",
    "HARDENING",
    "MAT",
    "allreduce_run",
    "build_problem",
    "cases_rank",
    "checkpoint_run",
    "make_laws",
    "make_space",
    "packed_step_run",
    "pair_run",
    "problem_run",
    "warm_run",
]

#: VonMises3D with exponential hardening (the benchmark's material)
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
#: linear hardening with h ~ mu / 2: a uniformly SPD tangent past yield
HARDENING = {"mu": 80769.0, "kappa": 175000.0, "y_0": 1200.0, "h": 40000.0}
ELASTIC = {"E": 42000.0, "nu": 0.3}


def make_space(spec):
    from ..fem import FunctionSpace, Mesh, read_gmsh, unit_cube_mesh

    kind, *args = spec["mesh"]
    if kind == "box":
        mesh = unit_cube_mesh(*args[0], args[1])
    elif kind == "shuffled":
        n, seed = args
        box = unit_cube_mesh(n, n, n, "tetra")
        pi = np.random.default_rng(seed).permutation(box.num_nodes)
        nodes = np.empty_like(box.nodes)
        nodes[pi] = box.nodes
        mesh = Mesh(nodes, pi[box.cells].astype(np.int32), "tetra")
    elif kind == "gmsh":
        mesh = read_gmsh(args[0])
    else:
        msg = f"unknown mesh kind {kind!r}"
        raise ValueError(msg)
    return FunctionSpace(mesh, spec.get("degree", 1), 3)


def make_laws(spec, V):
    from ..models import (
        Constraint,
        LinearElasticityModel,
        MisesPlasticityLinearHardening3D,
        VonMises3D,
    )

    law = spec["law"]
    if law == "mises":
        return VonMises3D(MAT)
    if law == "elastic":
        return LinearElasticityModel(ELASTIC, Constraint.FULL)
    if law == "hardening":
        return MisesPlasticityLinearHardening3D(HARDENING)
    if law == "two":
        z = V.mesh.cell_midpoints()[:, 2]
        return [(LinearElasticityModel(ELASTIC, Constraint.FULL), np.flatnonzero(z < 0.5)),
                (VonMises3D(MAT), np.flatnonzero(z >= 0.5))]
    msg = f"unknown law {law!r}"
    raise ValueError(msg)


def _bcs(V, stretch: float = 0.0):
    """x=0 fixed in x, x=1 pulled in x (the returned BC), y=0 and z=0 fixed
    in y and z."""
    from ..fem import DirichletBC

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    move = DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), stretch)
    return [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        move,
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0),
    ], move


def _amg_windowed(V, bcs, q_degree, device, dtype):
    from ..fem import combine_bcs
    from ..solver import build_amg

    free = np.ones(V.ndofs, bool)
    free[combine_bcs(bcs)[0]] = False
    return build_amg(V, MAT["p_mu"], MAT["p_ka"], free, q_degree=q_degree, spmv="windowed",
                     device=device, dtype=dtype)


def build_problem(spec, device, dtype=torch.float64, pc=None):
    """``(problem, moving BC)`` of ``spec`` on ``device``; ``pc``, when
    given, is the preconditioner (built for the same mesh) instead of
    ``spec``'s."""
    from ..solver import IncrSmallStrainProblem

    V = make_space(spec)
    bcs, move = _bcs(V)
    if pc is None:
        pc = spec.get("preconditioner")
        if pc == "amg_windowed":
            pc = _amg_windowed(V, bcs, spec["q"], device, dtype)
    problem = IncrSmallStrainProblem(make_laws(spec, V), V, bcs, spec["q"], device=device,
                                     dtype=dtype, engine=spec.get("engine", "auto"),
                                     preconditioner=pc)
    return problem, move


def _qp_numel(problem) -> int:
    s = problem._stress_prev
    return sum(x.numel() for x in s) if isinstance(s, tuple) else s.numel()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window_launches() -> dict:
    from ..ops import cuda_window

    return dict(cuda_window.launches)


def _window_kernel_checks(problem) -> list:
    """K4 and K5 (ops/cuda_window.py) on each windowed plan of the problem,
    the rank's own when it is sharded, against their plain versions on
    random inputs at the plan's shapes, in f64 and f32: per plan and dtype,
    whether K4 is bit-equal to ``gather_plain``, whether two K5 launches are
    bit-equal, and K5's max abs error over max|plain|. Call it after the
    launches of a run are read: these launches count too."""
    from ..ops import cuda_window

    out = []
    for geo in problem._pk_geos:
        if geo.engine != "windowed":
            continue
        ex = getattr(geo, "local", geo).ex
        for dtype in (torch.float64, torch.float32):
            rng = np.random.default_rng(7)
            u2 = torch.as_tensor(rng.normal(size=(3, ex.M_pad)), dtype=dtype, device=geo.device)
            f = torch.as_tensor(rng.normal(size=(ex.B, 3, ex.Rn)), dtype=dtype, device=geo.device)
            y1, y2 = cuda_window.windowed_scatter(ex, f), cuda_window.windowed_scatter(ex, f)
            plain = cuda_window.scatter_plain(ex, f).double()
            err = float((y1.double() - plain).abs().max()) / max(float(plain.abs().max()), 1e-300)
            out.append({
                "plan": f"T={ex.T} B={ex.B} Rn={ex.Rn} M_pad={ex.M_pad}",
                "dtype": str(dtype)[6:],
                "k4_equal": bool(torch.equal(cuda_window.windowed_gather(ex, u2),
                                             cuda_window.gather_plain(ex, u2))),
                "k5_repeatable": bool(torch.equal(y1, y2)),
                "k5_rel": err,
            })
    return out


def _observe(problem, mesh) -> dict:
    """The observation surface of a committed state: histories, dxm, a
    norm (given the process group as ``comm`` when sharded) and sensors."""
    from ..postprocessing import DisplacementSensor, QPSensor, norm

    V, stress = problem.space, problem.stress_0
    point = [[0.5, 0.5, 0.5]]
    return {
        "history": [None if h is None else {k: v.cpu() for k, v in h.items()}
                    for h in problem._history_0],
        "dxm": problem.dxm.cpu(),
        "norm": float(norm(stress, problem.dxm,
                           None if mesh is None else torch.distributed.group.WORLD)),
        "u_sensor": DisplacementSensor(V, point)(problem.u).cpu(),
        "qp_sensor": QPSensor(V, problem.q_degree, point)(stress).cpu(),
    }


def problem_run(spec, device, mesh=None, dtype=torch.float64, pc=None) -> dict:
    """Drive ``spec``'s problem through its loads (sharded over ``mesh``
    when given); the whole problem's results on the CPU, with the run's
    Newton/CG counts, timings, device memory peaks (set-up, steps),
    window-kernel launches and all-reduces (those of the load steps).
    ``pc``: as ``build_problem``'s."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    problem, move = build_problem(spec, device, dtype, pc)
    whole_qp = _qp_numel(problem)
    if mesh is not None:
        shard_problem(problem, mesh)
    _sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _window_launches()
    reduces0 = sharding.collectives["all_reduce"]
    rows, trial = [], {}
    if mesh is not None:  # the ranks' step timers start together
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for value in spec["loads"]:
        move.value = value
        niter, converged = problem.solve(**spec.get("solve", {}))
        if not converged:
            msg = f"load {value}: Newton did not converge ({problem.last_stats})"
            raise RuntimeError(msg)
        if spec.get("observe") and value == spec["loads"][-1]:
            # the step in progress: its increment and trial state
            trial = {"del_grad_u": [g.cpu() for g in problem._del_grad_u],
                     "stress_1": problem.stress_1.cpu()}
        problem.update()
        rows.append([niter, int(problem.last_stats["cg_iters"])])
    _sync(device)
    ms_step = (time.perf_counter() - t0) * 1e3 / len(spec["loads"])
    launches = {k: v - launches0[k] for k, v in _window_launches().items()}
    all_reduces = sharding.collectives["all_reduce"] - reduces0
    hist = problem._history_0[-1]
    if spec.get("observe"):
        trial.update(_observe(problem, mesh))
    if spec.get("check_window_kernels"):
        trial["kernel_checks"] = _window_kernel_checks(problem)
    out = {
        **trial,
        "u": problem.u.cpu(),
        "stress": problem.stress_0.cpu(),
        "alpha": None if hist is None or "alpha" not in hist else hist["alpha"].cpu(),
        "iters": rows,
        "r_norm": float(problem.last_stats["r_norm"]),
        "setup_s": setup_s,
        "ms_step": ms_step,
        "setup_mem_peak": setup_peak,
        "mem_peak": torch.cuda.max_memory_allocated(device) if cuda else 0,
        "launches": launches,
        "all_reduces": all_reduces,
        "qp_numel": _qp_numel(problem),
        "whole_qp_numel": whole_qp,
    }
    if mesh is not None:
        u_all = mesh.all_gather(problem.u)
        out["u_bitequal"] = all(torch.equal(u_all[0], x) for x in u_all)
        out["rank"] = mesh.rank
    return out


def _shared_pc(spec, device):
    """``(spec``'s preconditioner built once for several problems, its
    build seconds)``; ``(None, 0.0)`` for the problem's own."""
    if spec.get("preconditioner") != "amg_windowed":
        return None, 0.0
    t0 = time.perf_counter()
    V = make_space(spec)
    pc = _amg_windowed(V, _bcs(V)[0], spec["q"], device, torch.float64)
    return pc, time.perf_counter() - t0


def _warm_up(spec, device, mesh, pc) -> None:
    """An untimed run of ``spec``'s first load: a fresh process's first
    steps pay CUDA's lazy set-up (module loads, library handles, the
    allocator's first blocks), which a timed run must not."""
    problem_run({**spec, "loads": spec["loads"][:1], "check_window_kernels": False,
                 "observe": False}, device, mesh, pc=pc)


def warm_run(spec, mesh) -> dict:
    """``spec``'s problem sharded over ``mesh``, timed after an untimed
    sharded run of its first load, with one preconditioner for both (its
    build seconds in ``pc_s``)."""
    pc, pc_s = _shared_pc(spec, mesh.device)
    _warm_up(spec, mesh.device, mesh, pc)
    return {**problem_run(spec, mesh.device, mesh, pc=pc), "pc_s": pc_s}


def pair_run(spec, mesh, pc=None) -> dict:
    """``spec``'s problem in one process, then sharded over ``mesh``, one
    after the other in this rank, after an untimed warm-up and with one
    preconditioner for all (``pc``, or ``spec``'s built once): on 1 rank,
    the wrappers' own cost apart from any other process."""
    if pc is None:
        pc, _ = _shared_pc(spec, mesh.device)
    _warm_up(spec, mesh.device, None, pc)
    return {"one": problem_run(spec, mesh.device, pc=pc),
            "sharded": problem_run(spec, mesh.device, mesh, pc=pc)}


def packed_step_run(spec, device, mesh=None, dtype=torch.float64) -> dict:
    """``make_packed_step`` on ``spec``'s mesh and law, the pulled face at
    ``spec["loads"][0]``, ``spec["steps"]`` steps (sharded over ``mesh``
    when given, through ``shard_packed_state``)."""
    from ..fem import combine_bcs
    from ..solver.packed_step import build_packed_problem, make_packed_step

    V = make_space(spec)
    bcs, _ = _bcs(V, spec["loads"][0])
    geos, models, state = build_packed_problem(V, make_laws(spec, V), spec["q"], device=device,
                                               dtype=dtype, engine=spec.get("engine", "auto"))
    whole_qp = sum(s.numel() for s in state.stress)
    if mesh is not None:
        geos, state = shard_packed_state(geos, state, mesh)
    bc_dofs, bc_vals = combine_bcs(bcs)
    step = make_packed_step(geos, newton_rtol=1e-10, cg_rtol=1e-12, cg_maxiter=2000)
    f_ext = torch.zeros_like(state.u)  # internal on the windowed engine
    dt = torch.tensor(1.0, dtype=dtype, device=device)
    bc_vals = torch.as_tensor(np.asarray(bc_vals), dtype=dtype, device=device)
    for _ in range(spec["steps"]):
        state, stats = step(models, state, bc_dofs, bc_vals, f_ext, dt)
    local_qp = sum(s.numel() for s in state.stress)
    if mesh is not None:
        state = whole_packed_state(geos, state)
    hist = state.histories[-1]
    out = {
        "u": state.u.cpu(),
        "stress": [s.cpu() for s in state.stress],
        "alpha_max": float(hist["alpha"].max()) if hist and "alpha" in hist else 0.0,
        "newton": int(stats["newton_iters"]),
        "qp_numel": local_qp,
        "whole_qp_numel": whole_qp,
    }
    if mesh is not None:
        u_all = mesh.all_gather(state.u)
        out["u_bitequal"] = all(torch.equal(u_all[0], x) for x in u_all)
    return out


def checkpoint_run(spec, mesh) -> dict:
    """A sharded run of ``spec["loads"]`` that checkpoints after the first
    ``spec["split"]`` loads (to ``spec["path"]``, written by rank 0) and goes
    on; then a second sharded problem restores the checkpoint and takes the
    remaining loads. Returns both runs' final ``u`` and stress."""
    from ..utils import load_checkpoint, load_state_dict, save_checkpoint, state_dict

    k, solve = spec["split"], spec.get("solve", {})

    def steps(problem, move, loads):
        for value in loads:
            move.value = value
            if not problem.solve(**solve)[1]:
                msg = f"load {value}: Newton did not converge"
                raise RuntimeError(msg)
            problem.update()

    problem, move = build_problem(spec, mesh.device)
    shard_problem(problem, mesh)
    steps(problem, move, spec["loads"][:k])
    state = state_dict(problem)  # a collective: every rank calls it
    if mesh.rank == 0:
        save_checkpoint(spec["path"], state)
    torch.distributed.barrier()
    steps(problem, move, spec["loads"][k:])
    restored, move2 = build_problem(spec, mesh.device)
    shard_problem(restored, mesh)
    load_state_dict(restored, load_checkpoint(spec["path"]))
    steps(restored, move2, spec["loads"][k:])
    return {"path": spec["path"], "u": problem.u.cpu(), "stress": problem.stress_0.cpu(),
            "u_restored": restored.u.cpu(), "stress_restored": restored.stress_0.cpu()}


def allreduce_run(spec, mesh) -> dict:
    """Milliseconds of one ``all_reduce`` of ``spec["numel"]`` values of
    ``spec["dtype"]`` on the rank's device, the mean of ``spec["iters"]``."""
    x = torch.ones(spec["numel"], dtype=getattr(torch, spec["dtype"]), device=mesh.device)
    for _ in range(3):
        mesh.all_reduce(x)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(spec["iters"]):
        mesh.all_reduce(x)
    _sync(mesh.device)
    return {"ms": (time.perf_counter() - t0) * 1e3 / spec["iters"]}


#: the rank programs of ``cases_rank``, by kind
_RUNS = {
    "problem": lambda spec, mesh: problem_run(spec, mesh.device, mesh),
    "pair": pair_run,
    "warm": warm_run,
    "packed_step": lambda spec, mesh: packed_step_run(spec, mesh.device, mesh),
    "checkpoint": checkpoint_run,
    "allreduce": allreduce_run,
}


def cases_rank(cases: dict, device=None) -> dict:
    """A rank's part of several sharded runs, one after the other in one
    process group: ``cases`` maps a name to ``(kind, spec)``, kind
    "problem" (``problem_run``), "warm" (``warm_run``), "pair" (``pair_run``), "packed_step"
    (``packed_step_run``), "checkpoint" (``checkpoint_run``) or "allreduce"
    (``allreduce_run``);
    ``device`` None is the rank's card.
    The rank program of ``launch.run_ranks``."""
    mesh = make_device_mesh(device=device)
    return {name: _RUNS[kind](spec, mesh) for name, (kind, spec) in cases.items()}
