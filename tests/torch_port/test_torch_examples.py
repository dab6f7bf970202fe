"""The port's examples (examples/torch/<name>/run_example.py) against the JAX
package's (examples/<name>/run_example.py), on the CPU in float64.

* Each twin runs as a user runs it, in a subprocess (``--device cpu``), and
  exits 0 through its own asserts.
* Each JAX example's ``main`` runs in this process with its stdout captured,
  and the twin's ``main(device="cpu")`` returns the numbers it prints. Every
  printed number is held to JAX's: within 1e-8 relative where JAX prints a
  float in full, else equal at the digits JAX prints (within half a unit
  of its last digit). Iteration counts are equal, except that a Newton count
  may differ by one in a step that starts from a plastic state: there
  round-off decides the first tangent, in both packages. The printed text
  around the numbers is the same. Files the examples write (the creep
  history at 9 decimals, the last ParaView step at 17 digits) are held to
  JAX's the same way.
* The creep twin also runs at 6^3 with the V-cycle and its fused smoothing
  (the plain twins on the CPU), the configuration the card runs at 50^3,
  and meets the closed-form bars there.
"""

import importlib.util
import inspect
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
#: twin -> the JAX example it mirrors
TWINS = {
    "creep_neumann": "creep_neumann",
    "plasticity_demo": "plasticity_demo",
    "custom_torch_model": "custom_jax_model",
    "elasticity_cpp": "elasticity_cpp",
    "mises_c": "mises_c",
}
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name):
    return _load(REPO / "examples" / "torch" / name / "run_example.py", f"twin_{name}")


def _close(value: float, printed: str) -> bool:
    """``value`` equals the number JAX printed: within 1e-8 relative when it
    was printed in full (12 significant digits or more), else within half a
    unit of its last printed digit."""
    ref = float(printed)
    digits = len(printed.lstrip("+-").replace(".", "").lstrip("0"))
    if digits >= 12:
        return abs(value - ref) <= 1e-8 * abs(ref)
    decimals = len(printed.split(".")[1]) if "." in printed else 0
    return abs(value - ref) <= 0.5 * 10.0**-decimals * (1 + 1e-9)


def _skeleton(text: str, *dirs) -> list:
    for d in dirs:
        text = text.replace(str(d), "<out>")
    return [NUMBER.sub("#", ln) for ln in text.splitlines()]


def _run_pair(name, tmp_path, capsys):
    """(JAX stdout, twin result, twin stdout, JAX out dir, twin out dir)."""
    jax_main = _load(REPO / "examples" / TWINS[name] / "run_example.py", f"jax_{name}").main
    twin_main = _twin(name).main
    jdir, tdir = tmp_path / "jax", tmp_path / "twin"
    capsys.readouterr()
    if "out_dir" in inspect.signature(jax_main).parameters:
        jax_main(str(jdir))
        jax_out = capsys.readouterr().out
        result = twin_main(str(tdir), device="cpu")
    else:
        jax_main()
        jax_out = capsys.readouterr().out
        result = twin_main(device="cpu")
    twin_out = capsys.readouterr().out
    assert _skeleton(twin_out, tdir) == _skeleton(jax_out, jdir)
    return jax_out, result, twin_out, jdir, tdir


def _step_rows(out: str, pattern: str) -> list:
    rows = [m.groupdict() for m in re.finditer(pattern, out)]
    assert rows
    return rows


def _agree(value: float, jax_printed: str, twin_printed: str) -> bool:
    """The twin's value is JAX's printed number, and the twin printed it."""
    return _close(value, jax_printed) and _close(value, twin_printed)


def _newton_counts_agree(twin: list, jax: list, plastic_before: list) -> None:
    for k, (a, b, plastic) in enumerate(zip(twin, jax, plastic_before)):
        assert abs(a - b) <= (1 if plastic else 0), (k, twin, jax)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_as_documented(name, tmp_path):
    script = REPO / "examples" / "torch" / name / "run_example.py"
    res = subprocess.run(
        [sys.executable, str(script), str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip()


def test_creep_neumann(tmp_path, capsys):
    jax_out, r, twin_out, jdir, tdir = _run_pair("creep_neumann", tmp_path, capsys)
    (instant, creep), (t_instant, t_creep) = (re.findall(r"strain (\S+)", out)
                                              for out in (jax_out, twin_out))
    assert _agree(r["instant_strain"], instant, t_instant)
    assert _agree(r["creep_strain"], creep, t_creep)
    # the history file carries 9 decimals
    jrows = (jdir / "creep_history.csv").read_text().splitlines()
    trows = (tdir / "creep_history.csv").read_text().splitlines()
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 3
    for t_row, j_row in zip(trows[1:], jrows[1:]):
        (t_t, t_eps), (j_t, j_eps) = t_row.split(","), j_row.split(",")
        assert t_t == j_t
        assert _close(float(t_eps), j_eps)
    assert r["instant_newton"] >= 1 and len(r["creep_newton"]) == 40


def test_plasticity_demo(tmp_path, capsys):
    from fenics_constitutive_tpu_torch.fem import read_vtu

    jax_out, r, twin_out, jdir, tdir = _run_pair("plasticity_demo", tmp_path, capsys)
    pattern = (r"disp=(?P<disp>\S+) iters=(?P<iters>\d+) "
               r"converged=(?P<converged>\w+) max_mises=\s*(?P<max_mises>\S+)")
    rows, t_rows = _step_rows(jax_out, pattern), _step_rows(twin_out, pattern)
    steps = r["steps"]
    assert len(steps) == len(rows) == len(t_rows) == 12
    for s, j, t in zip(steps, rows, t_rows):
        assert str(s["converged"]) == j["converged"] == t["converged"]
        assert str(s["iters"]) == t["iters"]
        assert all(_agree(s[k], j[k], t[k]) for k in ("disp", "max_mises"))
    # the matrix yields at p_y0 = 1200
    plastic_before = [False] + [s["max_mises"] > 1200.0 for s in steps[:-1]]
    _newton_counts_agree([s["iters"] for s in steps], [int(j["iters"]) for j in rows],
                         plastic_before)
    # the last ParaView step, 17 significant digits
    _, jp, jc = read_vtu(jdir / "plasticity_demo_000011.vtu")
    _, tp, tc = read_vtu(tdir / "plasticity_demo_000011.vtu")
    for a, b in ((tp["u"], jp["u"]), (tc["mises"], jc["mises"]),
                 (tc["sigma_xx"], jc["sigma_xx"]), (tc["material"], jc["material"])):
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()


@pytest.mark.parametrize("name", ["custom_torch_model", "elasticity_cpp"])
def test_elastic_twins(name, tmp_path, capsys):
    jax_out, r, twin_out, _, _ = _run_pair(name, tmp_path, capsys)

    def printed(pattern):
        return [re.search(pattern, out).group(1) for out in (jax_out, twin_out)]

    assert [str(r["iters"])] * 2 == printed(r"in (\d+) (?:Newton )?iterations")
    assert [str(r["converged"])] * 2 == printed(r"converged=(\w+)")
    assert _agree(r["mean_sigma_xx"], *printed(r"mean sigma_xx = (\S+)"))
    if name == "elasticity_cpp":
        assert _agree(r["max_u"], *printed(r"max \|u\| = (\S+)"))


def test_mises_c(tmp_path, capsys):
    jax_out, r, twin_out, _, _ = _run_pair("mises_c", tmp_path, capsys)
    pattern = (r"disp=(?P<disp>\S+) iters=(?P<iters>\d+) "
               r"converged=(?P<converged>\w+) sigma_xx=\s*(?P<sigma_xx>\S+) "
               r"alpha_max=(?P<alpha_max>\S+)")
    rows, t_rows = _step_rows(jax_out, pattern), _step_rows(twin_out, pattern)
    steps = r["steps"]
    assert len(steps) == len(rows) == len(t_rows) == 10
    for s, j, t in zip(steps, rows, t_rows):
        assert str(s["converged"]) == j["converged"] == t["converged"]
        assert str(s["iters"]) == t["iters"]
        assert all(_agree(s[k], j[k], t[k]) for k in ("disp", "sigma_xx", "alpha_max"))
    plastic_before = [False] + [s["alpha_max"] > 0.0 for s in steps[:-1]]
    _newton_counts_agree([s["iters"] for s in steps], [int(j["iters"]) for j in rows],
                         plastic_before)


def test_creep_vcycle_closed_form(tmp_path, capsys):
    """The card's full-width configuration at 6^3 on the CPU: the V-cycle
    with fused smoothing (plain twins here), the creep split into timed
    windows; the closed-form bars hold, and every creep step converges."""
    from fenics_constitutive_tpu_torch.ops import cuda_matvec, cuda_smoother

    mod = _twin("creep_neumann")
    k1, k3 = cuda_matvec.launches, cuda_smoother.launches
    r = mod.main(str(tmp_path), device="cpu", n=6, windows=5, preconditioner="vcycle",
                 mg_options={"fused_smoothing": True})
    capsys.readouterr()
    sim = r["simulation"]
    assert sim.preconditioner == "vcycle" and sim._mg.fused is not None
    assert abs(r["instant_strain"] - mod.SIGMA / mod.E0) < 1e-8
    assert abs(r["creep_strain"] - (mod.SIGMA / mod.E0 + mod.SIGMA / mod.E1)) < 1e-6
    assert len(r["creep_newton"]) == 40 and len(r["window_ms_per_step"]) == 5
    # the plain twins ran: no kernel launches off the card
    assert (cuda_matvec.launches, cuda_smoother.launches) == (k1, k3)
    assert sim.state.u.dtype == torch.float64 and sim.state.u.device.type == "cpu"
    with pytest.raises(ValueError, match="divide"):
        mod.main(str(tmp_path), device="cpu", windows=3)


def test_example_builds_raise_and_copies_are_new(tmp_path):
    """The examples' native build raises when its compiler fails or is
    missing (no fallback), and host_copy never hands C code a view."""
    from fenics_constitutive_tpu_torch.native import (
        build_shared_library,
        device_copy,
        host_copy,
    )

    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="building libbad.so failed"):
        build_shared_library([bad], "libbad.so", compiler="gcc")
    with pytest.raises(RuntimeError, match="not on PATH"):
        build_shared_library([bad], "libbad.so", compiler="no-such-compiler-cc")

    t = torch.arange(6.0, dtype=torch.float64).reshape(2, 3).T  # a strided view
    a = host_copy(t)
    a[:] = -1.0
    assert a.flags.c_contiguous and a.shape == (6,)
    assert torch.equal(t, torch.arange(6.0, dtype=torch.float64).reshape(2, 3).T)
    back = device_copy(a, torch.zeros(1, dtype=torch.float32))
    assert back.dtype == torch.float32 and back.device.type == "cpu"
