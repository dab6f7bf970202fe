"""The port's documentation (docs/torch/) is executed and executable.

* The tutorial notebook docs/torch/basic_usage.ipynb ships with the outputs
  of a run on the card (execution counts, stream outputs, a first output
  that names a CUDA device), and re-executes on the CPU through
  scripts/execute_notebook.py's ``execute`` with its one ``parameters``
  cell swapped. The physics bar is the JAX notebook test's (max
  ``stress_path`` between 2400 and 2500); the printed stress path equals the
  JAX notebook's committed one at its printed digits, and the
  PackedSimulation result is within 1e-8 of JAX's.
* Every ``python`` block of a page under docs/torch/ runs on the CPU, the
  blocks of one page in one namespace in order, with the page's one
  ``device = torch.device("cuda")`` line swapped.
* Every name that docs/torch/api.md lists resolves in the port.
"""

import importlib
import json
import pathlib
import re

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
DOCS = REPO / "docs" / "torch"
NB = DOCS / "basic_usage.ipynb"
JAX_NB = REPO / "docs" / "getting_started" / "basic_usage.ipynb"
DEVICE_LINE = 'device = torch.device("cuda")'
CPU_PARAMETERS = 'import torch\n\ndevice = torch.device("cpu")\ndtype = torch.float64\n'
BLOCK = re.compile(r"^```python\n(.*?)^```", re.S | re.M)
PAGES = sorted(p.relative_to(DOCS).as_posix() for p in DOCS.rglob("*.md"))
PAGES_WITH_CODE = [p for p in PAGES if BLOCK.search((DOCS / p).read_text())]


def _code_cells(nb):
    return [c for c in nb["cells"] if c["cell_type"] == "code"]


def _text(cell) -> str:
    return "".join("".join(o.get("text", [])) for o in cell.get("outputs", [])
                   if o.get("output_type") == "stream")


def test_notebook_ships_executed_on_the_card():
    cells = _code_cells(json.loads(NB.read_text()))
    assert all(c.get("execution_count") for c in cells), (
        "code cells missing execution counts: run scripts/execute_torch_notebook.py on the card"
    )
    printing = [c for c in cells if "print(" in "".join(c["source"])]
    assert len(printing) >= 3
    assert all(_text(c) for c in printing), "a printing cell has no captured output"
    first = _text(cells[0])
    assert "parameters" in cells[0]["metadata"].get("tags", [])
    assert re.match(r"device cuda(:\d+)?: \S", first), first


def test_notebook_executes_on_the_cpu():
    import importlib.util

    spec = importlib.util.spec_from_file_location("execute_notebook",
                                                  REPO / "scripts" / "execute_notebook.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    nb = json.loads(NB.read_text())
    params = [c for c in _code_cells(nb) if "parameters" in c["metadata"].get("tags", [])]
    assert len(params) == 1
    assert DEVICE_LINE in "".join(params[0]["source"])
    params[0]["source"] = CPU_PARAMETERS.splitlines(keepends=True)
    out = "".join(_text(c) for c in _code_cells(mod.execute(nb)))

    # the tutorial's physics: exponential hardening saturates toward p_y00
    path = [float(v) for v in re.findall(r"max sigma_xx=\s*(\S+)", out)]
    final = float(re.search(r"final max sigma_xx = ([\d.]+)", out).group(1))
    assert 2400.0 < max([*path, final]) < 2500.0

    jax_out = "".join(_text(c) for c in _code_cells(json.loads(JAX_NB.read_text())))
    assert re.findall(r"u=\S+\s+max sigma_xx=\s*\S+", out) == re.findall(
        r"u=\S+\s+max sigma_xx=\s*\S+", jax_out)
    sim_max, jax_sim_max = (float(re.search(r"\| max sigma_xx: (\S+)", s).group(1))
                            for s in (out, jax_out))
    assert abs(sim_max - jax_sim_max) <= 1e-8 * abs(jax_sim_max)
    assert "all steps converged: True" in out


def test_pages_with_code():
    assert set(PAGES_WITH_CODE) >= {
        "index.md", "getting_started.md", "api.md", "parallel.md",
        "custom_models/torch.md", "custom_models/cpp.md", "custom_models/umat.md",
    }
    assert "performance.md" in PAGES


@pytest.mark.parametrize("page", PAGES_WITH_CODE)
def test_page_runs_on_the_cpu(page, tmp_path, monkeypatch, capsys):
    text = (DOCS / page).read_text()
    assert text.count(DEVICE_LINE) == 1, f"{page} must set the device in one line"
    src = "\n".join(BLOCK.findall(text))
    assert DEVICE_LINE in src
    monkeypatch.chdir(tmp_path)
    ns: dict = {}
    exec(compile(src.replace(DEVICE_LINE, 'device = torch.device("cpu")'), page, "exec"), ns)
    assert ns["device"] == torch.device("cpu")
    assert capsys.readouterr().out.strip(), f"{page} prints nothing"


def _resolve(module: str, dotted: str):
    """``module.dotted``: the longest importable module prefix, then attributes
    (AttributeError where a name is missing)."""
    parts = dotted.split(".")
    for k in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(".".join([module, *parts[:k]]))
        except ModuleNotFoundError:
            continue
        for part in parts[k:]:
            obj = getattr(obj, part)
        return obj
    raise ModuleNotFoundError(module)


def test_api_names_resolve():
    module, names = None, []
    for line in (DOCS / "api.md").read_text().splitlines():
        head = re.match(r"## `(fenics_constitutive_tpu_torch[\w.]*)`", line)
        if head:
            module = head.group(1)
            importlib.import_module(module)
            continue
        row = re.match(r"\| `([\w.]+)` \|", line)
        if row:
            assert module is not None, line
            _resolve(module, row.group(1))
            names.append(f"{module}.{row.group(1)}")
    assert len(names) > 80
    assert "fenics_constitutive_tpu_torch.solver.PackedSimulation" in names
