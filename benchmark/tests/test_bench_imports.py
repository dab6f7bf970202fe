"""No file of the benchmark imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

import ast

import pytest

from benchmark import harness

BENCH = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fenics_constitutive_tpu"}
PORT = "fenics_constitutive_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert PORT not in path.read_text()


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import fenics_constitutive_tpu_torch.solver\nfrom jaxtyping import x\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("from fenics_constitutive_tpu.solver import y\n")
    assert top_level_imports(f) & FORBIDDEN
