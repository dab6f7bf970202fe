"""Execute docs/torch/basic_usage.ipynb (the PyTorch port's tutorial) and
store its outputs.

The notebook's cell tagged ``parameters`` puts it on the card, so run this
on a machine with one:

    python scripts/execute_torch_notebook.py [OUT.ipynb]

It rewrites the notebook in place, or writes the executed copy to OUT.ipynb.
Cells are run by ``execute`` of scripts/execute_notebook.py (stdlib exec in
one namespace, stdout captured as stream outputs; no jupyter needed).
tests/torch_port/test_torch_docs.py re-executes it on the CPU with the
``parameters`` cell swapped.
"""

from __future__ import annotations

import json
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT / "scripts"))

from execute_notebook import execute  # noqa: E402

NB = _ROOT / "docs/torch/basic_usage.ipynb"


def main() -> None:
    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else NB
    nb = execute(json.loads(NB.read_text()))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(nb, indent=1, ensure_ascii=False) + "\n")
    n_out = sum(1 for c in nb["cells"] if c["cell_type"] == "code" and c.get("outputs"))
    print(f"executed {NB.name} -> {out}: {n_out} code cells with captured output")


if __name__ == "__main__":
    main()
