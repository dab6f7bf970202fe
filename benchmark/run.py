"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``) is a configuration under a traffic mix. The run
builds the configuration through ``PackedSimulation`` on the card, warms it
up, steps its load path through ``solve()`` for ``--seconds`` seconds, and
judges the answers against the plain reference in ``benchmark/reference/``.
The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (load steps, and those that did not converge),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared`` (each number of the comparison with its limit), which the last
lines of standard error repeat.

Without a CUDA card (or with fewer than the cell asks for) the run exits 2
and prints no result; it exits 3 if ``jax``, ``jaxlib``, ``flax`` or the JAX
package was loaded. ``--device cpu`` and ``--cells-per-edge`` serve the
tests (the kernels' plain versions on a small mesh); ``--control`` runs the
configuration's control, the program in the next lower precision (float32
at the port's own float32 Newton tolerances), which the comparison has to
fail.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="'cpu' for the tests")
    ap.add_argument("--cells-per-edge", type=int, default=None,
                    help="a smaller mesh than the configuration's (the tests)")
    ap.add_argument("--control", action="store_true",
                    help="run the program in the configuration's lower control precision")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                           device=args.device, n=args.cells_per_edge,
                           control=args.control)
    except harness.RunError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
