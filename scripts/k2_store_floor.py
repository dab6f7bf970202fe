"""The floor K2's field layout sets on the card: a copy kernel that, at each
flat node n of the 50^3 box, reads the 108 rows K2 reads ([108, M]) and
writes the 168 rows of the new state ([168, M]), with no arithmetic, in
three orders:

  * flat: one thread a node, blocks in the order of n (how K2 walks the
    cells);
  * bricks: each block owns an 8 x 4 x 17 brick of nodes (how a design on
    node bricks, as K1's, writes the state);
  * z-lines: each block owns 4 whole z-lines and walks 8 x-planes.

Beside them one contiguous copy of the same bytes (torch). The kernels
(``k2_store_floor.cu``) are built like the package's own. It needs one CUDA
card and nvcc (CUDA_HOME or /usr/local/cuda):

    python3 scripts/k2_store_floor.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import gated_ms, phase_device
    from fenics_constitutive_tpu_torch.ops._cuda_build import launch_check, load_library

    phase_device()
    run = load_library("k2_store_floor", Path(__file__).with_suffix(".cu")).fct_store_floor
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
    run.restype = ctypes.c_int
    n = 51
    M = n**3
    inp = torch.randn(108, M, device="cuda")
    out = torch.empty(168, M, device="cuda")
    mb = 276 * M * 4 / 1e6
    for label, brick, b in (("flat", 0, (1, 1, 1)), ("bricks 8x4x17", 1, (8, 4, 17)),
                            ("z-lines 8x4x51", 1, (8, 4, 51))):
        def call(brick=brick, b=b):
            launch_check("k2_store_floor", run(brick, inp.data_ptr(), out.data_ptr(), n, n, n, *b))

        t = gated_ms(call, 20)
        print(f"read 108 + write 168 rows of M = {M}, {label}: {t:.4f} ms, "
              f"{mb / t / 1e3:.2f} TB/s")
    x = torch.randn(138 * M, device="cuda")
    y = torch.empty_like(x)
    t = gated_ms(lambda: y.copy_(x), 20)
    print(f"one contiguous copy of the same {2 * 138 * M * 4 / 1e6:.1f} MB: {t:.4f} ms, "
          f"{2 * 138 * M * 4 / 1e9 / t:.2f} TB/s")


if __name__ == "__main__":
    main()
