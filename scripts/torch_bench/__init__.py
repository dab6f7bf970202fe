"""The bench layer of the PyTorch/CUDA port: twins of ``bench.py`` and the
JAX package's ``scripts/bench_*.py`` and ``scripts/roofline.py`` that import
``torch`` and the port, never ``jax``. Each prints one JSON line."""
