"""The benchmark of the PyTorch/CUDA port: one run of one cell of
``BENCHMARK.json`` (see :mod:`perfbench.harness` and ``README.md``)."""
