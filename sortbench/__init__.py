"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of FractalSort.

``sortbench/run.py`` runs one cell of ``BENCHMARK.json``; everything a
cell needs is found by name under ``configs/``, ``datagen/``,
``requests/``, ``traffic/`` and ``metrics/``.  ``reference/`` is the plain
reference that decides ``correct``; it imports nothing of ``repro_torch``.
"""
