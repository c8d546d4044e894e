"""portbench: the benchmark of libhuffman_tpu_torch on an NVIDIA H100.

``BENCHMARK.json`` at the repository root names the cells; ``run.py`` runs
one.  Configurations, traffic mixes and metric readers are files found by
name under ``configs/``, ``traffic/`` and ``metrics/``; ``reference/`` holds
the plain NumPy codec that decides ``correct``.
"""
