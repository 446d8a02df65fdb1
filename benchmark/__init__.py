"""The serving benchmark of the PyTorch and CUDA port (``mxmoe_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Configurations, traffic mixes, cells, metric readers and kernel families
are files found by name (``core/spec.py``); the plain reference that
decides ``correct`` is under ``reference/``.
"""
