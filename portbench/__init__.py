"""The benchmark of the PyTorch and CUDA port (``transmil_deepgraft_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Configurations (``configs/``), traffic mixes (``traffic/``) and
per-layer metrics (``metrics/``) are files of their own, found by the names
in ``BENCHMARK.json``; ``runners/`` hold the code that drives each kind of
entry point, ``reference/`` the plain reference and ``costs/`` the
operation counts and the peak rule.
"""
