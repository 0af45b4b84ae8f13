"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. The harness is driven by data: a cell
names a configuration (``configs/<name>.json``, which names its driver in
``drivers/``) and a traffic mix (``mixes/<name>.json``); each metric has a
reader in ``metrics/``. The yardstick -- traffic generation, the register
recipe, the work counts, the peaks, the trace reduction and the plain
reference that decides ``correct`` -- lives here, never in the program.
"""
