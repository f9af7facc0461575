"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through the port's
async gateway on one CUDA card and prints one JSON result line.  What
belongs to one configuration, traffic kind, cell or metric sits in a file
of its own (``configs/``, ``traffic/``, ``cells/``, ``metrics/``), found
by name; ``yardstick/`` and ``reference/`` hold the benchmark's own
arithmetic and plain references, which import nothing of the port.
"""
