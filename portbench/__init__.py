"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` on one CUDA card,
through the server its configuration's kind names (``servers/``), and
prints one JSON result line.  What belongs to one configuration, kind,
server, traffic kind, cell or metric sits in a file of its own
(``configs/``, ``kinds/``, ``servers/``, ``traffic/``, ``cells/``,
``metrics/``), found by name; ``yardstick/`` and ``reference/`` hold the
benchmark's own arithmetic and plain references, which import nothing of
the port.
"""
