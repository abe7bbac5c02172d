"""The benchmark of ``acr_tpu_torch`` on one NVIDIA card.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: its configuration
(``configs/``), the architecture that configuration names (``archs/``),
its traffic mix (``traffic/``) and its metrics (``metrics/``), each
found by name. ``reference/`` is the frozen plain reference that decides
``correct``; it imports nothing of the program.
"""
