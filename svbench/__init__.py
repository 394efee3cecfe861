"""svbench: the benchmark of breakmer_tpu_torch on one card.

One command runs one cell once (``python3 -m svbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``). Configurations, traffic mixes,
per-layer metric readers and roofline counters are files found by name
under ``configs/``, ``traffic/``, ``metrics/`` and ``roofline/``.
"""
