"""Benchmark of the PyTorch and CUDA port (``dcfp_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations, traffic mixes, limits and per-layer metric
readers are files found by name under this folder.
"""
