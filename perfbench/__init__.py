"""The benchmark of the PyTorch and CUDA port (``repro_torch``): DiT-XL/2
image serving through the async scheduler. ``python3 perfbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json``."""
