"""The benchmark of the PyTorch and CUDA port (``repro_torch``): image
serving through the async scheduler, each configuration's model family a
module of ``families/``. ``python3 perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json``."""
