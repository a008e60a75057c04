#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on this machine's card(s):

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's checks on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and ``checks``. Exits with a non-zero code, printing no result,
when the card(s) the cell needs are missing.
"""
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place in the checkout
CACHE = os.path.join(ROOT, "perfbench", ".cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
# the checkout's root and the port's sources, not this script's folder
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
