"""graphbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once: ``python graphbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``.  See ``README.md``.
"""
