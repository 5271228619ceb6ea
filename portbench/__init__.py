"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``); see ``README.md``.
Importing this package imports neither torch nor the program.
"""
