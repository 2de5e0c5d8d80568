"""The benchmark of the PyTorch and CUDA port (``dyffusion_tpu_torch``).

``BENCHMARK.json`` at the repository's root lists its configurations,
cells and metrics; ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once. It imports only the
port, torch, numpy and the standard library.
"""
