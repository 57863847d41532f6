"""The benchmark of the PyTorch/CUDA port (``repro_torch``): run one cell
with ``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout."""
