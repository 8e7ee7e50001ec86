"""The benchmark of the PyTorch/CUDA port (``xsdeepfwfm_deprecated_torch``):
``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
