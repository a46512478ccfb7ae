"""The benchmark of weasal_tpu_torch, the PyTorch and CUDA port: one cell
(a configuration under a traffic mix) run once by `python3 -m
portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout, as BENCHMARK.json names them."""
