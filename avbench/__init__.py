"""The benchmark of `libav_tpu_torch`, the PyTorch and CUDA port.

`python3 avbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json` once and prints
one JSON line. See README.md for the layout that later cells add files to.
"""
