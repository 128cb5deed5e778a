"""The benchmark of the PyTorch and CUDA port of DAD-3DHeads
(``dad3dheads_tpu_torch``) on NVIDIA H100 cards:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are files of
their own, found by the names in ``BENCHMARK.json``."""
