"""portbench: the benchmark of ``meshdiffusion_tpu_torch`` on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
"""
