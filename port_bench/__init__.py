"""The benchmark of ``self_attention_tacotron_torch`` on one NVIDIA H100.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See README.md.
"""
