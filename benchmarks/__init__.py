"""The benchmark of zignal_tpu_torch on one NVIDIA H100: ``python -m
benchmarks.run --workload CELL --seed N --seconds S --trace 0|1`` runs one
cell of ``BENCHMARK.json`` once and prints one JSON line (see run.py)."""
