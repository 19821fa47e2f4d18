"""The benchmark of tomojax_torch on one NVIDIA H100: whole reconstruction
jobs and live tilt updates through the port's public API, checked against
a plain reference. ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the
repository's root names the cells and metrics."""
