"""The benchmark of mamba_tpu_torch on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Cells,
configurations and metrics are named in ``BENCHMARK.json`` at the root of
the checkout; each has files of its own here, found by that name
(``manifest.py``).  Nothing here imports JAX or the JAX package.
"""
