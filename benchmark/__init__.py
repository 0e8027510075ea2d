"""The port's benchmark (vktf_tpu_torch on one NVIDIA card).

``run.py`` is the entry point; every cell, configuration, traffic mix and
per-layer metric is a file found by the name ``BENCHMARK.json`` gives it.
Nothing here imports jax or the JAX package.
"""
