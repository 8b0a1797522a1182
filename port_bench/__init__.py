"""The benchmark of ``musicgan_tpu_torch``, the PyTorch and CUDA port.

``python3 -m port_bench --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once (``run.py``).  Nothing here
imports the JAX package or JAX; ``reference/`` imports nothing of the
port either.
"""
