"""portbench: the benchmark of ``dompc_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` (see ``portbench/harness/bench.py``).
Nothing here imports JAX or the JAX package; ``portbench.reference``
imports nothing of the port either.
"""
