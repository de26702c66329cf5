"""The benchmark of the PyTorch and CUDA port (``imagestitching_tpu_torch``).

Run one cell with ``python3 stitchbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
lists the cells.  Nothing here imports JAX or the JAX package
(``imagestitching_tpu``); the reference (``reference/``) imports nothing of
the port either.
"""
