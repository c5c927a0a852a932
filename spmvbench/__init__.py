"""spmvbench — the benchmark of hispmv_tpu_torch on one CUDA card.

One run of one cell::

    python3 spmvbench/run.py --workload flan1565.power --seed 7 \\
        --seconds 10 --trace 0

prints one JSON line: whether the window's answers agree with the float64
reference, the cell's end-to-end metrics (``--trace 0``) or per-layer
metrics (``--trace 1``), the card, and each number compared beside its
limit.  The cells, configurations, traffic mixes and metrics are data:
see ``manifest.py``.  Nothing here imports jax or hispmv_tpu, and the
reference (``reference.py``) imports nothing of the program.
"""
