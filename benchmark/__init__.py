"""The benchmark of ``ray_tpu_torch`` on NVIDIA GPUs.

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs
is found by name under this folder: its model configuration in
``configs/``, its traffic mix in ``traffic/``, its correctness limits in
``limits/`` and one reader per metric in ``metrics/``.  ``reference/``
is a plain float32 GPT-2 that imports nothing of the program, and
``costs.py`` holds the frozen operation and byte counts and the peaks.
"""
