"""The benchmark of the PyTorch/H100 port (``values_tpu_torch``): see
``run.py`` for one run of one cell, ``harness.py`` for how cells,
configurations, traffic and metrics are found by name."""
