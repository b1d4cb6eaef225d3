"""The benchmark of ``socialways_torch`` on one NVIDIA H100: a harness
driven by data (``BENCHMARK.json`` names the cells; each configuration,
traffic mix, set of limits and per-layer metric is a file of its own
here), the frozen yardstick (``bounds``, ``flops``, ``trace``) and the
plain reference (``reference/``).  ``run.py`` runs one cell once."""
