"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the repository's root names its cells, configurations
and metrics; ``run.py`` runs one cell once.  The harness (`harness`) finds
each named thing under this folder by its name; the yardstick (the
traffic generator, the sublayer kinds' counts and float32 reference, the
table of peaks, the comparison that decides ``correct``) lives here too
and imports nothing of the program but the system under test
(`harness.port`).
"""
