"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``portbench/run.py``), and everything that
belongs to a configuration, traffic mix, cell or per-layer metric is a
file of its own that the harness finds by name (``manifest.py``)."""
