"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
a wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""
