"""Hand-written CUDA kernels of the port (sources under ``csrc/``), their
build and ctypes binding (``build.py``) and their wrappers, each beside its
plain PyTorch version."""
