"""Multi-process runs over ``torch.distributed`` (counterpart of
``ehgr_tpu/parallel``): data parallelism over clips with global BN
statistics, and optional tensor-parallel classifier heads, one process a
rank on a ``(data, model)`` grid (``parallel/mesh.py``)."""
