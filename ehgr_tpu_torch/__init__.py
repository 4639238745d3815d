"""ehgr_tpu_torch — the PyTorch/CUDA port of ``ehgr_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module names so each
counterpart is easy to find (``ehgr_tpu/ops/action.py`` ->
``ehgr_tpu_torch/ops/action.py``).  It imports ``torch`` only: nothing of JAX,
flax or the ``ehgr_tpu`` package, whose pure-Python pieces it copies.

Conventions:

* Public functions keep the JAX layouts: ``[N, T, H, W, C]`` into the model,
  uint8 ``[V, K, T, H, W, 3]`` into the scorer, ``[N, T, S, C]`` into the
  kernels.  Inside the model, activations are ``[N*T, C, H, W]`` in
  ``torch.channels_last``, so the kernels' ``[N, T, S, C]`` view is free.
* Entry points run on CUDA unless the caller passes ``device="cpu"``
  (``ehgr_tpu_torch.device``).
* Every Pallas kernel on the ported path is a CUDA C++ kernel for ``sm_90a``
  under ``ops/kernels``; its plain PyTorch version serves CPU tensors.
"""

__version__ = "0.1.0"
