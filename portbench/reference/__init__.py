"""The benchmark's plain float32 reference: the model (``model.py``) and
the training step (``train.py``).  It imports neither JAX, the JAX package
nor the measured program."""
