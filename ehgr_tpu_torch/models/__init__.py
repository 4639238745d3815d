"""Models: the ResNet backbone with ACTION/TSM (L2) and the TSN task model
(L4), plus the JAX-weights converter."""
