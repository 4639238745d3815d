"""Temporal ops, the ACTION module and the hand-written CUDA kernels."""
