"""Evaluation: the multi-clip inference protocol and its metrics."""
