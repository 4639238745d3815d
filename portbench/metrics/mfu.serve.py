"""The reference's FLOPs of a call times the window's calls a second, over
the H100's dense bf16 peak."""

from portbench.reading import mfu


def read(rec):
    return mfu(rec, "serve")
