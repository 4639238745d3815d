"""The reference's FLOPs of a step (forward and backward) times the
window's steps a second, over the H100's dense bf16 peak."""

from portbench.reading import mfu


def read(rec):
    return mfu(rec, "train")
