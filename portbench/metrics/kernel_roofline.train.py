"""The steps' hand-written kernels (the shift's backward included): least
time over device time."""

from portbench.reading import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "train")
