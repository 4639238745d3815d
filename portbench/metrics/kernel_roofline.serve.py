"""The served calls' hand-written kernels: least time over device time."""

from portbench.reading import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "serve")
