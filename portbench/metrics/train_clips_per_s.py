"""Clips trained in the window over its seconds; the window ends with the
last step's loss on the host."""

from portbench.reading import clips_per_s


def read(rec):
    return clips_per_s(rec, "train")
