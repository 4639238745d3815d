"""Clips scored in the window over the window's seconds."""

from portbench.reading import clips_per_s


def read(rec):
    return clips_per_s(rec, "serve")
