"""95th percentile of every call's time in the window, from the handoff of
the host batch to the video probabilities on the host."""

from portbench.reading import percentile_ms


def read(rec):
    return percentile_ms(rec, "serve", 95)
