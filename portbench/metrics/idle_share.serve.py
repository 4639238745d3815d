"""Share of the profiled calls' stretch with nothing running on the card."""

from portbench.reading import idle_share


def read(rec):
    return idle_share(rec, "serve")
