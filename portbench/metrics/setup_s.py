"""From the process's start to the first timed call: the program's and the
reference's set-up, weights, BN statistics, kernel builds and warm-up."""


def read(rec):
    return rec.get("setup_s")
