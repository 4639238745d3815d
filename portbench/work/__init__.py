"""The benchmark's yardsticks of work: the FLOPs of a call or a step
counted over the reference (``flops.py``), and each hand-written kernel's
bytes, operations and least time at the card's peaks (``kernels.py``)."""
