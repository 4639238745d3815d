"""The benchmark of ``ehgr_tpu_torch`` on an NVIDIA H100.

One run of one cell: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.  The cells,
configurations and metrics are named in ``BENCHMARK.json``; each is a file
of its own here, found by its name (``harness.py``).
"""
