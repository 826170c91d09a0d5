"""The benchmark's own library: the cell files' loader, the data and
traffic generators, the plain reference, the comparison that decides
``correct``, the roofline arithmetic and the trace reduction.

Nothing here imports the JAX package, and ``reference`` imports nothing of
the program under test (``approximatenn_tpu_torch``).
"""
