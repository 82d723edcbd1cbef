"""The benchmark's yardstick: cell lookup, traffic, the serving window,
the trace reduction, the operation counts and the correctness check.

Nothing here imports the JAX package or JAX; the program under test
(``repro_torch``) is imported only inside the functions that drive it.
"""
