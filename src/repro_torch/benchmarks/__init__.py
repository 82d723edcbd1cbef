"""The paper's experiments run by the port: Table 2 and Figs. 3-4 and
the §5.4.3 split sweep, each ``python -m repro_torch.benchmarks.<name>``
on the first GPU (raising without one), or ``run(device="cpu")`` from
Python on the CPU's simulated pair."""
