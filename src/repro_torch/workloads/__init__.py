"""The paper's 13 workloads, each with a hybrid variant.

Every module exposes ``run_hybrid(executor, ...) -> WorkSharedOutput``
plus its input generator, which makes the same numpy inputs from the
same seed as the reference's.  Work sharing / task parallelism follows
Table 1's per-workload solution methodology.
"""

ALL_WORKLOADS = ["sort", "hist", "spmv", "spgemm", "raycast", "bilateral",
                 "conv", "montecarlo", "listrank", "concomp", "lbm",
                 "dither", "bundle"]


def tuned_per_device(placed, resolve):
    """Each group's tuned config, resolved once per device (a simulated
    pair, both groups on one device, resolves once): ``placed`` maps a
    group to its inputs (a tensor, or a tuple whose first tensor names
    the device) and ``resolve(inputs)`` returns the config.  Called in
    a call's set-up, so the search stays out of the calibrated and
    timed paths."""
    by_dev, cfgs = {}, {}
    for name, inputs in placed.items():
        dev = (inputs[0] if isinstance(inputs, tuple) else inputs).device
        if dev not in by_dev:
            by_dev[dev] = resolve(inputs)
        cfgs[name] = by_dev[dev]
    return cfgs
