"""The paper's 13 workloads, each with a hybrid variant.

Every module exposes ``run_hybrid(executor, ...) -> WorkSharedOutput``
plus its input generator, which makes the same numpy inputs from the
same seed as the reference's.  Work sharing / task parallelism follows
Table 1's per-workload solution methodology.
"""

ALL_WORKLOADS = ["sort", "hist", "spmv", "spgemm", "raycast", "bilateral",
                 "conv", "montecarlo", "listrank", "concomp", "lbm",
                 "dither", "bundle"]
