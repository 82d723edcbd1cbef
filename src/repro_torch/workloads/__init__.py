"""The paper's workloads ported so far, each with a hybrid variant.

Every module exposes ``run_hybrid(executor, ...) -> WorkSharedOutput``
plus its input generator, which makes the same numpy inputs from the
same seed as the reference's.
"""

PORTED_WORKLOADS = ["hist", "spmv", "conv", "sort", "bilateral"]
