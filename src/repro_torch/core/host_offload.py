"""Task-parallel host offload (the paper's Bilat-LUT / LR-PRNG trick).

The paper's most effective task-parallel designs move work the
accelerator is bad at onto the CPU and overlap it: transcendental LUTs
(Bilat §4.6), pseudorandom streams (LR/MC §4.7-4.8).  Their analogues
beyond the paper: RoPE/sin-cos tables, bilateral/range LUTs, host PRNG
streams for data augmentation, batch assembly, and checkpoint
serialization.

``HostTaskPool`` runs those on host threads.

numpy only: a copy of the part of the reference's module that the
ported workloads use (the port imports nothing of the reference),
bit-identical in what it computes.  The double-buffered prefetch comes
with the training slice that uses it.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np


class HostTaskPool:
    """Named async host tasks with simple timing telemetry."""

    def __init__(self, max_workers: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="host-task")
        self.timings: Dict[str, float] = {}

    def submit(self, name: str, fn: Callable, *args, **kw) -> Future:
        def timed():
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.timings[name] = time.perf_counter() - t0
            return out

        return self._pool.submit(timed)

    def shutdown(self):
        self._pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# LUT precompute (paper §4.6): transcendental tables built on the host
# ---------------------------------------------------------------------------
def bilateral_luts(sigma_s: float, sigma_r: float, radius: int,
                   n_intensity: int = 256):
    """Spatial + range Gaussian LUTs: (2r+1, 2r+1) and (n_intensity,).
    Exactly the paper's observation: only (2r+1)^2 + 256 transcendental
    evaluations are ever needed."""
    ax = np.arange(-radius, radius + 1, dtype=np.float32)
    d2 = ax[:, None] ** 2 + ax[None, :] ** 2
    spatial = np.exp(-d2 / (2 * sigma_s ** 2)).astype(np.float32)
    dr = np.arange(n_intensity, dtype=np.float32)
    rng = np.exp(-(dr ** 2) / (2 * sigma_r ** 2)).astype(np.float32)
    return spatial, rng


def host_prng_stream(seed: int, n: int, dtype=np.float32) -> np.ndarray:
    """Pseudorandom stream generated on the host (paper §4.7/§4.8: the
    CPU generates randomness, the accelerator consumes it)."""
    return np.random.default_rng(seed).random(n, dtype=dtype)
