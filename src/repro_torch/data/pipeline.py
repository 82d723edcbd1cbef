"""Data pipeline: deterministic synthetic LM stream + host prefetch.

Design points for 1000-node scale:
  * **Deterministic sharding** — every (step, group) pair maps to a
    disjoint slice of the stream via splittable counters, so restart /
    elastic re-planning never duplicates or drops samples.
  * **Work-shared sampling** — a slow device group gets fewer
    micro-batches per step; the sampler hands out batches by *work unit
    index*, not by group, so re-planning shares is free (paper §4.1
    adaptation).
  * **Host prefetch** — batches are assembled on the host and
    double-buffered against device compute (task parallelism, Fig 2(b)).

numpy only, a copy of the reference's module: batch ``i`` is the same
bits in both.  The trainer moves a batch to its parameters' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.host_offload import DoubleBuffer


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    micro_batch: int              # sequences per micro-batch (work unit)
    seed: int = 0
    kind: str = "synthetic"       # synthetic | zipf | file
    path: Optional[str] = None    # token file (np.uint32 memmap) for "file"


class TokenStream:
    """Deterministic stream of (tokens, labels) micro-batches.

    Batch ``i`` is a pure function of (seed, i): restartable, shardable,
    and identical regardless of which device group consumes it.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._file = None
        if cfg.kind == "file":
            self._file = np.memmap(cfg.path, dtype=np.uint32, mode="r")

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        if c.kind == "file":
            n_tok = c.micro_batch * (c.seq_len + 1)
            start = (index * n_tok) % max(len(self._file) - n_tok, 1)
            flat = np.asarray(self._file[start:start + n_tok], np.int32)
            chunk = flat.reshape(c.micro_batch, c.seq_len + 1)
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([c.seed, index]))
            if c.kind == "zipf":
                z = rng.zipf(1.3, size=(c.micro_batch, c.seq_len + 1))
                chunk = np.minimum(z, c.vocab_size - 1).astype(np.int32)
            else:
                chunk = rng.integers(
                    0, c.vocab_size, (c.micro_batch, c.seq_len + 1),
                    dtype=np.int32)
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}

    def iter_from(self, start_index: int) -> Iterator[Dict[str, np.ndarray]]:
        i = start_index
        while True:
            yield self.batch(i)
            i += 1

    def prefetched(self, start_index: int, depth: int = 2):
        """Host-prefetched iterator (overlapped with device compute)."""
        return DoubleBuffer(self.iter_from(start_index), depth=depth)


def global_batch_indices(step: int, accum_units: int, unit_offset: int,
                         n_units: int) -> range:
    """Work units [unit_offset, unit_offset + n_units) of global step
    ``step`` with ``accum_units`` total units per step.  Device groups
    get disjoint contiguous ranges; re-planning shares only moves the
    offsets."""
    base = step * accum_units
    return range(base + unit_offset, base + unit_offset + n_units)
