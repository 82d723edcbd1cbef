"""The one traffic generator: every mix is a data file of parameters
(``bench/traffic/<name>.json``) read here.

Open loop (``"loop": "open"``): ``round(rate_rps * seconds)`` requests
due in the window.  The gaps between them are the exponential
distribution's quantiles at ``(i + 0.5) / n`` for the cell's rate,
scaled so that they fill the window exactly, in one shuffled order
that is the same for every seed: every seed offers the same arrivals,
and the seed changes only the prompts and the weights.
Closed loop (``"loop": "closed"``): ``clients`` callers, each sending its
next request when its last one returns; a pool of prompts sized by
``pool_per_s`` per second of window.

Prompts are token ids drawn uniformly from the vocabulary by the seed,
``(batch, prompt_len)`` a request.  Derived from the request generator
of ``repro_torch.launch.serve.run_stream``, with two repairs: requests
are timed from when they were due, not from when they were submitted,
and the window ends at its close, without the drain.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


@dataclass
class Schedule:
    loop: str                      # "open" | "closed"
    prompts: np.ndarray            # (n, batch, prompt_len) int64
    due: Optional[List[float]]     # open loop: seconds from the start
    clients: int = 0


def open_gaps(rate: float, seconds: float) -> List[float]:
    """Due times (seconds from the window's start) of the open loop."""
    n = max(1, int(round(rate * seconds)))
    q = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    q = q[_rng(0, 1).permutation(n)]
    q *= seconds / q.sum()
    return [0.0] + np.cumsum(q)[:-1].tolist()


def make(traffic: dict, cell: dict, seconds: float, seed: int,
         vocab: int) -> Schedule:
    loop = traffic["loop"]
    P, B = int(traffic["prompt_len"]), int(traffic.get("batch", 1))
    if loop == "open":
        due = open_gaps(float(cell["rate_rps"]), seconds)
        n, clients = len(due), 0
    elif loop == "closed":
        due, clients = None, int(traffic["clients"])
        n = clients + int(math.ceil(float(traffic["pool_per_s"]) * seconds))
    else:
        raise ValueError(f"traffic loop {loop!r}")
    prompts = _rng(seed, 2).integers(0, vocab, size=(n, B, P),
                                     dtype=np.int64)
    return Schedule(loop, prompts, due, clients)


def percentile(values, p: float) -> float:
    """numpy's linear-interpolation percentile, as ``run_stream``'s."""
    return float(np.percentile(np.asarray(sorted(values), dtype=float), p))
