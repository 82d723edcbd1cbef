"""Holding the kernel path's greedy tokens against the plain path's.

``plain_kernels()`` swaps the model's K7 and K8 entries for their plain
versions, ``greedy_with_gaps`` runs ``generate``'s loop and keeps each
token's top-1/top-2 logit gap, and ``check_tokens`` applies the margin
rule to two such runs.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
use them on the card.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm.gmm import gmm_torch
from repro_torch.serve.serve_step import greedy_logits

# the reference's bf16 model tolerance (tests/test_models.py): a greedy
# token of the kernel path may differ from the plain path's only where
# the plain path's top-1/top-2 logit gap is under it
MARGIN = 0.25


@contextlib.contextmanager
def plain_kernels():
    """The model's K7 and K8 entries swapped for the kernels' plain
    versions (the unblocked f32 attention, the f32 grouped matmul) for
    the duration of the block."""
    saved = flash_ops.sdpa, gmm_ops.gmm_model

    def sdpa(q, k, v, *, causal=True, config=None):
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         use_kernel=False)

    flash_ops.sdpa, gmm_ops.gmm_model = sdpa, gmm_torch
    try:
        yield
    finally:
        flash_ops.sdpa, gmm_ops.gmm_model = saved


def greedy_with_gaps(cfg, params, prompt, n_new, tp: int = 1):
    """``generate``'s tokens (B, n_new + 1), each token's top-1 minus
    top-2 logit, and the last prompt position's f32 logits (B, V)."""
    with torch.inference_mode():
        rows = list(greedy_logits(cfg, params, prompt, n_new, tp=tp))
    lg = torch.stack(rows, dim=1)
    top2 = lg.topk(2, dim=-1).values
    return (lg.argmax(-1).to(torch.int32), top2[..., 0] - top2[..., 1],
            rows[0])


def check_tokens(toks, plain, gaps, margin: float = MARGIN
                 ) -> List[Tuple[int, int, float]]:
    """The margin rule: a row of ``toks`` may differ from ``plain`` only
    where the plain path's top-1/top-2 gap is under ``margin``, and the
    row is compared no further.  Returns each differing row's
    (row, first differing token, gap); raises where the rule fails."""
    if toks.shape != plain.shape:
        raise AssertionError(f"tokens {tuple(toks.shape)} against "
                             f"{tuple(plain.shape)}")
    differed = []
    for b in range(toks.shape[0]):
        diff = (toks[b] != plain[b]).nonzero()
        if len(diff):
            t = int(diff[0])
            gap = float(gaps[b, t])
            if gap >= margin:
                raise AssertionError(
                    f"row {b} token {t} ({int(toks[b, t])} vs "
                    f"{int(plain[b, t])}) differs where the plain path's "
                    f"top-1/top-2 gap {gap} is not under {margin}")
            differed.append((b, t, gap))
    return differed
