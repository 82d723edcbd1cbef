"""Serving steps: batched prefill + single-token greedy decode.

Sampling (``temperature`` / ``key``) and the continuous engine's
slot-batched ``make_slot_step`` are not ported yet: they come with the
continuous engine (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo


def make_prefill_step(cfg: ArchConfig, *, cache_len: int = 0):
    """prefill_step(params, batch) -> (next_token (B, 1), caches)."""

    def prefill_step(params, batch):
        logits, caches = model_zoo.prefill(
            cfg, params, batch, cache_len or batch["tokens"].shape[1])
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        return next_tok, caches

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, token, caches, position) -> (next_token (B, 1)
    int32, caches); greedy, the caches updated in place."""

    def serve_step(params, token, caches, position: int):
        logits, caches = model_zoo.decode_step(cfg, params, token, caches,
                                               position)
        next_tok = torch.argmax(logits[:, 0].float(), dim=-1)
        return next_tok[:, None].to(torch.int32), caches

    return serve_step


def greedy_logits(cfg: ArchConfig, params, prompt: torch.Tensor,
                  n_new: int, *, cache_len: Optional[int] = None
                  ) -> Iterator[torch.Tensor]:
    """Yields the (B, V) f32 logits that pick each of ``generate``'s
    tokens: the prefill's last position, then each of the ``n_new``
    decode steps, whose input is the argmax of the logits before."""
    P = prompt.shape[1]
    logits, caches = model_zoo.prefill(cfg, params, {"tokens": prompt},
                                       cache_len=cache_len or (P + n_new))
    lg = logits[:, -1].float()
    del logits
    yield lg
    for t in range(n_new):
        tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
        logits, caches = model_zoo.decode_step(cfg, params, tok, caches,
                                               P + t)
        lg = logits[:, 0].float()
        yield lg


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, n_new: int, *,
             cache_len: Optional[int] = None) -> torch.Tensor:
    """Greedy generation: prefill, then ``n_new`` decode steps.

    Returns (B, n_new + 1) int32 tokens: the prefill's argmax, then each
    decode step's, the reference's layout (its scan collects each step's
    input token and appends the last output)."""
    with torch.inference_mode():
        toks = [torch.argmax(lg, dim=-1).to(torch.int32)
                for lg in greedy_logits(cfg, params, prompt, n_new,
                                        cache_len=cache_len)]
        return torch.stack(toks, dim=1)
