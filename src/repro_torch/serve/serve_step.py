"""Serving steps: batched prefill + single-token decode (greedy / sampled),
and the continuous engine's slot-batched step.

Sampling draws from an explicit ``torch.Generator`` by the Gumbel-max
rule, as ``jax.random.categorical`` does: the argmax of ``logits / T``
plus standard Gumbel noise, a draw from ``softmax(logits / T)``.  At
``temperature=0`` every entry is the greedy path, bitwise.  ``tp=``
(default 1) is the model-parallel degree the K/V heads and caches are
repeated for (``models.attention.kv_repeat_for``).
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo


def make_prefill_step(cfg: ArchConfig, *, tp: int = 1, cache_len: int = 0):
    """prefill_step(params, batch) -> (next_token (B, 1), caches)."""

    def prefill_step(params, batch):
        logits, caches = model_zoo.prefill(
            cfg, params, batch, cache_len or batch["tokens"].shape[1], tp=tp)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        return next_tok, caches

    return prefill_step


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int64 next tokens: the argmax at
    ``temperature=0`` (or with no generator), else a draw from
    ``softmax(logits / temperature)`` (Gumbel-max, the generator's
    stream on its own device, then moved to the logits')."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


def make_serve_step(cfg: ArchConfig, *, tp: int = 1,
                    temperature: float = 0.0):
    """serve_step(params, token, caches, position[, generator]) ->
    (next_token (B, 1) int32, caches), the caches updated in place;
    greedy unless ``temperature > 0`` and a generator is given."""

    def serve_step(params, token, caches, position, generator=None):
        logits, caches = model_zoo.decode_step(cfg, params, token, caches,
                                               position, tp=tp)
        next_tok = sample_tokens(logits[:, 0].float(), temperature,
                                 generator)
        return next_tok[:, None].to(torch.int32), caches

    return serve_step


def make_slot_step(cfg: ArchConfig, *, tp: int = 1):
    """Slot-batched decode step for the continuous-batching engine.

    ``slot_step(params, tokens, slot_caches, positions) -> (next_tokens,
    slot_caches)``: ``tokens`` and ``positions`` are (S,) int tensors,
    ``slot_caches`` the caches of an S-row prefill.  One batched
    ``decode_step`` over the S slots, each at its own position, the
    caches written in place.  Each row computes the math it computes
    alone (the reference ``vmap``s a B = 1 step; here the batch axis
    carries the slots and every op is row-independent), which is what
    keeps join/evict bit-identical to solo decode; dead slots compute
    garbage that nothing reads."""
    step = make_serve_step(cfg, tp=tp)

    def slot_step(params, tokens, slot_caches, positions):
        with torch.inference_mode():
            nxt, slot_caches = step(params, tokens[:, None], slot_caches,
                                    positions)
        return nxt[:, 0], slot_caches

    return slot_step


def greedy_logits(cfg: ArchConfig, params, prompt: torch.Tensor,
                  n_new: int, *, tp: int = 1, cache_len: Optional[int] = None
                  ) -> Iterator[torch.Tensor]:
    """Yields the (B, V) f32 logits that pick each of ``generate``'s
    tokens: the prefill's last position, then each of the ``n_new``
    decode steps, whose input is the argmax of the logits before."""
    P = prompt.shape[1]
    logits, caches = model_zoo.prefill(cfg, params, {"tokens": prompt},
                                       cache_len=cache_len or (P + n_new),
                                       tp=tp)
    lg = logits[:, -1].float()
    del logits
    yield lg
    for t in range(n_new):
        tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
        logits, caches = model_zoo.decode_step(cfg, params, tok, caches,
                                               P + t, tp=tp)
        lg = logits[:, 0].float()
        yield lg


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, n_new: int, *,
             tp: int = 1, cache_len: Optional[int] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generation: prefill, then ``n_new`` decode steps, greedy unless
    ``temperature > 0`` and a generator is given (the first token, the
    prefill's, is greedy either way, as in the reference).

    Returns (B, n_new + 1) int32 tokens: the prefill's argmax, then each
    decode step's, the reference's layout (its scan collects each step's
    input token and appends the last output)."""
    P = prompt.shape[1]
    step = make_serve_step(cfg, tp=tp, temperature=temperature)
    with torch.inference_mode():
        logits, caches = model_zoo.prefill(
            cfg, params, {"tokens": prompt},
            cache_len=cache_len or (P + n_new), tp=tp)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(
            torch.int32)
        del logits
        toks = [tok]
        for t in range(n_new):
            tok, caches = step(params, tok, caches, P + t, generator)
            toks.append(tok)
        return torch.cat(toks, dim=1)
