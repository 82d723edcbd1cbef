"""Faults planted in the timed path (the engine's stepper) for the test
that sees the check turn ``correct`` false.  Each takes the stepper and
wraps its calls in place."""
from __future__ import annotations

import torch


def prefill_token(stepper) -> None:
    """The prefill's first token altered where it is produced."""
    prefill = stepper.prefill

    def wrong(spec):
        rows = prefill(spec)
        V = stepper.cfg.vocab_size
        return [((cache, (first + 1) % V), (out + 1) % V, n)
                for (cache, first), out, n in rows]

    stepper.prefill = wrong


def step_token(stepper) -> None:
    """Every slot-batched step's tokens altered where they are produced."""
    step = stepper.step

    def wrong(state):
        state, outs = step(state)
        V = stepper.cfg.vocab_size
        state["tokens"] = (state["tokens"] + 1) % V
        return state, (outs + 1) % V

    stepper.step = wrong


def state_unchanged(stepper) -> None:
    """A step that leaves the slots' positions where they were: every
    step after the first decodes at the prompt's end again."""
    step = stepper.step

    def stuck(state):
        pos = state["pos"].clone()
        state, outs = step(state)
        state["pos"] = pos
        return state, outs

    stepper.step = stuck


def half_batch(stepper) -> None:
    """A step that serves only the first half of its slots: the other
    half keep the tokens they had."""
    step = stepper.step

    def half(state):
        before = state["tokens"].clone()
        state, outs = step(state)
        h = before.shape[0] // 2
        state["tokens"] = torch.cat([state["tokens"][:h], before[h:]])
        outs = outs.copy()
        outs[h:] = before[h:].cpu().numpy()
        return state, outs

    stepper.step = half


def one_slot(stepper) -> None:
    """Every step's token altered in one slot alone (the last): the
    other slots, and every prefill, are served as they should be."""
    step = stepper.step

    def wrong(state):
        state, outs = step(state)
        V = stepper.cfg.vocab_size
        t = state["tokens"]
        state["tokens"] = torch.cat([t[:-1], (t[-1:] + 1) % V])
        outs = outs.copy()
        outs[-1] = (outs[-1] + 1) % V
        return state, outs

    stepper.step = wrong


ALL = {"prefill_token": prefill_token, "step_token": step_token,
       "state_unchanged": state_unchanged, "half_batch": half_batch,
       "one_slot": one_slot}
