"""Whether what the timed path served is correct.

After the window, once the program's state is freed, a sample of the
requests it served (drawn from the seed, the longest among them) is
run through the plain float32 reference (``bench/reference``): each
prompt with its served tokens, in one full-sequence forward.  At every
position that produced a served token, the gap by which that token's
reference logit lies below the reference's best is read, and the
widest of those gaps is held to the cell file's ``gap_limit``.  Greedy
tokens only: the engine serves every request greedily.  The control
(``control.py``) reads the same gaps for the tokens an fp8 reference
puts first.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from bench.reference import model as ref_model

def widest(gaps: torch.Tensor) -> float:
    """The widest gap of the served tokens (inf where none was read)."""
    return float(gaps.max()) if gaps.numel() else float("inf")


def sample(records, k: int, seed: int) -> list:
    """Up to ``k`` served requests drawn from the seed, the longest
    (most tokens served) always among them."""
    served = [r for r in records if r.ok]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: served[i].tokens.numel())
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 4])
    pick = rng.permutation(len(rest))[:max(k - 1, 0)]
    return [served[longest]] + [served[rest[i]] for i in sorted(pick)]


def served_gaps(conf: dict, weights: dict, prompts: List[np.ndarray],
                served: List[torch.Tensor], *, chunk: int = 8,
                control_mm=None) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """(gaps of the served tokens (n, new + 1), the control's gaps or
    None).  Each prompt (1, P) with its served tokens (1, new + 1): the
    reference reads prompt + served[:-1] and scores positions P - 1 ..
    P + new - 1."""
    ref_model.exact_matmuls()
    dev = weights["embed"].device
    ref = ref_model.Reference(conf, weights)
    ctl = (ref_model.Reference(conf, weights, mm=control_mm)
           if control_mm is not None else None)
    out, out_ctl = [], []
    with torch.inference_mode():
        for lo in range(0, len(prompts), chunk):
            p = torch.as_tensor(np.concatenate(prompts[lo:lo + chunk]))
            s = torch.cat([t.reshape(1, -1) for t in served[lo:lo + chunk]])
            P, n = p.shape[1], s.shape[1]
            seq = torch.cat([p, s[:, :-1].long()], dim=1).to(dev)
            at = list(range(P - 1, P + n - 1))
            lg = ref.logits(seq, at)
            out.append(ref_model.gaps(lg, s.long().to(dev)).cpu())
            if ctl is not None:
                top = ctl.logits(seq, at).argmax(-1)
                out_ctl.append(ref_model.gaps(lg, top).cpu())
            del lg
    return torch.cat(out), torch.cat(out_ctl) if ctl is not None else None


def tokens_ok(records, vocab: int, n_tokens: int) -> int:
    """Served requests whose answer is not (1, n_tokens) ids in the
    vocabulary."""
    bad = 0
    for r in records:
        if r.ok and (tuple(r.tokens.shape) != (1, n_tokens)
                     or int(r.tokens.min()) < 0
                     or int(r.tokens.max()) >= vocab):
            bad += 1
    return bad
