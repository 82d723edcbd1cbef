"""Serving launcher: batched greedy generation for an assigned arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b \\
        --batch 4 --prompt-len 16 --new-tokens 16 [--full]

Runs on the first GPU and raises without one.  ``main(argv,
device="cpu")`` runs it on the CPU from Python.  Without ``--full`` the
config is ``reduced()``; with it, the architecture's full config (a
model whose weights must fit on the card).  Weights are random, from
seed 0; the prompt from seed 1.

``--hybrid`` (work-sharing the batch across device groups) and
``--stream`` (the serving scheduler) come with the serving-core slice
(ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.kernels.common import resolve_device, sync
from repro_torch.models import model_zoo
from repro_torch.serve.serve_step import generate


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = registry.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    params = model_zoo.init(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    cache_len = args.prompt_len + args.new_tokens + 1

    t0 = time.perf_counter()
    out = sync(generate(cfg, params, prompt, args.new_tokens,
                        cache_len=cache_len))
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s on {dev}")
    return out


if __name__ == "__main__":
    main()
