"""Serving example: batched prefill + greedy decode with KV caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        [--arch kimi-k2-1t-a32b]

Greedy ``generate`` on a tiny dense config, or with ``--arch X`` on
that architecture's ``reduced()`` config; weights from seed 0, the
prompt from seed 1.  Runs on the first GPU and raises without one;
``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device, sync
from repro_torch.models import model_zoo
from repro_torch.serve.serve_step import generate


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (reduced config is used)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    if args.arch:
        cfg = registry.get(args.arch).reduced()
    else:
        cfg = ArchConfig(name="lm-tiny", family="dense", n_layers=4,
                         d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                         vocab_size=4096, head_dim=64)
    print(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} on {dev}")
    params = model_zoo.init(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    t0 = time.perf_counter()
    out = sync(generate(cfg, params, prompt, args.new_tokens,
                        cache_len=args.prompt_len + args.new_tokens + 1))
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. first use)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
