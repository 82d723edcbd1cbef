"""Training launcher: ``--arch <id>`` selects an assigned architecture
(its ``reduced()`` config by default; ``--full`` the full config, a
model whose f32 parameters, gradients and optimizer state must fit on
the card).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --steps 20 [--full] [--ckpt DIR]

Trains on the first GPU (the GPU + CPU pair's work shares, every
micro-batch computed on the card: ``train.trainer``) and raises without
one.  ``main(argv, device="cpu")`` trains on the CPU from Python, on the
simulated pair.  Weights are random, from seed 0.  Returns
``(trainer, out)``: the ``Trainer`` and its ``run()``'s result.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.failure import FailureInjector
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (its f32 training state "
                         "must fit on the card)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--chunk-units", type=int, default=1,
                    help="micro-batches per stealable chunk")
    ap.add_argument("--no-steal", action="store_true",
                    help="disable intra-step work stealing")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise SystemExit(f"{args.arch}: use launch.serve / a custom "
                         "script for non-token-LM archs")
    print(f"training {cfg.name} ({'full' if args.full else 'reduced'}): "
          f"{cfg.n_layers}L d={cfg.d_model}")
    inj = (FailureInjector(kill={args.steps // 3: "host"},
                           revive={2 * args.steps // 3: "host"})
           if args.inject_failure else None)
    trainer = Trainer(
        cfg,
        OptConfig(lr=3e-4, warmup_steps=5, total_steps=max(args.steps, 50)),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   micro_batch=args.micro_batch),
        TrainerConfig(accum_units=args.accum, steps=args.steps,
                      ckpt_dir=args.ckpt,
                      ckpt_every=max(args.steps // 3, 1),
                      chunk_units=args.chunk_units,
                      steal=not args.no_steal,
                      time_model=lambda g, k: k * (
                          0.001 if g == "accel" else 0.004)),
        injector=inj, device=device)
    out = trainer.run()
    h = out["history"]
    print(f"done: loss {h[0].loss:.4f} -> {h[-1].loss:.4f}")
    return trainer, out


if __name__ == "__main__":
    main()
