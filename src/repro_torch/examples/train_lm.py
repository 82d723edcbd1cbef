"""End-to-end training example: hybrid work-shared trainer with
checkpoint/restart, straggler mitigation, and failure injection.

Default runs a ~7M-param model briefly; ``--full`` uses a ~100M-param
config (lm-100m).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps N] \\
        [--full] [--ckpt DIR]

Trains on the first GPU and raises without one; ``main(argv,
device="cpu")`` trains on the CPU.  ``--ckpt`` defaults to
``repro_torch_ckpt`` under the temporary directory: a second run there
resumes from the first's last checkpoint.  Returns the trainer's
``run()`` result.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.failure import FailureInjector
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def small_cfg():
    return ArchConfig(name="lm-7m", family="dense", n_layers=4, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2048,
                      head_dim=32, parallel=ParallelConfig(remat="none"))


def full_cfg():
    # ~100M params (GPT-2-small-ish with GQA)
    return ArchConfig(name="lm-100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                      vocab_size=32768, head_dim=64,
                      parallel=ParallelConfig(remat="dots"))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--inject-failure", action="store_true")
    args = ap.parse_args(argv)

    cfg = full_cfg() if args.full else small_cfg()
    seq = args.seq or (512 if args.full else 64)
    inj = (FailureInjector(kill={args.steps // 3: "host"},
                           revive={2 * args.steps // 3: "host"})
           if args.inject_failure else None)
    # deterministic 4:1 heterogeneity model for reproducible work shares
    tm = (lambda g, k: k * (0.001 if g == "accel" else 0.004))
    trainer = Trainer(
        cfg,
        OptConfig(lr=3e-4, warmup_steps=10, total_steps=max(args.steps, 100)),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, micro_batch=4),
        TrainerConfig(accum_units=8, steps=args.steps, ckpt_dir=args.ckpt,
                      ckpt_every=max(args.steps // 4, 1), time_model=tm),
        injector=inj, device=device)
    out = trainer.run()
    h = out["history"]
    print(f"\ntrained {len(h)} steps; loss {h[0].loss:.3f} -> "
          f"{h[-1].loss:.3f}")
    print("mean idle:",
          [f"{100 * sum(r.idle_fracs[i] for r in h) / len(h):.0f}%"
           for i in range(len(h[0].idle_fracs))])
    return out


if __name__ == "__main__":
    main()
