"""The port's trainer runs on the CPU's simulated pair: an in-process
continuation equals one run, training lowers the loss on learnable
data, and trained f32 weights serve (the reference's
``test_system.py`` training tests; split from
``test_torch_trainer.py``)."""
import numpy as np
import torch

from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizer import OptConfig
from repro_torch.serve.serve_step import generate
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_trainer_common import SYS, make_trainer


def test_run_continues_in_process_as_one_run():
    """``run(state, start_step, warmup=False)`` after a 3-step run is
    the same training as one 5-step run: the same plans and losses."""
    whole = make_trainer(None, steps=5).run()["history"]
    tr = make_trainer(None, steps=3)
    out = tr.run()
    tr.tcfg.steps = 5
    more = tr.run({"params": out["params"], "opt": out["opt"]},
                  start_step=3, warmup=False)["history"]
    assert [r.step for r in more] == list(range(5))
    assert [(r.units, r.loss) for r in more] == [(r.units, r.loss)
                                                  for r in whole]


def test_train_then_serve_roundtrip(tmp_path):
    """Train briefly, then generate with the trained (f32) weights."""
    tr = Trainer(SYS, OptConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                 DataConfig(vocab_size=512, seq_len=32, micro_batch=2),
                 TrainerConfig(accum_units=4, steps=4,
                               ckpt_dir=str(tmp_path),
                               time_model=lambda g, k: k),
                 device="cpu")
    out = tr.run()
    assert np.isfinite(out["history"][-1].loss)
    assert all(p.dtype == torch.float32 for p in leaves(out["params"]))
    toks = generate(SYS, out["params"], torch.ones((2, 8),
                                                   dtype=torch.int64),
                    4, cache_len=16)
    assert toks.shape[0] == 2
    assert bool((toks >= 0).all()) and bool((toks < SYS.vocab_size).all())


def test_training_reduces_loss_on_learnable_data():
    """Tokens drawn from a zipf distribution are learnable: unigram CE
    should drop measurably within a few steps."""
    tr = Trainer(SYS, OptConfig(lr=3e-3, warmup_steps=2, total_steps=100),
                 DataConfig(vocab_size=512, seq_len=32, micro_batch=4,
                            kind="zipf"),
                 TrainerConfig(accum_units=4, steps=12,
                               time_model=lambda g, k: k),
                 device="cpu")
    losses = [r.loss for r in tr.run()["history"]]
    assert losses[-1] < losses[0] - 0.3, losses
