"""Shared set-up of the port's trainer tests
(``tests/test_torch_trainer*.py``): the tiny dense config and a trainer
on the CPU's simulated pair at a 4:1 time model."""
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

_CFG = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
CFG = ArchConfig(**_CFG, parallel=ParallelConfig(remat="none"))
SYS = ArchConfig(**{**_CFG, "name": "sys", "vocab_size": 512},
                 parallel=ParallelConfig(remat="none"))


def TM(g, k):                                   # 4:1
    return k * (0.001 if g == "accel" else 0.004)


def make_trainer(tmp, steps=6, accum=8, injector=None):
    return Trainer(
        CFG, OptConfig(lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(vocab_size=256, seq_len=32, micro_batch=2),
        TrainerConfig(accum_units=accum, steps=steps, ckpt_dir=tmp,
                      ckpt_every=2, time_model=TM),
        injector=injector, device="cpu")
