"""The port's ``Trainer`` against the reference's, on the CPU.

The reference's ``Trainer`` (its bf16 forward and backward op by op,
``jax.disable_jit()``; its f32 optimizer update compiled, where XLA's
fused multiply-adds move a value by an ulp) and the port's
(``device="cpu"``, the simulated pair) from the same f32 weights (the
port's ``init``, ``torch_train_parity.reference_tree``), data and
``time_model``, six steps with a kill and a revive:

* each step's planned and executed units, its re-plan flag and its
  steals equal, and its virtual group times and makespan;
* each step's loss within 0.02 (the bf16 forwards round differently,
  ``tests/torch_train_parity.py``);
* the final parameters within ``2 * lr * steps`` absolutely: AdamW
  moves an element by at most ~lr a step, so a sign flip of a tiny
  gradient element moves it by at most ~2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.ft.failure import FailureInjector as JaxInjector
from repro.optim import optimizer as jax_opt
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.failure import FailureInjector
from repro_torch.models import model_zoo
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.optim.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_train_parity import reference_tree

# one layer: this holds the trainer (plans, sums, updates); every arch's
# layers are held in tests/test_torch_train_*.py
_CFG = dict(name="tiny", family="dense", n_layers=1, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
CFG = ArchConfig(**_CFG, parallel=ParallelConfig(remat="none"))
JCFG = JaxArchConfig(**_CFG, parallel=JaxParallelConfig(remat="none"))


def TM(g, k):                                   # 4:1
    return k * (0.001 if g == "accel" else 0.004)


def test_trainer_matches_reference():
    steps, lr = 6, 1e-3
    okw = dict(lr=lr, warmup_steps=2, total_steps=50)
    dkw = dict(vocab_size=256, seq_len=16, micro_batch=2)
    tkw = dict(accum_units=4, steps=steps, time_model=TM)
    kill, revive = {2: "host"}, {4: "host"}
    params = model_zoo.init(CFG, 0, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, reference_tree(params, CFG))
    with jax.disable_jit():
        jtr = JaxTrainer(JCFG, jax_opt.OptConfig(**okw),
                         JaxDataConfig(**dkw), JaxTrainerConfig(**tkw),
                         injector=JaxInjector(kill=kill, revive=revive))
        update = jtr._update

        def compiled_update(*args):
            with jax.disable_jit(False):
                return update(*args)

        jtr._update = compiled_update
        jout = jtr.run({"params": jp,
                        "opt": jax_opt.init_opt_state(jtr.opt_cfg, jp)})
    tr = Trainer(CFG, OptConfig(**okw), DataConfig(**dkw),
                 TrainerConfig(**tkw),
                 injector=FailureInjector(kill=kill, revive=revive),
                 device="cpu")
    out = tr.run({"params": params,
                  "opt": init_opt_state(tr.opt_cfg, params)})
    assert len(out["history"]) == len(jout["history"]) == steps
    for r, j in zip(out["history"], jout["history"]):
        assert (r.step, r.units, r.executed_units, r.replanned,
                r.steals) == (j.step, j.units, j.executed_units,
                              j.replanned, j.steals)
        assert abs(r.loss - j.loss) <= 0.02, (r.step, r.loss, j.loss)
        assert r.group_times == pytest.approx(j.group_times)
        assert r.hybrid_time == pytest.approx(j.hybrid_time)
    ref = params_from_numpy(jax.tree.map(np.asarray, jout["params"]), CFG,
                            device="cpu", dtype=torch.float32)
    for a, b in zip(leaves(out["params"]), leaves(ref)):
        assert float((a - b).abs().max()) <= 2 * lr * steps
