"""The port's trainer, checkpointer and launchers (``repro_torch.train``,
``checkpoint``, ``launch.train``, ``examples.train_lm``) against the
reference, on the CPU (the simulated pair, ``device="cpu"``).

The reference's ``tests/test_trainer_ft.py`` and ``test_system.py``'s
two training tests ported, then parity:

* the trainer against the reference's in
  ``tests/test_torch_trainer_parity.py``;
* checkpoints cross over both ways, with equal manifests; a bf16 leaf
  round-trips bit for bit;
* ``HybridExecutor(time_model=)``'s virtual split and makespan equal the
  reference's;
* the reference's optimizer state continues in the port
  (``from_jax.opt_state_from_numpy``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.hybrid_executor import HybridExecutor as JaxExecutor
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.optim import optimizer as jax_opt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.core.hybrid_executor import HybridExecutor, detect_platform
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import train_lm
from repro_torch.ft.failure import FailureInjector, HeartbeatMonitor
from repro_torch.launch import train as train_launch
from repro_torch.models.from_jax import (opt_state_from_numpy,
                                         params_from_numpy)
from repro_torch.optim.optimizer import OptConfig, apply_updates
from repro_torch.serve.serve_step import generate
from repro_torch.train.trainer import Trainer, TrainerConfig

_CFG = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
CFG = ArchConfig(**_CFG, parallel=ParallelConfig(remat="none"))
JCFG = JaxArchConfig(**_CFG, parallel=JaxParallelConfig(remat="none"))
SYS = ArchConfig(**{**_CFG, "name": "sys", "vocab_size": 512},
                 parallel=ParallelConfig(remat="none"))


def TM(g, k):                                   # 4:1
    return k * (0.001 if g == "accel" else 0.004)


def _trainer(tmp, steps=6, accum=8, injector=None):
    return Trainer(
        CFG, OptConfig(lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(vocab_size=256, seq_len=32, micro_batch=2),
        TrainerConfig(accum_units=accum, steps=steps, ckpt_dir=tmp,
                      ckpt_every=2, time_model=TM),
        injector=injector, device="cpu")


# ------------------------------------------- the reference's unit tests
def test_shares_converge_to_throughput_ratio(tmp_path):
    out = _trainer(str(tmp_path), steps=5).run()
    # 4:1 ratio, 8 units -> [6, 2] after calibration settles
    assert out["history"][-1].units == [6, 2]


def test_failure_kill_and_elastic_revive(tmp_path):
    inj = FailureInjector(kill={2: "host"}, revive={4: "host"})
    out = _trainer(str(tmp_path), steps=6, injector=inj).run()
    h = {r.step: r for r in out["history"]}
    assert h[2].units == [8, 0]          # dead group gets nothing
    assert h[3].units == [8, 0]
    assert h[4].units[1] > 0             # rejoined after revive
    assert all(np.isfinite(r.loss) for r in out["history"])
    assert all(np.isfinite(r.grad_norm) and r.wall_s > 0
               for r in out["history"])


def test_checkpoint_restart_resumes(tmp_path):
    _trainer(str(tmp_path), steps=4).run()
    out = _trainer(str(tmp_path), steps=7).run()
    assert out["history"][0].step == 4   # resumed, not restarted


def test_run_continues_in_process_as_one_run():
    """``run(state, start_step, warmup=False)`` after a 3-step run is
    the same training as one 5-step run: the same plans and losses."""
    whole = _trainer(None, steps=5).run()["history"]
    tr = _trainer(None, steps=3)
    out = tr.run()
    tr.tcfg.steps = 5
    more = tr.run({"params": out["params"], "opt": out["opt"]},
                  start_step=3, warmup=False)["history"]
    assert [r.step for r in more] == list(range(5))
    assert [(r.units, r.loss) for r in more] == [(r.units, r.loss)
                                                  for r in whole]


def test_checkpoint_atomic_and_gc(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2, async_save=False)
    state = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 3))}}
    for s in (1, 2, 3):
        ck.save(s, state)
    assert ck.latest_step() == 3
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                   if n.startswith("step_"))
    assert steps == [2, 3]               # GC kept last 2
    restored, step = ck.restore(state)
    assert step == 3
    assert torch.equal(restored["a"], torch.arange(4.0))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, {"a": torch.ones((4,))})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.ones((5,))})


def test_heartbeat_monitor():
    clock = [0.0]
    mon = HeartbeatMonitor(["a", "b"], timeout_s=10,
                           clock=lambda: clock[0])
    clock[0] = 5.0
    mon.beat("a")
    clock[0] = 12.0
    assert mon.check() == {"b"}
    mon.beat("b")
    assert mon.check() == set()


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


def test_trainer_without_a_gpu_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, OptConfig(), DataConfig(256, 32, 2), TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", "xlstm-350m", "--steps", "1"])
    groups, _ = detect_platform(device="cpu")
    assert Trainer(CFG, OptConfig(), DataConfig(256, 32, 2),
                   TrainerConfig(), groups=groups).device.type == "cpu"


# ------------------------------------------------------------- parity
def _tree_np(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "layers": [{"k": rng.standard_normal(5)
                                   .astype(np.float32)},
                                  {"k": rng.standard_normal(5)
                                   .astype(np.float32)}]},
            "count": np.int32(7), "ids": np.arange(6, dtype=np.int32)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_checkpoints_cross_over_both_ways(tmp_path):
    tree = _tree_np(0)
    jd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    JaxCheckpointer(jd, async_save=False).save(
        3, jax.tree.map(jnp.asarray, tree))
    Checkpointer(pd, async_save=False).save(3, _as_torch(tree))
    assert _manifest(jd, 3) == _manifest(pd, 3)
    assert sorted(os.listdir(os.path.join(jd, "step_3"))) == sorted(
        os.listdir(os.path.join(pd, "step_3")))
    like = _as_torch(_tree_np(1))
    mine, step = Checkpointer(jd).restore(like)        # reference -> port
    assert step == 3
    for a, b in zip(leaves(mine), leaves(_as_torch(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref, step = JaxCheckpointer(pd).restore(               # port -> reference
        jax.tree.map(jnp.asarray, _tree_np(1)))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    state = {"m": x.bfloat16(), "v": x, "count": torch.tensor(2)}
    ck = Checkpointer(str(tmp_path))
    ck.save(0, state)
    state["m"].zero_()                    # the snapshot is a copy
    ck.wait()
    assert _manifest(str(tmp_path), 0)["leaves"]["m"]["dtype"] == "bfloat16"
    back, _ = ck.restore({"m": torch.zeros(5, 7, dtype=torch.bfloat16),
                          "v": torch.zeros(5, 7),
                          "count": torch.tensor(0)})
    assert back["m"].dtype == torch.bfloat16
    assert torch.equal(back["m"].view(torch.int16),
                       x.bfloat16().view(torch.int16))
    assert torch.equal(back["v"], x) and int(back["count"]) == 2


def test_executor_time_model_matches_reference():
    data = np.arange(64, dtype=np.float32)

    def tm(g, k):
        return k * (0.002 if g == "accel" else 0.005)

    jex = JaxExecutor(time_model=tm)
    ex = HybridExecutor(device="cpu", time_model=tm)
    assert ex._mode() == jex._mode() == "virtual"
    for _ in range(3):
        jo = jex.run_work_shared(
            "tm", 16, lambda g, s, k: jnp.asarray(data[s * 4:(s + k) * 4]
                                                  .sum()),
            lambda outs: float(sum(float(o) for o in outs)))
        o = ex.run_work_shared(
            "tm", 16, lambda g, s, k: torch.from_numpy(
                data[s * 4:(s + k) * 4]).sum(),
            lambda outs: float(sum(float(x) for x in outs)))
        assert o.value == jo.value == float(data.sum())
        assert o.trace.mode == jo.trace.mode == "virtual"
        assert o.trace.group_units == jo.trace.group_units
        assert o.trace.steals == jo.trace.steals
        assert o.trace.makespan == pytest.approx(jo.trace.makespan)
        assert [(r.group, r.chunk.start, r.t_start) for r in o.trace.records] \
            == pytest.approx([(r.group, r.chunk.start, r.t_start)
                              for r in jo.trace.records])


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_reference_optimizer_state_continues_in_the_port(kind):
    okw = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=10)
    jp = jax_param.values(jax_zoo.init(JCFG, jax.random.key(0)))
    jocfg = jax_opt.OptConfig(**okw)
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jp)
    with jax.disable_jit():
        jp2, js, _ = jax_opt.apply_updates(jocfg, jp, g,
                                           jax_opt.init_opt_state(jocfg, jp),
                                           jnp.int32(0))
    ns = jax.tree.map(np.asarray, js)
    if kind == "adafactor":
        # the reference factors a stacked norm scale over its layer axis
        with pytest.raises(ValueError, match="stacked layer axis"):
            opt_state_from_numpy(ns, CFG, device="cpu")
        return
    state = opt_state_from_numpy(ns, CFG, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp2), CFG,
                               device="cpu", dtype=torch.float32)
    assert int(state["count"]) == 1
    ref_m = params_from_numpy(ns["m"], CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["m"]),
                                                 leaves(ref_m)))
    # one more step from the converted state, on both sides
    with jax.disable_jit():
        jp3, _, _ = jax_opt.apply_updates(jocfg, jp2, g, js, jnp.int32(1))
    grads = params_from_numpy(jax.tree.map(np.asarray, g), CFG,
                              device="cpu", dtype=torch.float32)
    apply_updates(OptConfig(**okw), params, grads, state, 1)
    ref = params_from_numpy(jax.tree.map(np.asarray, jp3), CFG,
                            device="cpu", dtype=torch.float32)
    for a, b in zip(leaves(params), leaves(ref)):
        # the port decays no per-layer vector, the reference's stacked
        # norm scales are matrices (ROADMAP, kept differences)
        assert float((a - b).abs().max()) <= 2 * okw["lr"] * 0.1 + 1e-6


# ----------------------------------------------------------- launchers
def test_launch_train_runs_on_the_cpu(tmp_path):
    trainer, out = train_launch.main(
        ["--arch", "xlstm-350m", "--steps", "2", "--ckpt", str(tmp_path)],
        device="cpu")
    assert len(out["history"]) == 2 and trainer.device.type == "cpu"
    assert all(np.isfinite(r.loss) for r in out["history"])
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "whisper-tiny", "--steps", "1"],
                          device="cpu")


def test_example_train_lm_runs_on_the_cpu(tmp_path):
    out = train_lm.main(["--steps", "3", "--ckpt", str(tmp_path),
                         "--inject-failure"], device="cpu")
    h = out["history"]
    assert len(h) == 3 and h[1].units == [8, 0] and h[2].units[1] > 0
