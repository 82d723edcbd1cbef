"""The port's trainer and checkpointer (``repro_torch.train``,
``checkpoint``) against the reference, on the CPU (the simulated pair,
``device="cpu"``).

The reference's ``tests/test_trainer_ft.py`` ported (its longer trainer
runs in ``test_torch_trainer_ft.py`` and ``test_torch_trainer_run.py``,
the launchers in ``test_torch_trainer_launch.py`` and
``test_torch_trainer_example.py``, one file each so that the test
workers spread them), then parity:

* the trainer against the reference's in
  ``tests/test_torch_trainer_parity.py``;
* checkpoints of the same tree with f32 / int leaves cross over both
  ways, with equal manifests; a bf16 leaf round-trips bit for bit in
  the port; the two boundaries: a reference checkpoint of (stacked)
  parameters does not restore into the port's per-layer tree, and the
  reference reads a port bf16 leaf as its ``uint16`` bits;
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
from repro.configs import registry as jax_registry
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.hybrid_executor import HybridExecutor as JaxExecutor
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.optim import optimizer as jax_opt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.core.hybrid_executor import HybridExecutor, detect_platform
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.failure import HeartbeatMonitor
from repro_torch.launch import train as train_launch
from repro_torch.models import model_zoo
from repro_torch.models.from_jax import (opt_state_from_numpy,
                                         params_from_numpy)
from repro_torch.optim.optimizer import OptConfig, apply_updates
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_trainer_common import _CFG, CFG, make_trainer

JCFG = JaxArchConfig(**_CFG, parallel=JaxParallelConfig(remat="none"))


# ------------------------------------------- the reference's unit tests
def test_shares_converge_to_throughput_ratio(tmp_path):
    out = make_trainer(str(tmp_path), steps=5).run()
    # 4:1 ratio, 8 units -> [6, 2] after calibration settles
    assert out["history"][-1].units == [6, 2]


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


def test_reference_params_checkpoint_does_not_restore_in_the_port(tmp_path):
    """The boundary of the cross-over: the reference stacks its layer
    groups, so its checkpoint of h2o-danube-1.8b ``reduced()``
    parameters has no per-group leaf the port's tree asks for."""
    jcfg = jax_registry.get("h2o-danube-1.8b").reduced()
    jp = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    JaxCheckpointer(str(tmp_path), async_save=False).save(0, {"params": jp})
    cfg = registry.get("h2o-danube-1.8b").reduced()
    like = {"params": model_zoo.init(cfg, 0, device="cpu",
                                     dtype=torch.float32)}
    with pytest.raises(KeyError, match=r"checkpoint missing leaf "
                       r"params/stack/groups/\[0\]/l0/ffn/down/w"):
        Checkpointer(str(tmp_path)).restore(like)


def test_port_bf16_leaf_reads_as_uint16_bits_in_the_reference(tmp_path):
    """The other boundary: the reference reads no manifest type, so a
    bf16 leaf the port saved comes back there as its ``uint16`` bits,
    with no error."""
    x = torch.tensor([0.1426, -2.5, 1.0]).bfloat16()
    Checkpointer(str(tmp_path), async_save=False).save(0, {"m": x})
    assert _manifest(str(tmp_path), 0)["leaves"]["m"]["dtype"] == "bfloat16"
    back, _ = JaxCheckpointer(str(tmp_path)).restore(
        {"m": jnp.zeros(3, jnp.bfloat16)})
    arr = np.asarray(back["m"])
    assert arr.dtype == np.uint16
    assert arr.tolist() == x.view(torch.int16).numpy().view(
        np.uint16).tolist()
    assert arr[0] == 15890                # 0.1426 in bf16, as an integer


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
