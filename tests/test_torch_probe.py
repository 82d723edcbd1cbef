"""The port's probe and hill-climb (``repro_torch.launch.probe``,
``launch.hillclimb``) on the CPU: the probe's totals against full-depth
traces of h2o-danube-1.8b (whisper-tiny's are in
``test_torch_roofline.py``), and ``apply_overrides`` against the
reference's.  Every test leaves no process group behind.
"""
import dataclasses
import os
import sys

import pytest
import torch.distributed as dist

from repro.configs import registry as jax_registry
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, hillclimb, probe
from repro_torch.launch import mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    mesh_mod.release()
    assert not dist.is_initialized()


def _reference(module):
    """A reference module that sets ``XLA_FLAGS`` when imported (its
    dry-run tools force 512 host devices): the variable is restored, so
    no later process of the suite inherits it."""
    import importlib
    old = os.environ.get("XLA_FLAGS")
    try:
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        return importlib.import_module(module)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ---------------------------------------------------------------------------
# (iv): the probe's totals equal a full-depth trace's
# ---------------------------------------------------------------------------
CELLS = {"train": ShapeCell("train_t", 64, 32, "train"),
         "prefill": ShapeCell("prefill_t", 64, 32, "prefill"),
         "decode": ShapeCell("decode_t", 64, 32, "decode")}


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b"])
def test_probe_totals_equal_full_depth(arch_id, kind):
    """The port unrolls its layers, so ``base + (n_groups - 1) * delta``
    is a full-depth trace's count, exactly: FLOPs and each collective
    op's bytes."""
    cell = CELLS[kind]
    cfg = registry.get(arch_id)
    rec = probe.probe_cell(arch_id, cell, cfg=cfg)
    assert rec["status"] == "OK", rec.get("traceback")
    full = dryrun.run_cell(arch_id, cell, False, cfg=cfg)
    assert full["status"] == "OK", full.get("traceback")
    assert rec["n_groups"] == cfg.n_layers
    assert rec["flops_total"] == full["flops"]
    assert rec["coll_total"] == full["collective_total"]
    assert {k: v for k, v in rec["coll_by_op"].items() if v} == \
        full["collective_bytes"]


# ---------------------------------------------------------------------------
# (vii): apply_overrides against the reference's
# ---------------------------------------------------------------------------
SETS = ["moe.dispatch=onehot", "moe.shard_dispatch=1",
        "moe.capacity_factor=1.05", "moe.overflow_passes=0",
        "moe.shard_mode=smap", "parallel.remat=full",
        "parallel.seq_shard_kv=true", "parallel.fsdp=false",
        "n_layers=4", "rope_theta=500000.0", "sliding_window=0",
        "attn_type=mla"]


@pytest.mark.parametrize("arch_id", ["deepseek-v2-lite-16b",
                                     "kimi-k2-1t-a32b", "h2o-danube-1.8b"])
def test_apply_overrides_matches_reference(arch_id):
    ref = _reference("repro.launch.hillclimb")
    base = registry.get(arch_id)
    jbase = jax_registry.get(arch_id)
    assert dataclasses.asdict(base) == dataclasses.asdict(jbase)
    sets = [s for s in SETS if base.moe or not s.startswith("moe.")]
    for i in range(len(sets)):
        got = hillclimb.apply_overrides(base, sets[:i + 1])
        want = ref.apply_overrides(jbase, sets[:i + 1])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), sets[i]
    # the parse: an int, a float, true / false, else the string
    got = hillclimb.apply_overrides(base, ["parallel.fsdp=true",
                                           "n_layers=3", "norm_eps=1e-6",
                                           "act=gelu"])
    assert (got.parallel.fsdp, got.n_layers, got.norm_eps, got.act) == \
        (True, 3, 1e-6, "gelu")
