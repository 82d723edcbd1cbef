"""The roofline (``repro_torch.benchmarks.roofline``) on the CPU: every
row against the reference's on the same probe record, the 40 rows of
``run``; and the probe's totals against full-depth traces of
whisper-tiny, the encoder-decoder, whose probe differences layers
rather than groups.  Every test leaves no process group behind.
"""
import os
import sys

import pytest
import torch.distributed as dist

from repro.configs import registry as jax_registry
from repro_torch.benchmarks import roofline
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.core.cost_model import h100_sxm_profile
from repro_torch.launch import dryrun, probe
from repro_torch.launch import mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"train": ShapeCell("train_t", 64, 32, "train"),
         "prefill": ShapeCell("prefill_t", 64, 32, "prefill"),
         "decode": ShapeCell("decode_t", 64, 32, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    mesh_mod.release()
    assert not dist.is_initialized()


def _reference_roofline():
    """The reference's ``benchmarks/roofline.py`` (``XLA_FLAGS`` kept as
    it was: no later process of the suite inherits a change)."""
    import importlib
    old = os.environ.get("XLA_FLAGS")
    try:
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        return importlib.import_module("benchmarks.roofline")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("arch_id", ["whisper-tiny"])
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
# (viii): the roofline against the reference's
# ---------------------------------------------------------------------------
def test_roofline_rows_match_reference():
    """Every cell of ``all_cells()``: the reference's ``flops``,
    ``model_flops``, ``hbm_bytes`` and ``coll_bytes`` on the same probe
    record, and each time term the reference's times the ratio of the
    two profiles' constants."""
    from repro.core.cost_model import tpu_v5e_profile
    ref = _reference_roofline()
    jcells = {(a, c.name): c for a, c, _, _ in jax_registry.all_cells()}
    v5e, h100 = tpu_v5e_profile(), h100_sxm_profile()
    assert (roofline.PEAK, roofline.HBM, roofline.LINK, roofline.CHIPS) == \
        (989.4e12, 3.35e12, 50e9, 256)
    assert h100.measured is False
    n_ok = 0
    for i, (aid, cell, ok, _) in enumerate(registry.all_cells()):
        pr = {(aid, cell.name, "16x16"): {
            "flops_total": 1e12 * (i + 1), "coll_total": 3e9 * (i + 1),
            "coll_by_op": {"all-gather": 1e9 * (i + 1),
                           "all-to-all": 2e9 * (i + 1)}}}
        got = roofline.roofline_row(aid, cell, pr)
        want = ref.roofline_row(aid, jcells[(aid, cell.name)], pr, {})
        assert got["status"] == want["status"]
        if not ok:
            assert got == want
            continue
        n_ok += 1
        for k in ("flops", "model_flops", "hbm_bytes", "coll_bytes",
                  "hlo_flops_probe", "coll_by_op", "model_over_hlo"):
            assert got[k] == want[k], (aid, cell.name, k)
        for k, ratio in (("t_compute", v5e.matmul_flops / h100.matmul_flops),
                         ("t_memory", v5e.mem_bw / h100.mem_bw),
                         ("t_collective", v5e.link_bw / h100.link_bw)):
            assert got[k] == pytest.approx(want[k] * ratio, rel=1e-12), \
                (aid, cell.name, k)
        terms = {t: got["t_" + t] for t in ("compute", "memory",
                                            "collective")}
        assert got["dominant"] == max(terms, key=terms.get)
        assert got["roofline_time"] == max(terms.values())
    assert n_ok == sum(ok for _, _, ok, _ in registry.all_cells())


def test_roofline_run_prints_forty_rows(capsys, tmp_path):
    rows = roofline.run(probe_path=str(tmp_path / "none.jsonl"))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("roofline/")]
    assert len(rows) == len(lines) == 40
