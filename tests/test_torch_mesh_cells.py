"""The mesh tools' cells on the CPU: h2o-danube-1.8b and
deepseek-v2-lite-16b (both MoE layouts) traced on the fake 16x16 and
2x16x16 meshes.  Every test leaves no process group behind.
"""
import dataclasses

import pytest
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

CELLS = {"prefill": ShapeCell("prefill_t", 64, 32, "prefill"),
         "decode": ShapeCell("decode_t", 64, 32, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    mesh_mod.release()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the acceptance's cells on both meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,mode", [
    ("h2o-danube-1.8b", None), ("deepseek-v2-lite-16b", "ep"),
    ("deepseek-v2-lite-16b", "smap")])
def test_cells_trace_on_both_meshes(arch_id, mode, multi_pod):
    """h2o-danube-1.8b and deepseek-v2-lite-16b (expert-parallel and
    the shard_map MoE) trace OK at depth 1 on the 16x16 and 2x16x16
    meshes, prefill and decode; the shard_map MoE's all_to_alls are
    counted."""
    cfg = registry.get(arch_id)
    if mode == "smap":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  shard_mode="smap"))
    cfg = cfg.replace(n_layers=1 + (cfg.moe.n_dense_layers
                                    if cfg.moe else 0))
    for kind in ("prefill", "decode"):
        rec = dryrun.run_cell(arch_id, CELLS[kind], multi_pod, cfg=cfg)
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["n_devices"] == (512 if multi_pod else 256)
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert rec["flops"] > 0 and rec["argument_size_bytes"] > 0
        if mode == "smap":
            assert rec["collective_bytes"]["all-to-all"] > 0
