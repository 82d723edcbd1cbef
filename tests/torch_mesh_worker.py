"""One rank of ``tests/test_torch_moe_smap.py``'s 2x2 mesh: the smap MoE
on this rank's batch shard, over a gloo group of 4 CPU processes.

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUT`` with
``src`` on ``PYTHONPATH``: joins the group through the file store
``STORE``, builds ``make_host_mesh(model=2)`` and writes this rank's
outputs (both dispatch modes) and mesh coordinates to ``OUT`` with
``torch.save``.  ``moe_case`` makes the inputs, shared with the test.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelConfig

# tests/test_moe_smap.py's config: capacity 8 drops no token
BASE = MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff=32,
                 capacity_factor=8.0, overflow_passes=0)
CFG = ArchConfig(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                 n_kv_heads=2, d_ff=32, vocab_size=16, moe=BASE,
                 parallel=ParallelConfig(remat="none"))


def smap_cfg(dispatch: str) -> ArchConfig:
    return CFG.replace(moe=dataclasses.replace(BASE, shard_mode="smap",
                                               dispatch=dispatch))


def moe_case(batch: int, seq: int = 12):
    """(params, x, {dispatch: smap config}): the MoE's f32 parameters
    from a seeded generator and x (batch, seq, 16) from numpy, seed 1."""
    from repro_torch.models import moe as moe_mod
    params = moe_mod.init_moe(torch.Generator().manual_seed(0), CFG,
                              torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, seq, CFG.d_model)).astype(np.float32))
    return params, x, {d: smap_cfg(d) for d in ("sort", "onehot")}


def main(rank: int, world: int, store: str, out: str) -> None:
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import sharding as ps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        params, x, cfgs = moe_case(4)
        mesh = mesh_mod.make_host_mesh(model=2, device="cpu")
        di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        rows = x.shape[0] // mesh.size(0)
        res = {"data": di, "model": mi}
        with ps.use_mesh(mesh):
            for disp, cfg in cfgs.items():
                res[disp] = moe_mod.moe_ffn(
                    params, x[di * rows:(di + 1) * rows], cfg)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
