"""The port's shard_map MoE (``repro_torch.models.moe_shard_map``), the
named remat policies and ``registry.get_optimized`` on the CPU: the
counterparts of ``tests/test_moe_smap.py`` and more.

Tolerances: the smap MoE against the dense one in f32 at 1e-5 / 1e-4
(atol / rtol) and their gradients at 1e-4 / 1e-3, the reference
test's; its aux loss at rtol 1e-5.  Without a mesh, and under a named
remat policy, the results are bitwise those of the dense MoE and of
``remat="none"``.

The 2x2 mesh runs in 4 CPU processes (``tests/torch_mesh_worker.py``,
gloo through a file store under ``tmp_path``), so its all_to_alls move
data, which a 1x1 mesh's do not.  Every process group a test makes is
destroyed in its fixture's teardown.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jax_registry
from repro.configs.base import ArchConfig as JaxArch
from repro.configs.base import MoEConfig as JaxMoE
from repro.configs.base import ParallelConfig as JaxPar
from repro.models import moe as jax_moe
from repro.parallel import sharding as jax_ps
from repro_torch.configs import registry
from repro_torch.core.tree import leaves, unflatten
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import is_axes
from repro_torch.models import model_zoo
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import sharding as ps
from repro_torch.train import train_step
from torch_mesh_worker import CFG, moe_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def host_mesh():
    mesh = mesh_mod.make_host_mesh(device="cpu")
    yield mesh
    mesh_mod.release()
    assert not dist.is_initialized()


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dispatch", ["sort", "onehot"])
def test_smap_matches_dense(dispatch, host_mesh):
    params, x, cfgs = moe_case(2)
    y0, a0 = moe_mod.moe_ffn(params, x, CFG)
    with ps.use_mesh(host_mesh):
        y1, a1 = moe_mod.moe_ffn(params, x, cfgs[dispatch])
    _close(y0, y1, 1e-5, 1e-4)
    np.testing.assert_allclose(float(a0), float(a1), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["sort", "onehot"])
def test_smap_matches_reference_smap(dispatch, host_mesh):
    """The same numpy inputs through the reference's shard_map MoE on a
    1x1 mesh and the port's on its host mesh."""
    params, x, cfgs = moe_case(2)
    jcfg = JaxArch(name="m", family="moe", n_layers=1, d_model=16,
                   n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=16,
                   moe=JaxMoE(**dataclasses.asdict(cfgs[dispatch].moe)),
                   parallel=JaxPar(remat="none"))
    jp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params,
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax_ps.use_mesh(mesh):
        yr, ar = jax.jit(lambda p, x: jax_moe.moe_ffn(p, x, jcfg))(
            jp, jax.numpy.asarray(x.numpy()))
    with ps.use_mesh(host_mesh):
        y1, a1 = moe_mod.moe_ffn(params, x, cfgs[dispatch])
    _close(yr, y1, 1e-5, 1e-4)
    np.testing.assert_allclose(float(ar), float(a1), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["sort", "onehot"])
def test_smap_without_mesh_is_the_dense_moe(dispatch):
    """With no mesh, ``shard_mode="smap"`` runs the dense path (as in the
    reference): bitwise the dense MoE, and no raise."""
    params, x, cfgs = moe_case(2)
    dense = CFG.replace(moe=dataclasses.replace(cfgs[dispatch].moe,
                                                shard_mode="ep"))
    assert ps.active_mesh() is None
    y0, a0 = moe_mod.moe_ffn(params, x, dense)
    y1, a1 = moe_mod.moe_ffn(params, x, cfgs[dispatch])
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_smap_grads_finite_and_match(host_mesh):
    params, x, cfgs = moe_case(2, seq=8)
    cfg_s = cfgs["onehot"]

    def grads(cfg):
        req = [p.detach().requires_grad_(True) for p in leaves(params)]
        y, _ = moe_mod.moe_ffn(unflatten(params, req), x, cfg)
        return torch.autograd.grad(torch.sum(y ** 2), req)

    g0 = grads(CFG)
    with ps.use_mesh(host_mesh):
        g1 = grads(cfg_s)
    for a, b in zip(g0, g1):
        assert torch.isfinite(b).all()
        _close(a, b, 1e-4, 1e-3)


def test_optimized_presets_build():
    for aid in ("deepseek-v2-lite-16b", "command-r-35b", "xlstm-350m"):
        cfg = registry.get_optimized(aid)
        # shapes still resolve (no allocation) and every param leaf
        # carries a rank-matching axes tuple
        vals, axes = model_zoo.param_specs(cfg)
        flat_a = []
        ps.map_axes(lambda a, v: flat_a.append((a, v)), axes, vals)
        assert len(flat_a) == len(leaves(vals))
        for a, v in flat_a:
            assert is_axes(a) and len(a) == v.dim()


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_get_optimized_matches_reference(arch_id):
    got = dataclasses.asdict(registry.get_optimized(arch_id))
    ref = dataclasses.asdict(jax_registry.get_optimized(arch_id))
    assert got == ref


class _A2ACount(TorchDispatchMode):
    """Counts the all_to_all collectives dispatched while ``on``."""

    def __init__(self):
        super().__init__()
        self.n, self.on = 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.on and "all_to_all" in str(func):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, params, batch):
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    with _A2ACount() as count:
        loss, _ = train_step.loss_fn(unflatten(params, req), batch, cfg)
        count.on = True
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss, grads, count.n


def test_named_remat_policies_match_none(host_mesh):
    """deepseek-v2-lite ``reduced()`` with the smap MoE (3 MoE layers)
    under the host mesh: every named policy gives the loss and the
    gradients of ``remat="none"`` bitwise.  The backward's all_to_alls
    are only the transposes (2 a MoE layer, as without remat) under
    ``dots_names`` and ``full_names``, which keep the named a2a results;
    ``boundaries`` keeps only the block outputs, so its recompute
    re-runs each MoE layer's two forward all_to_alls, and so does
    ``full``."""
    base = registry.get("deepseek-v2-lite-16b").reduced()
    n_moe = base.n_layers - base.moe.n_dense_layers
    params = model_zoo.init(base, 0, device=CPU, dtype=torch.float32)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, base.vocab_size, (2, 8)))
             for k in ("tokens", "labels")}
    moe = dataclasses.replace(base.moe, shard_mode="smap", dispatch="onehot",
                              capacity_factor=8.0, overflow_passes=0)
    out = {}
    with ps.use_mesh(host_mesh):
        for remat in ("none", "dots_names", "full_names", "boundaries",
                      "full"):
            cfg = base.replace(moe=moe, parallel=dataclasses.replace(
                base.parallel, remat=remat))
            out[remat] = _loss_and_grads(cfg, params, batch)
    loss0, g0, n0 = out["none"]
    assert n0 == 2 * n_moe
    for remat, (loss, g, n) in out.items():
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), remat
        want = n0 if remat in ("none", "dots_names", "full_names") \
            else 2 * n0
        assert n == want, (remat, n)


def test_smap_on_a_2x2_mesh_in_four_processes(tmp_path):
    """4 CPU processes, mesh (data 2, model 2): each rank's output of the
    smap MoE (its 2 rows, experts split over data, the FFN dim over
    model) gathered by data coordinate matches the dense MoE on the
    whole batch; the model replicas agree bitwise; the aux loss is the
    whole batch's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", store, outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [torch.load(o) for o in outs]
    params, x, cfgs = moe_case(4)
    assert sorted((r["data"], r["model"]) for r in res) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for disp in cfgs:
        y0, a0 = moe_mod.moe_ffn(params, x, CFG)
        by = {}
        for r in res:
            by.setdefault(r["data"], []).append(r[disp])
        for (ya, aa), (yb, ab) in by.values():
            assert torch.equal(ya, yb) and torch.equal(aa, ab)
        y = torch.cat([by[d][0][0] for d in sorted(by)])
        _close(y0, y, 1e-5, 1e-4)
        np.testing.assert_allclose(float(a0), float(by[0][0][1]), rtol=1e-5)


def test_smap_decode_step_through_the_model(host_mesh):
    """The optimized preset of deepseek-v2-lite at ``reduced()`` under
    the host mesh: a greedy generate runs the smap MoE in its prefill
    and every step (one dispatch group a call), finite logits."""
    from repro_torch.serve.serve_step import generate
    cfg = registry.get_optimized("deepseek-v2-lite-16b").reduced()
    assert cfg.moe.shard_mode == "smap"
    params = model_zoo.init(cfg, 0, device=CPU)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))
    calls = []
    real = moe_mod.moe_ffn

    def spy(p, x, c):
        calls.append(tuple(x.shape))
        return real(p, x, c)

    with ps.use_mesh(host_mesh), torch.inference_mode():
        moe_mod.moe_ffn = spy
        try:
            toks = generate(cfg, params, prompt, 3)
        finally:
            moe_mod.moe_ffn = real
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert toks.shape == (2, 4)
    assert calls == [(2, 8, cfg.d_model)] * n_moe + \
        [(2, 1, cfg.d_model)] * (3 * n_moe)
