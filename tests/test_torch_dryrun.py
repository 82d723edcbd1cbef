"""The port's dry-run (``repro_torch.launch.dryrun``) on the fake 16x16
and 2x16x16 meshes, on the CPU: its accounting of collectives, FLOPs and
argument bytes, held to the reference's ``spec_for`` and
``launch.analytic``; the one fake mode of ``param_specs`` and
``input_specs``; the one-device mesh bitwise; and the CLI.

The reference's own dry-run cannot be the oracle here: on this jax its
``make_mesh`` gives Explicit axes, which its ``shard_act`` refuses, so
every reference cell fails (``tests/test_system.py``'s CLI test among
the reference's known failures).  Every test leaves no process group
behind.
"""
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeCell as JaxCell
from repro.launch import shardings as jax_sh
from repro.models import model_zoo as jax_zoo
from repro.parallel import sharding as jax_ps
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.launch import analytic, dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model_zoo
from repro_torch.parallel import sharding as ps

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    mesh_mod.release()
    assert not dist.is_initialized()


@pytest.fixture
def mesh(request):
    m = mesh_mod.make_production_mesh(multi_pod=getattr(request, "param",
                                                        False))
    yield m
    mesh_mod.release()


class _Sizes:
    """A mesh stand-in for the reference's ``spec_for``: axis sizes."""

    def __init__(self, mesh):
        self.shape = ps.mesh_shape(mesh)


def _cut(cfg, n_layers):
    """``cfg`` at ``n_layers`` decoder layers (and encoder layers)."""
    if cfg.is_encoder_decoder:
        return cfg.replace(n_layers=n_layers, n_enc_layers=n_layers)
    return cfg.replace(n_layers=n_layers)


# ---------------------------------------------------------------------------
# (i), (ii): the accounting
# ---------------------------------------------------------------------------
def test_shard_to_shard_counts_one_all_to_all(mesh):
    """A Shard(0) -> Shard(1) transition over 'model' is one all-to-all
    of its result bytes (DTensor runs it on the CPU mesh as an
    all-gather and a chunk); a Partial -> Replicate one an all-reduce of
    its result bytes; a Shard -> Replicate one an all-gather."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with model_zoo.fake_mode() as fm:
        x = DTensor.from_local(torch.empty(8, 64, 32), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        p = DTensor.from_local(torch.empty(128, 48), mesh,
                               [Replicate(), Partial()], run_check=False)
        with dryrun.accounting(fm) as acct:
            y = x.redistribute(mesh, [Shard(0), Shard(2)])
        assert tuple(y.to_local().shape) == (8, 1024, 2)
        assert acct.coll == {"all-to-all": 8 * 1024 * 2 * 4}
        with dryrun.accounting(fm) as acct:
            r = p.redistribute(mesh, [Replicate(), Replicate()])
        assert acct.coll == {"all-reduce": 128 * 48 * 4}
        assert tuple(r.to_local().shape) == (128, 48)
        with dryrun.accounting(fm) as acct:
            g = x.redistribute(mesh, [Shard(0), Replicate()])
        assert acct.coll == {"all-gather": 8 * 1024 * 32 * 4}
        assert tuple(g.to_local().shape) == (8, 1024, 32)
    dryrun.check_accounting(mesh)


@pytest.mark.parametrize("mesh", [False, True], indirect=True,
                         ids=["16x16", "2x16x16"])
def test_split_matmul_counts_local_flops_once(mesh):
    """A (256, 1024) @ (1024, 4096) product split (data, model) counts
    rank 0's local 2 * 16 * 1024 * 256 FLOPs once: not the global
    product's, not both."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    rest = [Replicate()] * (mesh.ndim - 2)
    with model_zoo.fake_mode() as fm:
        a = DTensor.from_local(torch.empty(16, 1024), mesh,
                               rest + [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(1024, 256), mesh,
                               rest + [Replicate(), Shard(1)],
                               run_check=False)
        with dryrun.accounting(fm) as acct:
            c = a @ b
        assert tuple(c.shape) == (256, 4096)
    assert acct.flops == 2 * 16 * 1024 * 256 == 8388608
    assert acct.coll == {}


# ---------------------------------------------------------------------------
# (iii): argument bytes against the reference's spec_for
# ---------------------------------------------------------------------------
def _ref_shard_bytes(axes_tree, vals_tree, mesh, rules, float_bytes=None):
    """The reference's per-device bytes of a (stand-in, axes) tree: each
    leaf's shard under its ``spec_for``."""
    sizes = ps.mesh_shape(mesh)
    total = 0

    def one(ax, v):
        nonlocal total
        spec = jax_ps.spec_for(ax, shape=v.shape, mesh=_Sizes(mesh),
                               rules=rules)
        shape = list(v.shape)
        for i, entry in enumerate(spec):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                shape[i] //= sizes[a]
        word = (float_bytes if float_bytes and
                np.issubdtype(v.dtype, np.floating) else v.dtype.itemsize)
        total += math.prod(shape) * word

    jax.tree.map(one, axes_tree, vals_tree, is_leaf=jax_sh.is_axes)
    return total


@pytest.mark.parametrize("mesh", [False, True], indirect=True,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,mode", [
    ("h2o-danube-1.8b", None), ("deepseek-v2-lite-16b", "ep"),
    ("deepseek-v2-lite-16b", "smap")])
def test_argument_bytes_are_reference_shard_bytes(mesh, arch_id, mode):
    """At depth 1, a prefill cell's per-device argument bytes are,
    exactly, the sum of the shard bytes that the reference's
    ``spec_for`` gives its parameter stand-ins (in bf16, as its dry-run
    casts them) and its batch, under the reference's rules for the
    cell."""
    import dataclasses
    cfg = registry.get(arch_id)
    jcfg = jax_registry.get(arch_id)
    if mode == "smap":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  shard_mode="smap"))
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    shard_mode="smap"))
    n = 1 + (cfg.moe.n_dense_layers if cfg.moe else 0)
    cfg, jcfg = cfg.replace(n_layers=n), jcfg.replace(n_layers=n)
    cell = ShapeCell("prefill_t", 256, 64, "prefill")
    names = ps.mesh_axis_names(mesh)
    jrules = jax_ps.default_rules(names, fsdp=jcfg.parallel.fsdp)
    if mode == "smap":
        jrules["expert"] = "data"
    assert dryrun.cell_rules(cfg, mesh) == jrules

    with model_zoo.fake_mode():
        _, args, _ = dryrun.build_cell(cfg, cell, mesh)
    ref_vals, ref_axes = jax_zoo.param_specs(jcfg)
    want_params = _ref_shard_bytes(ref_axes, ref_vals, mesh, jrules,
                                   float_bytes=2)
    ispecs = jax_zoo.input_specs(jcfg, JaxCell(cell.name, cell.seq_len,
                                               cell.global_batch, "prefill"))
    bspec = {k: v for k, v in ispecs.items() if k != "labels"}
    want_batch = _ref_shard_bytes(jax_sh.batch_axes(bspec), bspec, mesh,
                                  jrules)
    assert dryrun.local_bytes(args[0]) == want_params
    assert dryrun.local_bytes(args[1]) == want_batch
    assert dryrun.local_bytes(args) == want_params + want_batch


# ---------------------------------------------------------------------------
# the cells the tests trace, and (v): FLOPs against the closed form
# ---------------------------------------------------------------------------
# (arch, kind) -> traced FLOPs x 256 devices over ``analytic.hlo_flops``
# at depth 1 (after the dense prefix) and the cells below.  The trace
# counts matmul FLOPs only; the formula counts the same products:
#   h2o prefill / decode: 1 exactly.  The projections, the MLP, the
#   unembedding and the attention products agree term by term (at
#   T <= the window the formula's window is the whole sequence, and
#   ``_sdpa`` multiplies every (query, key) pair, as the formula does).
#   h2o train: the forward's terms agree; the backward's weight
#   gradients run on the layouts DTensor picks, and some are computed
#   on operands replicated over 'model' (a (2560, 2560) gradient on
#   every model rank), which the formula's 2x-forward backward does
#   not count; the formula's optimizer (10 FLOPs a parameter) is
#   elementwise, which the trace does not count.
#   whisper: its 6 heads do not split 16 ways, so every model rank runs
#   all of the attention and its vocabulary (51865) does not split
#   either: each rank computes the whole unembedding.
#   deepseek: the MoE's capacity passes compute the padded capacity
#   buffers (C and the tail's C // 4 rows per expert and row), not the
#   formula's effective k; the absorbed MLA decode multiplies through
#   the latent rank, which the formula's expanded form does not.
FLOP_RATIOS = {
    ("h2o-danube-1.8b", "train"): 1.2147587421502133,
    ("h2o-danube-1.8b", "prefill"): 1.0,
    ("h2o-danube-1.8b", "decode"): 1.0,
    ("whisper-tiny", "train"): 14.039411000803176,
    ("whisper-tiny", "prefill"): 13.632847309835988,
    ("whisper-tiny", "decode"): 1.2396769286170988,
    ("deepseek-v2-lite-16b", "train"): 1.2682114943746134,
    ("deepseek-v2-lite-16b", "prefill"): 1.0931372549019607,
    ("deepseek-v2-lite-16b", "decode"): 3.6676470588235293,
}
SMALL = {"train": ShapeCell("train_t", 128, 32, "train"),
         "prefill": ShapeCell("prefill_t", 128, 32, "prefill"),
         "decode": ShapeCell("decode_t", 128, 32, "decode")}


@pytest.mark.parametrize("arch_id,kind", sorted(FLOP_RATIOS))
def test_traced_flops_against_analytic(arch_id, kind, mesh):
    cfg = registry.get(arch_id)
    n = 1 + (cfg.moe.n_dense_layers if cfg.moe else 0)
    cfg = _cut(cfg, n)
    cell = SMALL[kind]
    r = dryrun.trace_cell(cfg, cell, mesh)
    ratio = r["flops"] * mesh.size() / analytic.hlo_flops(cfg, cell)
    print(arch_id, kind, repr(ratio))
    assert ratio == pytest.approx(FLOP_RATIOS[(arch_id, kind)], rel=1e-12)


# ---------------------------------------------------------------------------
# one fake mode; the one-device mesh; the CLI
# ---------------------------------------------------------------------------
def test_param_and_input_specs_go_into_one_step():
    """``param_specs`` and ``input_specs`` called in one fake mode make
    stand-ins of that mode: a one-layer step takes both, with no mesh,
    and allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensor
    cfg = registry.get("h2o-danube-1.8b").replace(n_layers=1)
    cell = next(c for c in SHAPES if c.name == "prefill_32k")
    with model_zoo.fake_mode() as fm:
        params, _ = model_zoo.param_specs(cfg)
        batch = model_zoo.input_specs(cfg, cell)
        assert params["embed"]["table"].fake_mode is fm
        assert batch["tokens"].fake_mode is fm
        logits, caches = model_zoo.prefill(cfg, params, batch, cell.seq_len)
    assert isinstance(logits, FakeTensor)
    assert tuple(logits.shape) == (32, 32768, cfg.vocab_size)
    assert tuple(caches["groups"][0]["l0"]["k"].shape) == (32, 4096, 8, 80)


@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b", "minicpm3-4b",
                                     "deepseek-v2-lite-16b", "whisper-tiny"])
def test_one_device_mesh_logits_bitwise(arch_id):
    """With the mesh changes (head views, local blocks, residual
    constraints, the row-local norm) a run with no mesh and a run on the
    one-device mesh are bitwise equal (plain tensors under the mesh, as
    ``chip_smoke.py``'s mesh check runs); DTensor parameters and inputs
    replicated on that mesh give the same logits within bf16
    roundings."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.tree import tree_map
    cfg = registry.get(arch_id).reduced()
    params = model_zoo.init(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    if cfg.is_encoder_decoder:
        batch = {"frames": torch.randn(2, 16, cfg.d_model, generator=gen
                                       ).to(torch.bfloat16),
                 "dec_tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                             generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=gen)}
    with torch.no_grad():
        want, _ = model_zoo.forward(cfg, params, batch)
        mesh = mesh_mod.make_host_mesh(device="cpu")
        try:
            with ps.use_mesh(mesh):
                plain, _ = model_zoo.forward(cfg, params, batch)

                def rep(t):
                    return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                              run_check=False)
                # plain tensors made inside act as replicated, as in
                # the dry-run's trace
                with implicit_replication():
                    dt, _ = model_zoo.forward(cfg, tree_map(rep, params),
                                              tree_map(rep, batch))
        finally:
            mesh_mod.release()
    assert torch.equal(plain, want)
    # the DTensor run dispatches through DTensor's decompositions (the
    # same model, bf16 roundings in another order): within bf16 ulps
    assert isinstance(dt, DTensor)
    torch.testing.assert_close(dt.full_tensor().float(), want.float(),
                               atol=3e-2, rtol=2e-2)


def test_dryrun_cli_single_cell():
    """The counterpart of ``tests/test_system.py::
    test_dryrun_cli_single_cell``: whisper-tiny's decode_32k on the
    16x16 mesh, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert " OK " in out.stdout
    assert "cuda initialized: False" in out.stdout


# ---------------------------------------------------------------------------
# the MoE's grouped matmuls on rank-local blocks (``grouped_blocks``)
# ---------------------------------------------------------------------------
def _fake_cuda_mesh():
    """A fake 16x16 mesh of 'cuda' devices over the fake process group
    (no card is touched: its tensors are fake)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    return DeviceMesh("cuda", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))


def test_cuda_dtensor_grouped_matmul_reaches_k8_or_raises(monkeypatch):
    """A grouped matmul of DTensors on 'cuda': through ``grouped_blocks``
    (the MoE layer's route) K8's wrapper gets each rank's plain local
    blocks; handed the DTensors themselves, the wrapper raises before
    any launch (a DTensor's pointer is 0)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import common
    from repro_torch.kernels.gmm import ops as gmm_ops
    calls = []

    def spy(x, w, entry=None):
        calls.append((type(x), type(w), tuple(x.shape), tuple(w.shape),
                      x.device.type))
        return torch.empty(x.shape[0], x.shape[1], w.shape[2],
                           dtype=x.dtype, device=x.device)

    try:
        mesh = _fake_cuda_mesh()
        with model_zoo.fake_mode(), ps.use_mesh(mesh):
            # expert-parallel over 'model', rows over 'data'
            x = DTensor.from_local(
                torch.empty(64, 32, 64, dtype=torch.bfloat16, device="cuda"),
                mesh, [Shard(1), Replicate()], run_check=False)
            w = DTensor.from_local(
                torch.empty(4, 64, 128, dtype=torch.bfloat16, device="cuda"),
                mesh, [Replicate(), Shard(0)], run_check=False)
            monkeypatch.setattr(gmm_ops, "gmm_cuda", spy)
            y = ps.grouped_blocks(gmm_ops.gmm_model, x, w)
            monkeypatch.undo()
            assert calls == [(FakeTensor, FakeTensor, (4, 32, 64),
                              (4, 64, 128), "cuda")]
            assert isinstance(y, DTensor)
            assert tuple(y.shape) == (64, 512, 128)
            assert tuple(y.placements) == (Shard(1), Shard(0))
            before = common.launch_counts()["gmm"]
            with pytest.raises(ValueError, match="no memory of its own"):
                gmm_ops.gmm_model(x, w)
            assert common.launch_counts()["gmm"] == before
    finally:
        dist.destroy_process_group()


# (x placements, w placements, x local shape, w local shape, result
# placements) on the 16x16 mesh for x (64, 512, 1024), w (64, 1024, 256)
_GROUPED = {
    # expert-parallel: w's experts over 'model', x's rows over 'data'
    "ep": (("S1", "R"), ("R", "S0"), (4, 32, 1024), (4, 1024, 256),
           ("S1", "S0")),
    # x's rows over 'data' dispatched to w's experts there (all-to-all),
    # w's columns over 'model'
    "tp": (("S1", "R"), ("S0", "S2"), (4, 512, 1024), (4, 1024, 16),
           ("S0", "S2")),
    # row-parallel: x and w split D over 'model', a partial result
    "row": (("S1", "S2"), ("R", "S1"), (64, 32, 64), (64, 64, 256),
            ("S1", "P")),
    # ZeRO-3: w's D over 'data' where x splits its rows there: x's and
    # the result's bytes (320 KiB a rank) are under the gathered
    # weights' (2 MiB), so x moves to a split of D, the result partial
    "zero3": (("S1", "S0"), ("S1", "S0"), (4, 512, 64), (4, 64, 256),
              ("P", "S0")),
}


def _placement(code):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return (Replicate() if code == "R" else Partial() if code == "P"
            else Shard(int(code[1])))


@pytest.mark.parametrize("case", sorted(_GROUPED))
def test_grouped_blocks_layouts(case, mesh):
    """``grouped_blocks`` gives each rank the blocks the docstring's
    rules name, counts no FLOP twice (rank 0's local product only) and
    lays the result out over the split it kept."""
    from torch.distributed.tensor import DTensor
    xp, wp, x_loc, w_loc, op = _GROUPED[case]
    shapes = []

    def fn(x, w):
        shapes.append((tuple(x.shape), tuple(w.shape)))
        return torch.bmm(x, w)

    with model_zoo.fake_mode() as fm:
        x = DTensor.from_local(
            torch.empty(*_local((64, 512, 1024), xp), dtype=torch.bfloat16),
            mesh, [_placement(p) for p in xp], run_check=False)
        w = DTensor.from_local(
            torch.empty(*_local((64, 1024, 256), wp), dtype=torch.bfloat16),
            mesh, [_placement(p) for p in wp], run_check=False)
        with ps.use_mesh(mesh), dryrun.accounting(fm) as acct:
            y = ps.grouped_blocks(fn, x, w)
    assert shapes == [(x_loc, w_loc)]
    assert tuple(y.placements) == tuple(_placement(p) for p in op)
    assert tuple(y.shape) == (64, 512, 256)
    assert acct.flops == 2 * x_loc[0] * x_loc[1] * x_loc[2] * w_loc[2]


def _local(shape, codes):
    shape = list(shape)
    for c in codes:
        if c.startswith("S"):
            shape[int(c[1])] //= 16
    return shape


def test_grouped_blocks_zero3_gathers_weights_for_many_rows(mesh):
    """ZeRO-3 with many rows (a training step's): gathering the weights
    moves fewer bytes than moving the rows and the result, so ``w`` is
    gathered over 'data' and x keeps its rows."""
    from torch.distributed.tensor import DTensor, Shard
    shapes = []

    def fn(x, w):
        shapes.append((tuple(x.shape), tuple(w.shape)))
        return torch.bmm(x, w)

    with model_zoo.fake_mode():
        x = DTensor.from_local(torch.empty(4, 4096, 1024,
                                           dtype=torch.bfloat16), mesh,
                               [Shard(1), Shard(0)], run_check=False)
        w = DTensor.from_local(torch.empty(4, 64, 256,
                                           dtype=torch.bfloat16), mesh,
                               [Shard(1), Shard(0)], run_check=False)
        with ps.use_mesh(mesh):
            y = ps.grouped_blocks(fn, x, w)
    assert shapes == [((4, 4096, 1024), (4, 1024, 256))]
    assert tuple(y.placements) == (Shard(1), Shard(0))


def test_grouped_blocks_plain_tensors_are_one_call():
    """Without a mesh, and for plain tensors under one, ``grouped_blocks``
    is ``fn(x, w)`` itself."""
    x, w = torch.randn(2, 3, 4), torch.randn(2, 4, 5)
    assert torch.equal(ps.grouped_blocks(torch.bmm, x, w), torch.bmm(x, w))
    mesh = mesh_mod.make_host_mesh(device="cpu")
    try:
        with ps.use_mesh(mesh):
            assert torch.equal(ps.grouped_blocks(torch.bmm, x, w),
                               torch.bmm(x, w))
    finally:
        mesh_mod.release()


def test_grouped_blocks_weight_gradient_is_summed_over_rows(mesh):
    """Expert-parallel over 'model', rows over 'data': each data rank's
    rows give a part of the expert weights' gradient, so the backward
    sums it over 'data' (one all-reduce of the weights' local bytes)
    and returns it in the weights' own layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with model_zoo.fake_mode() as fm:
        x = DTensor.from_local(torch.empty(64, 32, 1024,
                                           dtype=torch.bfloat16,
                                           requires_grad=True), mesh,
                               [Shard(1), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(4, 1024, 256,
                                           dtype=torch.bfloat16,
                                           requires_grad=True), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with ps.use_mesh(mesh):
            y = ps.grouped_blocks(torch.bmm, x, w)
            with dryrun.accounting(fm) as acct:
                gw, = torch.autograd.grad(y, [w], torch.ones_like(y))
    assert tuple(gw.placements) == (Replicate(), Shard(0))
    assert acct.coll == {"all-reduce": 4 * 1024 * 256 * 2}
