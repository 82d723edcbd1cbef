"""The port's sharding rules (``repro_torch.parallel.sharding``), meshes
(``launch.mesh``), axes trees (``launch.shardings``) and shape
stand-ins (``model_zoo.param_specs`` / ``input_specs``) against the
JAX reference on the CPU: the counterparts of ``tests/test_sharding.py``
for every arch it parametrises over, and more.

Every process group a test makes is destroyed in its fixture's
teardown (``launch.mesh.release``), so the next test file on the same
worker starts with none.
"""
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
from repro_torch.core.tree import leaves
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.models import blocks, model_zoo
from repro_torch.parallel import sharding as ps

CPU = torch.device("cpu")


@pytest.fixture
def host_mesh():
    mesh = mesh_mod.make_host_mesh(device="cpu")
    yield mesh
    mesh_mod.release()
    assert not dist.is_initialized()


@pytest.fixture
def production_mesh(request):
    mesh = mesh_mod.make_production_mesh(multi_pod=request.param)
    yield mesh
    mesh_mod.release()
    assert not dist.is_initialized()


class _Sizes:
    """A mesh stand-in for the reference's ``spec_for``: axis sizes."""

    def __init__(self, mesh):
        self.shape = ps.mesh_shape(mesh)


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(e, int) for e in x)


def _is_spec(x):
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _unstack(ref_tree, cfg, is_leaf):
    """A reference tree (of axes, shapes or specs) in the port's layout:
    each stacked group (encoder / decoder layer) becomes a list of
    per-layer trees, each leaf without its first entry (the stacked
    ``"layers"`` axis)."""
    strip = jax.tree.map(lambda x: x[1:], ref_tree, is_leaf=is_leaf)
    out = dict(ref_tree)
    if cfg.is_encoder_decoder:
        out["enc_layers"] = [strip["enc_layers"]] * cfg.n_enc_layers
        out["dec_layers"] = [strip["dec_layers"]] * cfg.n_layers
    else:
        _, _, n_groups = blocks.group_layout(cfg)
        out["stack"] = dict(ref_tree["stack"],
                            groups=[strip["stack"]["groups"]] * n_groups)
    return out


def _shapes(tree):
    """The port's tree with each tensor replaced by its shape."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# the rules (tests/test_sharding.py)
# ---------------------------------------------------------------------------
def test_spec_for_divisibility_drop(host_mesh):
    rules = ps.default_rules(("data", "model"))
    # everything divides by 1 -> mapping kept
    spec = ps.spec_for(("batch", None, "heads", None),
                       shape=(8, 4, 8, 16), mesh=host_mesh, rules=rules)
    assert spec == ps.PartitionSpec(("data",), None, "model")
    assert tuple(spec) == tuple(jax_ps.spec_for(
        ("batch", None, "heads", None), shape=(8, 4, 8, 16),
        mesh=_Sizes(host_mesh), rules=jax_ps.default_rules(("data",
                                                            "model"))))


def test_spec_for_duplicate_axis_dropped(host_mesh):
    rules = ps.default_rules(("data", "model"))
    spec = ps.spec_for(("mlp", "vocab"), shape=(4, 4), mesh=host_mesh,
                       rules=rules)
    # both map to "model"; second occurrence must drop
    assert spec == ps.PartitionSpec("model")


def test_shard_act_noop_without_mesh():
    x = torch.ones((4, 4))
    assert ps.active_mesh() is None
    assert ps.shard_act(x, ("batch", None)) is x


def test_shard_act_under_a_mesh(host_mesh):
    """A plain tensor (this rank's value) passes unchanged; a DTensor is
    redistributed to the spec's placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.arange(32.0).reshape(8, 4)
    with ps.use_mesh(host_mesh):
        assert ps.active_mesh() is host_mesh
        assert ps.shard_act(x, ("batch", "vocab")) is x
        dx = DTensor.from_local(x, host_mesh, [Replicate(), Replicate()])
        out = ps.shard_act(dx, ("batch", "vocab"))
    assert ps.active_mesh() is None
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert torch.equal(out.full_tensor(), x)


@pytest.mark.parametrize("production_mesh", [False, True], indirect=True,
                         ids=["16x16", "2x16x16"])
def test_spec_for_matches_reference_on_production_mesh(production_mesh):
    """Every rule on the production mesh (a fake group of 256 / 512
    ranks in this process), with the reference's drops, for shapes
    that divide and shapes that do not; and the DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = production_mesh
    names = ps.mesh_axis_names(mesh)
    assert dist.get_world_size() == (512 if "pod" in names else 256)
    for fsdp in (False, True):
        rules = ps.default_rules(names, fsdp=fsdp)
        jrules = jax_ps.default_rules(names, fsdp=fsdp)
        for axes, shape in [
                (("batch", None, "heads", None), (256, 4, 32, 128)),
                (("batch", None, "kv_heads", None), (64, 4, 8, 128)),
                (("embed", "mlp"), (7168, 2048)),
                (("expert", "embed", "mlp"), (384, 7168, 2048)),
                (("vocab", "embed"), (163840, 7168)),
                (("mlp", "vocab"), (64, 64)),
                (("batch", "seq_kv", None), (2, 32768, 512)),
                (("inner", "state"), (16384, 16))]:
            spec = ps.spec_for(axes, shape=shape, mesh=mesh, rules=rules)
            ref = jax_ps.spec_for(axes, shape=shape, mesh=_Sizes(mesh),
                                  rules=jrules)
            assert spec == ps.PartitionSpec(*ref), (axes, shape, fsdp)
            for a, p in zip(names, ps.placements(spec, mesh)):
                hit = [i for i, e in enumerate(spec)
                       if e == a or (isinstance(e, tuple) and a in e)]
                assert p == (Shard(hit[0]) if hit else Replicate())


def test_use_mesh_nests_and_restores(host_mesh):
    with ps.use_mesh(host_mesh, overrides={"seq_kv": "model"}):
        assert ps.spec_for(("batch", "seq_kv"), (2, 4)) == \
            ps.PartitionSpec(("data",), "model")
        with ps.use_mesh(host_mesh, fsdp=True):
            assert ps.spec_for(("embed",), (4,)) == ps.PartitionSpec("data")
        assert ps.spec_for(("embed",), (4,)) == ps.PartitionSpec()
    assert ps.active_mesh() is None


def test_meshes_are_built_and_released():
    assert not dist.is_initialized()
    mesh = mesh_mod.make_host_mesh(model=4, device="cpu")
    try:
        assert ps.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="release it first"):
            mesh_mod.make_production_mesh()
    finally:
        mesh_mod.release()
    assert not dist.is_initialized()
    mesh = mesh_mod.make_production_mesh()
    try:
        assert ps.mesh_shape(mesh) == {"data": 16, "model": 16}
    finally:
        mesh_mod.release()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# parameter axes, caches, optimizer state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_param_specs_axes_and_count_match_reference(arch_id):
    """Every leaf's logical axes are the reference's without the stacked
    ``"layers"`` axis, every stand-in has the reference's per-layer
    shape, nothing is allocated, and the counts are equal."""
    from torch._subclasses.fake_tensor import FakeTensor
    cfg = registry.get(arch_id)
    vals, axes = model_zoo.param_specs(cfg)
    ref_vals, ref_axes = jax_zoo.param_specs(jax_registry.get(arch_id))
    assert axes == _unstack(ref_axes, cfg, jax_sh.is_axes)
    assert _shapes(vals) == _unstack(
        jax.tree.map(lambda v: tuple(v.shape), ref_vals), cfg, _is_shape)
    assert all(isinstance(v, FakeTensor) for v in leaves(vals))
    assert model_zoo.count_params(cfg) == jax_zoo.count_params(
        jax_registry.get(arch_id))


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_cache_axes_structure_matches_caches(arch_id):
    """cache_axes(cfg) must be congruent with the port's cache tree for
    every arch (a decode step's shardings depend on it), every axes
    tuple of the leaf's rank, and the leaves the reference's per-layer
    cache shapes."""
    cfg = registry.get(arch_id)
    assert cfg.supports_decode
    specs = model_zoo.input_specs(cfg, ShapeCell("t", 64, 2, "decode"))
    axes = sh.cache_axes(cfg)
    pairs = []
    ps.map_axes(lambda ax, t: pairs.append((ax, tuple(t.shape))), axes,
                specs["caches"])
    assert len(pairs) == len(leaves(specs["caches"]))
    for ax, shape in pairs:
        assert len(ax) == len(shape), (arch_id, ax, shape)
    ref = jax_zoo.input_specs(jax_registry.get(arch_id),
                              JaxCell("t", 64, 2, "decode"), tp=1)
    ref_c = jax.tree.map(lambda v: tuple(v.shape), ref["caches"])
    port_c = _shapes(specs["caches"])
    if cfg.is_encoder_decoder:
        strip = jax.tree.map(lambda x: x[1:], ref_c, is_leaf=_is_shape)
        assert port_c == {key: [strip[key]] * cfg.n_layers
                          for key in ("self", "cross")}
    else:
        _, _, n_groups = blocks.group_layout(cfg)
        strip = jax.tree.map(lambda x: x[1:], ref_c["groups"],
                             is_leaf=_is_shape)
        # the reference's caches are tuples where the port's recurrent
        # states are tuples too; compare leaf by leaf
        for gc in port_c["groups"]:
            assert jax.tree.leaves(gc, is_leaf=_is_shape) == \
                jax.tree.leaves(strip, is_leaf=_is_shape)
        assert len(port_c["groups"]) == n_groups
        assert port_c.get("prefix", []) == ref_c.get("prefix", [])
    assert tuple(specs["token"].shape) == tuple(ref["token"].shape)
    assert tuple(specs["position"].shape) == tuple(ref["position"].shape)


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_input_specs_batches_match_reference(arch_id):
    """The train / prefill stand-ins: the reference's keys, shapes and
    types, and ``batch_axes`` of each input's rank."""
    cfg = registry.get(arch_id)
    for cell in SHAPES:
        if cell.kind == "decode":
            continue
        specs = model_zoo.input_specs(cfg, cell)
        ref = jax_zoo.input_specs(jax_registry.get(arch_id),
                                  JaxCell(cell.name, cell.seq_len,
                                          cell.global_batch, cell.kind))
        assert set(specs) == set(ref)
        for k, v in specs.items():
            assert tuple(v.shape) == tuple(ref[k].shape)
            assert str(v.dtype).split(".")[-1] == str(ref[k].dtype)
        assert sh.batch_axes(specs) == jax_sh.batch_axes(ref)


@pytest.mark.parametrize("arch_id", ["minitron-8b", "deepseek-v2-lite-16b"])
def test_param_shardings_build(arch_id, host_mesh):
    cfg = registry.get(arch_id)
    vals, axes = model_zoo.param_specs(cfg)
    with ps.use_mesh(host_mesh, fsdp=cfg.parallel.fsdp):
        shard = sh.tree_shardings(axes, vals, host_mesh)
        by_param = ps.param_shardings(axes, vals, host_mesh)
    got = []
    ps.map_axes(lambda ax, s, t: got.append((s, t)), axes, shard, vals)
    assert len(got) == len(leaves(vals))
    for s, t in got:
        assert isinstance(s, ps.NamedSharding) and s.mesh is host_mesh
        assert len(s.spec) <= t.dim()
        assert len(s.placements) == 2
    assert by_param == shard


@pytest.mark.parametrize("production_mesh", [False], indirect=True,
                         ids=["16x16"])
@pytest.mark.parametrize("arch_id", ["minitron-8b", "deepseek-v2-lite-16b",
                                     "kimi-k2-1t-a32b"])
def test_param_shardings_match_reference_on_production_mesh(
        arch_id, production_mesh):
    """Each parameter's spec on the 16x16 mesh is the reference's spec of
    its stacked leaf without the (replicated) layer entry."""
    cfg = registry.get(arch_id)
    vals, axes = model_zoo.param_specs(cfg)
    shard = ps.param_shardings(
        axes, vals, production_mesh,
        rules=ps.default_rules(("data", "model"), fsdp=cfg.parallel.fsdp))
    jcfg = jax_registry.get(arch_id)
    ref_vals, ref_axes = jax_zoo.param_specs(jcfg)
    jrules = jax_ps.default_rules(("data", "model"), fsdp=jcfg.parallel.fsdp)
    ref = jax.tree.map(
        lambda ax, v: tuple(ps.PartitionSpec(*jax_ps.spec_for(
            ax, shape=v.shape, mesh=_Sizes(production_mesh),
            rules=jrules))),
        ref_axes, ref_vals, is_leaf=jax_sh.is_axes)
    got = ps.map_axes(lambda ax, s: tuple(s.spec), axes, shard)
    # a stacked leaf's spec starts with its layer axis' entry, None
    assert got == _unstack(ref, cfg, _is_spec)


def test_opt_state_axes_adafactor_ranks():
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    cfg = registry.get("minitron-8b")
    vals, axes = model_zoo.param_specs(cfg)
    oax = sh.opt_state_axes(axes, vals, "adafactor")
    flat_v = leaves(vals)
    flat_vr = []
    ps.map_axes(lambda ax: flat_vr.append(ax), oax["vr"])
    for sd, ax in zip(flat_v, flat_vr):
        want = len(sd.shape) - 1 if (len(sd.shape) >= 2 and
                                     sd.shape[-1] > 1 and
                                     sd.shape[-2] > 1) else len(sd.shape)
        assert len(ax) == want
    # congruent with the optimizer's own state, leaf by leaf
    small = registry.get("deepseek-v2-lite-16b").reduced()
    params = model_zoo.init(small, 0, device=CPU, dtype=torch.float32)
    _, small_axes = model_zoo.param_specs(small)
    for kind in ("adafactor", "adamw"):
        state = init_opt_state(OptConfig(kind=kind), params)
        oax = sh.opt_state_axes(small_axes, params, kind)
        assert set(oax) == set(state)
        for key in state:
            if key == "count":
                assert oax[key] == () and state[key].dim() == 0
                continue
            ranks = []
            ps.map_axes(lambda ax, t: ranks.append((len(ax), t.dim())),
                        oax[key], state[key])
            assert ranks and all(a == b for a, b in ranks)


def test_mesh_forward_and_decode_bitwise_no_mesh(host_mesh):
    """A decoder's prefill and decode steps under ``use_mesh`` (a
    one-device host mesh, plain tensors) give the no-mesh logits
    bitwise: deepseek's MLA + MoE and jamba's mamba at ``reduced()``."""
    for arch_id in ("deepseek-v2-lite-16b", "jamba-1.5-large-398b"):
        cfg = registry.get(arch_id).reduced()
        params = model_zoo.init(cfg, 0, device=CPU)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)))
        outs = []
        for mesh in (None, host_mesh):
            with torch.no_grad():
                if mesh is not None:
                    ctx = ps.use_mesh(mesh)
                    ctx.__enter__()
                try:
                    logits, caches = model_zoo.prefill(
                        cfg, params, {"tokens": tokens}, 12)
                    seq = [logits]
                    tok = logits[:, -1:].argmax(-1)
                    for t in range(4):
                        step, caches = model_zoo.decode_step(
                            cfg, params, tok, caches, 8 + t)
                        seq.append(step)
                        tok = step[:, -1:].argmax(-1)
                finally:
                    if mesh is not None:
                        ctx.__exit__(None, None, None)
            outs.append(seq)
        for a, b in zip(*outs):
            assert torch.equal(a, b), arch_id
