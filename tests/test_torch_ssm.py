"""The port's mamba block (``repro_torch.models.ssm``) and jamba-1.5-large
against the JAX reference on the CPU.

Parameters come from the reference's ``model_zoo.init`` and cross over
as numpy arrays (``models.from_jax.params_from_numpy``); inputs are made
with numpy from a seed.  Tolerances:

* ``mamba`` (with its cache) and ``mamba_decode`` in f32: 2e-5
  absolute, 2e-4 relative (``tests/test_models.py``);
* jax.nn's ``softplus`` / ``log_sigmoid`` formulas, op by op in f32
  and bf16: within two ulps of the type (each library's ``exp`` and
  ``log1p``), the formula's region past 20 included;
* jamba-1.5-large ``reduced()`` in bf16, at the reference's bf16 model
  tolerance (atol 0.25, rtol 0.1), the reference run op by op
  (``jax.disable_jit()``) with its prefill attention pinned to its
  unblocked f32 oracle (what K7 computes).  Each MoE layer takes the
  reference's top-2 experts (the port's own choices are recorded and
  may differ only at a near tie of the reference's router, under
  ``ROUTER_TIE``): the f32 ``exp`` of XLA and of PyTorch differ by an
  ulp in ~9% of mamba's ``dA``, the bf16 activations then differ by an
  ulp here and there, and at this width the drift that adds up over
  eight random layers moves a near-tie of a top-2 router;
* a decode step at a (B,) position tensor: bitwise the B one-row steps
  at each row's ``int`` position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import (ArchConfig, MoEConfig, ParallelConfig,
                                SSMConfig)
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.models import ssm as jax_ssm
from repro_torch.configs import registry
from repro_torch.models import blocks, layers, model_zoo, moe, ssm
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from repro_torch.serve import continuous
from torch_ref_pin import ref_op_by_op, ref_pinned

JAMBA = "jamba-1.5-large-398b"
BF16_ATOL, BF16_RTOL = 0.25, 0.1
F32_ATOL, F32_RTOL = 2e-5, 2e-4
# a top-2 choice of the port may differ from the reference's only where
# the reference's 2nd and 3rd router probabilities are this close
ROUTER_TIE = 0.01
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ids(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL,
                               rtol=F32_RTOL, err_msg=what)


def _pair(dtype=torch.float32):
    jcfg = jax_registry.get(JAMBA).reduced()
    cfg = registry.get(JAMBA).reduced()
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                             device="cpu", dtype=dtype)
    return jcfg, jtree, cfg, tree


def _mamba(tree, jtree, i=0):
    return (tree["stack"]["groups"][0][f"l{i}"]["mix"],
            jax.tree.map(lambda a: a[0], jtree["stack"]["groups"])
            [f"l{i}"]["mix"])


# -------------------------------------------------------------- layout
def test_init_has_the_references_tree():
    """The port's random init builds the reference's tree: the same
    shapes; bf16 weights, ``D`` and ``conv_b`` (cast to the
    activations' type at use); f32 norms and ``A_log`` (cast to f32 at
    use), whose S4D-real values are the reference's within an f32 ulp
    (each library's ``log``)."""
    jcfg, jtree, cfg, _ = _pair()
    ref = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                            device="cpu", dtype=torch.bfloat16)
    mine = model_zoo.init(cfg, 2, device="cpu")

    def shapes(tree, path=""):
        if isinstance(tree, torch.Tensor):
            return {path: (tuple(tree.shape), tree.dtype)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in shapes(sub, f"{path}/{key}").items()}

    assert shapes(mine) == shapes(ref)
    for tree in (mine, ref):
        mix = tree["stack"]["groups"][0]["l0"]["mix"]
        assert mix["A_log"].dtype == torch.float32
        assert mix["D"].dtype == mix["conv_b"].dtype == torch.bfloat16
    torch.testing.assert_close(
        mine["stack"]["groups"][0]["l0"]["mix"]["A_log"],
        ref["stack"]["groups"][0]["l0"]["mix"]["A_log"], rtol=2.0 ** -23,
        atol=0)


def test_group_layout_is_the_references():
    """jamba's 8-layer group (attention at offset 4, MoE on odd layers),
    full and reduced, and the cut the chip check runs (one group's
    first five layers: ``n_layers=5, attn_every=5``)."""
    from repro.models import blocks as jax_blocks
    from repro_torch.models import transformer
    full = registry.get(JAMBA)
    for c, jc in ((full, jax_registry.get(JAMBA)),
                  (full.reduced(), jax_registry.get(JAMBA).reduced())):
        assert blocks.group_layout(c) == jax_blocks.group_layout(jc)
        assert transformer._has_attn(c)
    cut = full.replace(n_layers=5, attn_every=5)
    assert blocks.group_layout(cut) == (
        ["mamba"] * 4 + ["attn"], [False, True, False, True, False], 1)
    assert ssm._dims(full) == (16384, 16, 4, 512)


# ------------------------------------------------------ the formulas
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softplus_and_log_sigmoid_are_jaxs(dtype):
    """jax.nn.softplus (``logaddexp(x, 0)``) and log_sigmoid
    (``-softplus(-x)``), op by op in the input's type, over [-40, 40]
    (F.softplus turns linear past its threshold of 20), inf and NaN."""
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        [np.inf, -np.inf, np.nan]]).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tx = _t(x).to(dtype)
    jx = jnp.asarray(x, jdt)
    with jax.disable_jit():
        want = [jax.nn.softplus(jx), jax.nn.log_sigmoid(jx)]
    for got, ref in zip([layers.softplus(tx), layers.log_sigmoid(tx)], want):
        assert got.dtype == dtype
        a, b = _np(got), _np(ref)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        # two ulps of the type at the value
        ulps = 2.0 * (2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7)
        np.testing.assert_allclose(a[ok], b[ok], rtol=ulps, atol=0)


# ---------------------------------------------------------- the block
def test_mamba_matches_reference_f32():
    """The full-sequence block and its cache (the pre-conv stream's last
    ``d_conv - 1`` inputs, the final state), in f32; a prompt shorter
    than the conv window pads the conv state on the left."""
    jcfg, jtree, cfg, tree = _pair()
    mix, jmix = _mamba(tree, jtree)
    rng = np.random.default_rng(1)
    for T in (9, 2):
        x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
        y, cache = ssm.mamba(mix, _t(x), cfg, make_cache=True)
        jy, jcache = jax_ssm.mamba(jmix, jnp.asarray(x), jcfg,
                                   make_cache=True)
        _close(y, jy, f"T={T}")
        for key in ("conv", "h"):
            assert cache[key].shape == jcache[key].shape
            _close(cache[key], jcache[key], f"T={T} {key}")
    y, cache = ssm.mamba(mix, _t(x), cfg)
    assert cache is None


def test_mamba_decode_matches_reference_f32():
    """Decode steps from the prefill's cache and from ``init_caches``'
    empty one, in f32; each step writes the cache in place."""
    jcfg, jtree, cfg, tree = _pair()
    mix, jmix = _mamba(tree, jtree)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _, cache = ssm.mamba(mix, _t(x), cfg, make_cache=True)
    _, jcache = jax_ssm.mamba(jmix, jnp.asarray(x), jcfg, make_cache=True)
    empty = ssm.init_mamba_cache(cfg, 2, CPU, dtype=torch.float32)
    jempty = jax_ssm.init_mamba_cache(jcfg, 2, dtype=jnp.float32)
    for t in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        for c, jc, what in ((cache, jcache, "prefilled"),
                            (empty, jempty, "empty")):
            y, out = ssm.mamba_decode(mix, _t(xt), cfg, c)
            assert out is c
            jy, jc2 = jax_ssm.mamba_decode(jmix, jnp.asarray(xt), jcfg, jc)
            jc.update(jc2)
            _close(y, jy, f"{what} step {t}")
            for key in ("conv", "h"):
                _close(c[key], jc[key], f"{what} step {t} {key}")


def test_mamba_decode_matches_full_fp32():
    """The reference's tests/test_models.py::
    test_mamba_decode_matches_full_fp32, on the port."""
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.configs.base import ParallelConfig as TPar
    from repro_torch.configs.base import SSMConfig as TSSM
    cfg = TArch(name="m", family="ssm", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab_size=16, ssm=TSSM(d_state=8),
                parallel=TPar(remat="none"))
    gen = torch.Generator().manual_seed(1)
    p = ssm.init_mamba(gen, cfg, torch.float32)
    x = torch.randn((2, 10, 32), generator=gen)
    y_all, _ = ssm.mamba(p, x, cfg)
    _, cache = ssm.mamba(p, x[:, :5], cfg, make_cache=True)
    for t in range(5, 10):
        y_t, cache = ssm.mamba_decode(p, x[:, t:t + 1], cfg, cache)
        np.testing.assert_allclose(y_t[:, 0].numpy(), y_all[:, t].numpy(),
                                   atol=1e-5, rtol=1e-4)


def test_mamba_per_row_readout_equals_batched():
    jcfg, jtree, cfg, tree = _pair()
    mix, _ = _mamba(tree, jtree)
    x = _t(np.random.default_rng(3).standard_normal((3, 1, cfg.d_model)))
    c1 = ssm.init_mamba_cache(cfg, 3, CPU, dtype=torch.float32)
    c2 = ssm.init_mamba_cache(cfg, 3, CPU, dtype=torch.float32)
    for _ in range(2):
        y1, _ = ssm.mamba_decode(mix, x, cfg, c1)
        y2, _ = ssm.mamba_decode(mix, x, cfg, c2, per_row=True)
        torch.testing.assert_close(y1, y2, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- whole models
def _routing(monkeypatch):
    """The port's MoE layers take the reference's top-k experts, call by
    call; returns the record of both sides' own choices and the
    reference's probabilities."""
    seen = {"ref": [], "port": [], "probs": []}
    jax_top_k, port_top_k = jax.lax.top_k, moe._top_k

    def jax_rec(probs, k):
        vals, idx = jax_top_k(probs, k)
        seen["ref"].append(np.asarray(idx))
        seen["probs"].append(np.asarray(probs, np.float32))
        return vals, idx

    def port_rec(probs, k):
        _, own = port_top_k(probs, k)
        seen["port"].append(own.numpy())
        idx = _ids(seen["ref"][len(seen["port"]) - 1])
        return torch.gather(probs, -1, idx), idx

    monkeypatch.setattr(jax.lax, "top_k", jax_rec)
    monkeypatch.setattr(moe, "_top_k", port_rec)
    return seen


def _check_choices(seen, k=2):
    """The port's own top-k choices are the reference's, but at near
    ties of the reference's router."""
    assert len(seen["ref"]) == len(seen["port"]) > 0
    differ = 0
    for i, (r, p, probs) in enumerate(zip(seen["ref"], seen["port"],
                                          seen["probs"])):
        for at in np.argwhere((np.sort(r, -1) != np.sort(p, -1)).any(-1)):
            srt = np.sort(probs[tuple(at)])[::-1]
            assert srt[k - 1] - srt[k] < ROUTER_TIE, (i, at, srt[:k + 1])
            differ += 1
    return differ


def test_model_forward_prefill_decode_match_reference(monkeypatch):
    """``forward``, ``prefill`` and teacher-forced ``decode_step`` logits
    at the bf16 model tolerance, every MoE layer on the reference's
    experts; the port's own choices equal them but at near ties."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    seen = _routing(monkeypatch)
    B, P, N = 2, 8, 3
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P + N)).astype(np.int32)
    with ref_op_by_op():
        jfull, _ = jax_zoo.forward(jcfg, jtree, {"tokens": jnp.asarray(
            toks)})
        jlog, jc = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(
            toks[:, :P])}, cache_len=P + N)
    with torch.inference_mode():
        full, aux = model_zoo.forward(cfg, tree, {"tokens": _ids(toks)})
        log, c = model_zoo.prefill(cfg, tree, {"tokens": _ids(toks[:, :P])},
                                   cache_len=P + N)
    steps, jsteps = [], []
    for t in range(P, P + N):
        with ref_op_by_op():
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t))
            jsteps.append(lg)
        with torch.inference_mode():
            steps.append(model_zoo.decode_step(
                cfg, tree, _ids(toks[:, t:t + 1]), c, t)[0])
    assert full.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert c["groups"][0]["l4"]["k"].shape[1] == P + N
    for got, want, what in [(full, jfull, "forward"), (log, jlog, "prefill")]:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=what)
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
    _, moe_flags, n_groups = blocks.group_layout(cfg)
    assert len(seen["port"]) == sum(moe_flags) * n_groups * (2 + N)
    _check_choices(seen)


def test_decode_from_empty_caches_matches_reference(monkeypatch):
    """Decoding a prompt token by token from ``init_caches`` (mamba's
    zero states, attention's empty K/V) matches the reference."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    seen = _routing(monkeypatch)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    caches = model_zoo.init_caches(cfg, 2, 5, device="cpu")
    assert caches["groups"][0]["l0"]["h"].dtype == torch.float32
    assert caches["groups"][0]["l0"]["conv"].dtype == torch.bfloat16
    jc = jax_zoo.init_caches(jcfg, 2, 5)
    for t in range(5):
        with ref_op_by_op():
            jlg, jc = jax_zoo.decode_step(jcfg, jtree,
                                          jnp.asarray(toks[:, t:t + 1]), jc,
                                          jnp.int32(t))
        with torch.inference_mode():
            lg, _ = model_zoo.decode_step(cfg, tree, _ids(toks[:, t:t + 1]),
                                          caches, t)
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
    _check_choices(seen)


def test_decode_jamba_moe():
    """The reference's tests/test_models.py::test_decode_jamba_moe, on
    the port: prefill(P) + step decode match the full forward."""
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.configs.base import MoEConfig as TMoE
    from repro_torch.configs.base import ParallelConfig as TPar
    from repro_torch.configs.base import SSMConfig as TSSM
    kw = dict(name="t", family="hybrid", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
              block_pattern="jamba", attn_every=4, attn_offset=2)
    cfg = TArch(**kw, moe=TMoE(n_routed=4, top_k=2, d_ff=32, every=2,
                               capacity_factor=8.0),
                ssm=TSSM(d_state=8), parallel=TPar(remat="none"))
    jcfg = ArchConfig(**kw, moe=MoEConfig(n_routed=4, top_k=2, d_ff=32,
                                          every=2, capacity_factor=8.0),
                      ssm=SSMConfig(d_state=8),
                      parallel=ParallelConfig(remat="none"))
    assert repr(cfg) == repr(jcfg)
    T = 12
    params = model_zoo.init(cfg, 1, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, T)))
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
        P = T // 2
        pre, caches = model_zoo.prefill(cfg, params,
                                        {"tokens": tokens[:, :P]},
                                        cache_len=T)
        np.testing.assert_allclose(_np(pre), _np(full[:, :P]), atol=0.25,
                                   rtol=0.1)
        errs = []
        for t in range(P, T):
            lg, caches = model_zoo.decode_step(cfg, params,
                                               tokens[:, t:t + 1], caches, t)
            errs.append(float((lg[:, 0].float()
                               - full[:, t].float()).abs().max()))
    assert max(errs) < 0.25, errs


# ------------------------------------------------- per-row positions
def test_jamba_row_positions_equal_int_steps():
    """One jamba ``decode_step`` over B rows at a (B,) position tensor
    (mamba, MoE and attention layers) equals B one-row steps at each
    row's ``int`` position, bitwise: the logits and every cache."""
    cfg = registry.get(JAMBA).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    rng = np.random.default_rng(11)
    B, P, L = 3, 5, 16
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)))
    depth = [0, 2, 5]
    rows, pos = [], []
    with torch.inference_mode():
        for b in range(B):
            _, c = model_zoo.prefill(cfg, params,
                                     {"tokens": prompts[b:b + 1]},
                                     cache_len=L)
            for t in range(depth[b]):
                tok = torch.as_tensor([[int(rng.integers(cfg.vocab_size))]])
                model_zoo.decode_step(cfg, params, tok, c, P + t)
            rows.append(c)
            pos.append(P + depth[b])
        stacked = continuous._tree_map(
            lambda *a: torch.cat(a, dim=0).clone(), *rows)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)))
        logits, out = model_zoo.decode_step(cfg, params, toks, stacked,
                                            torch.as_tensor(pos))
        assert out is stacked
        for b in range(B):
            lg, c = model_zoo.decode_step(cfg, params, toks[b:b + 1],
                                          rows[b], pos[b])
            assert torch.equal(logits[b:b + 1], lg), f"row {b}"
            got = continuous._tree_map(lambda a: a[b:b + 1], stacked)
            for x, y in zip(leaves(got), leaves(c)):
                assert torch.equal(x, y), f"row {b}'s cache"


def test_reference_misses_decode_consistency_at_width():
    """jamba's layers (mamba, MoE every other layer at capacity factor
    1.25, attention at the group's last layer) at d_model 1024: the
    reference's own decode steps miss its forward's logits by far more
    than the bf16 model tolerance (0.25), run op by op.  Over T tokens
    the forward drops what overflows an expert's capacity, where a
    one-token step drops nothing; the test config of the reference
    (``tests/test_models.py::test_decode_jamba_moe``) takes capacity
    factor 8 for that reason.  So ``chip_smoke.py`` prints jamba's
    full-width gap and holds its mamba layer's full and decode forms in
    f32 instead."""
    import dataclasses
    from test_torch_xlstm import _ref_decode_gaps
    jcfg = jax_registry.get(JAMBA).replace(
        n_layers=5, attn_every=5, d_model=1024, n_heads=8, n_kv_heads=2,
        head_dim=128, d_ff=2048, vocab_size=4096)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, d_ff=2048),
                        parallel=dataclasses.replace(jcfg.parallel,
                                                     remat="none"))
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(1)))
    P, n = 64, 4
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, P + n)).astype(np.int32)
    with ref_pinned():
        gaps = _ref_decode_gaps(jcfg, jtree, toks, P)
    print("the reference's decode-vs-forward gap a step:", gaps)
    assert len(gaps) == n + 1 and max(gaps) > BF16_ATOL, gaps
