"""The port's MLA (``repro_torch.models.mla``) and the two MLA configs,
deepseek-v2-lite-16b (MLA + MoE, no query LoRA) and minicpm3-4b (MLA,
query LoRA), against the JAX reference on the CPU.

Parameters come from the reference's ``model_zoo.init`` and cross over
as numpy arrays (``models.from_jax.params_from_numpy``); inputs are made
with numpy from a seed.  Tolerances:

* the MLA layer in f32 (naive prefill form and absorbed decode form,
  with ``q_lora_rank`` 0 and > 0): 2e-5, the f32 attention tolerance of
  ``tests/test_kernels.py``;
* whole models at their ``reduced()`` configs, in bf16, at the
  reference's bf16 model tolerance (atol 0.25, rtol 0.1,
  tests/test_models.py), the reference run op by op
  (``jax.disable_jit()``; its compiled forward drops bf16 roundings
  between fused ops), with deepseek's MoE top-k choices equal;
* a decode step at a (B,) position tensor: bitwise the B one-row
  steps at each row's ``int`` position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ArchConfig, MLAConfig, ParallelConfig
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro_torch.configs import registry
from repro_torch.models import layers, mla, model_zoo, moe
from repro_torch.models import transformer
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from repro_torch.serve import continuous, serve_step

DEEPSEEK, MINICPM = "deepseek-v2-lite-16b", "minicpm3-4b"
ARCHS = [DEEPSEEK, MINICPM]
BF16_ATOL, BF16_RTOL = 0.25, 0.1
F32_TOL = 2e-5
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dtype=torch.float32):
    jcfg = jax_registry.get(arch).reduced()
    cfg = registry.get(arch).reduced()
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                             device="cpu", dtype=dtype)
    return jcfg, jtree, cfg, tree


def _shapes(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


# -------------------------------------------------------------- layout
@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_references_tree(arch):
    """The port's random init builds the reference's tree: the same
    shapes, bf16 weights, f32 norms (``q_norm`` / ``kv_norm`` included)."""
    jcfg, _, cfg, _ = _pair(arch)
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    ref = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                            device="cpu", dtype=torch.bfloat16)
    mine = model_zoo.init(cfg, 2, device="cpu")
    assert _shapes(mine) == _shapes(ref)
    mix = mine["stack"]["groups"][0]["l0"]["mix"]
    assert mix["kv_norm"].dtype == torch.float32
    assert ("q_norm" in mix) == bool(cfg.mla.q_lora_rank)
    assert mix["wkv_b"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_group_layout_and_rope_dim_are_the_references(arch):
    from repro.models import blocks as jax_blocks
    from repro.models import transformer as jax_tf
    from repro_torch.models import blocks
    for c in (registry.get(arch), registry.get(arch).reduced()):
        jc = jax_registry.get(arch)
        jc = jc if c.n_layers == jc.n_layers else jc.reduced()
        assert blocks.group_layout(c) == jax_blocks.group_layout(jc)
        assert transformer._rope_dim(c) == jax_tf._rope_dim(jc) \
            == c.mla.qk_rope_head_dim
        assert transformer._has_attn(c)
    kinds, _, _ = blocks.group_layout(registry.get(arch))
    assert kinds == ["mla"]


# ---------------------------------------------------------- the layer
def _mix(tree, jtree):
    """The first MoE-stack group's MLA parameters (port, reference)."""
    return (tree["stack"]["groups"][0]["l0"]["mix"],
            jax.tree.map(lambda a: a[0], jtree["stack"]["groups"])["l0"]
            ["mix"])


def _rope(cfg, T, positions=None):
    dr = cfg.mla.qk_rope_head_dim
    pos = np.arange(T) if positions is None else np.asarray(positions)
    sin, cos = layers.rope_table(dr, T, cfg.rope_theta, _t(pos))
    jsin, jcos = jax_layers.rope_table(dr, T, cfg.rope_theta,
                                       jnp.asarray(pos))
    return (sin, cos), (jsin, jcos)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_attention_matches_reference_f32(arch):
    """The naive prefill form: the output and the latent cache
    (``ckv``, ``kr``) padded to the cache length, in f32."""
    jcfg, jtree, cfg, tree = _pair(arch)
    mix, jmix = _mix(tree, jtree)
    T = 11
    x = np.random.default_rng(1).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    (sin, cos), (jsin, jcos) = _rope(cfg, T)
    y, cache = mla.mla_attention(mix, _t(x), cfg, sin=sin, cos=cos,
                                 make_cache_len=16)
    jy, jcache = jax_mla.mla_attention(jmix, jnp.asarray(x), jcfg,
                                       sin=jsin, cos=jcos,
                                       make_cache_len=16)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=F32_TOL, atol=F32_TOL)
    for key in ("ckv", "kr"):
        assert cache[key].shape == jcache[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_matches_reference_f32(arch):
    """The absorbed decode form against a latent cache, step by step
    from empty, in f32; the port writes each step's row in place."""
    jcfg, jtree, cfg, tree = _pair(arch)
    mix, jmix = _mix(tree, jtree)
    rng = np.random.default_rng(2)
    cache = mla.init_mla_cache(cfg, 2, 9, CPU, dtype=torch.float32)
    jcache = jax_mla.init_mla_cache(jcfg, 2, 9, dtype=jnp.float32)
    for pos in range(7):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        (sin, cos), (jsin, jcos) = _rope(cfg, 1, [pos])
        y, out = mla.mla_decode(mix, _t(x), cfg, cache, pos, sin=sin,
                                cos=cos)
        assert out is cache
        jy, jcache = jax_mla.mla_decode(jmix, jnp.asarray(x), jcfg, jcache,
                                        jnp.int32(pos), sin=jsin, cos=jcos)
        np.testing.assert_allclose(_np(y), _np(jy), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {pos}")
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                       rtol=F32_TOL, atol=F32_TOL)


def test_mla_decode_refuses_more_than_one_token():
    _, _, cfg, tree = _pair(MINICPM)
    mix = tree["stack"]["groups"][0]["l0"]["mix"]
    cache = mla.init_mla_cache(cfg, 1, 4, CPU, dtype=torch.float32)
    (sin, cos), _ = _rope(cfg, 2)
    with pytest.raises(ValueError, match="one token"):
        mla.mla_decode(mix, torch.zeros(1, 2, cfg.d_model), cfg, cache, 0,
                       sin=sin, cos=cos)


# ------------------------------------------------------- whole models
def _record_top_k(monkeypatch):
    seen = {"ref": [], "port": []}
    jax_top_k, port_top_k = jax.lax.top_k, moe._top_k

    def jax_rec(probs, k):
        vals, idx = jax_top_k(probs, k)
        seen["ref"].append(np.asarray(idx))
        return vals, idx

    def port_rec(probs, k):
        vals, idx = port_top_k(probs, k)
        seen["port"].append(idx.numpy())
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", jax_rec)
    monkeypatch.setattr(moe, "_top_k", port_rec)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_prefill_decode_match_reference(arch, monkeypatch):
    """``forward``, ``prefill`` and teacher-forced ``decode_step`` logits
    at the bf16 model tolerance; deepseek's MoE layers pick the
    reference's experts at every call."""
    jcfg, jtree, cfg, tree = _pair(arch, torch.bfloat16)
    seen = _record_top_k(monkeypatch)
    B, P, N = 2, 10, 4
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P + N)).astype(np.int32)
    with jax.disable_jit():
        jfull, _ = jax_zoo.forward(jcfg, jtree, {"tokens": jnp.asarray(
            toks)})
        jlog, jc = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(
            toks[:, :P])}, cache_len=P + N)
        jsteps = []
        for t in range(P, P + N):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t))
            jsteps.append(lg)
    with torch.inference_mode():
        full, aux = model_zoo.forward(cfg, tree, {"tokens": _t(toks)})
        log, c = model_zoo.prefill(cfg, tree, {"tokens": _t(toks[:, :P])},
                                   cache_len=P + N)
        steps = [model_zoo.decode_step(cfg, tree, _t(toks[:, t:t + 1]), c,
                                       t)[0] for t in range(P, P + N)]
    assert full.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert c["groups"][0]["l0"]["ckv"].shape == (
        B, P + N, cfg.mla.kv_lora_rank)
    for got, want, what in [(full, jfull, "forward"), (log, jlog, "prefill")]:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=what)
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
    assert len(seen["ref"]) == len(seen["port"])
    if cfg.moe is not None:
        assert len(seen["port"]) == (cfg.n_layers - 1) * (2 + N)
        for i, (r, p) in enumerate(zip(seen["ref"], seen["port"])):
            np.testing.assert_array_equal(p, r, err_msg=f"MoE call {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_caches_matches_reference(arch):
    """Decoding a prompt token by token from ``init_caches`` (the MLA
    latent caches) matches the reference doing the same."""
    jcfg, jtree, cfg, tree = _pair(arch, torch.bfloat16)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    with torch.inference_mode():
        caches = model_zoo.init_caches(cfg, 2, 5, device="cpu")
        assert caches["groups"][0]["l0"]["ckv"].dtype == torch.bfloat16
        steps = [model_zoo.decode_step(cfg, tree, _t(toks[:, t:t + 1]),
                                       caches, t)[0] for t in range(5)]
    with jax.disable_jit():
        jc = jax_zoo.init_caches(jcfg, 2, 5)
        for t in range(5):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t))
            np.testing.assert_allclose(_np(steps[t]), _np(lg),
                                       atol=BF16_ATOL, rtol=BF16_RTOL,
                                       err_msg=f"step {t}")


# the reference's tests/test_models.py::test_decode_mla, on the port
def _decode_consistency(cfg, T=12, tol=0.25):
    """prefill(P) + step-decode must match the full forward (bf16 tol)."""
    params = model_zoo.init(cfg, 1, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, T)))
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
        P = T // 2
        pre, caches = model_zoo.prefill(cfg, params,
                                        {"tokens": tokens[:, :P]},
                                        cache_len=T)
        np.testing.assert_allclose(_np(pre), _np(full[:, :P]), atol=tol,
                                   rtol=0.1)
        errs = []
        for t in range(P, T):
            lg, caches = model_zoo.decode_step(cfg, params,
                                               tokens[:, t:t + 1], caches, t)
            errs.append(float((lg[:, 0].float()
                               - full[:, t].float()).abs().max()))
    assert max(errs) < tol, errs


def test_decode_mla():
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.configs.base import MLAConfig as TMLA
    from repro_torch.configs.base import ParallelConfig as TPar
    cfg = TArch(name="t", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                head_dim=16, attn_type="mla",
                mla=TMLA(kv_lora_rank=32, q_lora_rank=24,
                         qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16), parallel=TPar(remat="none"))
    # the reference's own config, field for field
    jcfg = ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                      head_dim=16, attn_type="mla",
                      mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16),
                      parallel=ParallelConfig(remat="none"))
    assert repr(cfg) == repr(jcfg)
    _decode_consistency(cfg)


def test_decode_consistency_reduced():
    """The same check at minicpm3-4b's ``reduced()``.  deepseek's is left
    out: with top-2 of 8 experts, a bf16 ulp between the 12-token
    forward and a one-token step flips a near-tie in the router, and the
    reference itself misses 0.25 there (0.454 at its seed 1, even at a
    capacity that drops nothing)."""
    _decode_consistency(registry.get(MINICPM).reduced())


# ------------------------------------------------- per-row positions
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_row_positions_equal_int_steps(arch):
    """One MLA ``decode_step`` over B rows at a (B,) position tensor
    equals B separate one-row steps at each row's ``int`` position,
    bitwise: the logits and the latent cache rows written."""
    cfg = registry.get(arch).reduced()
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


def test_mla_int_position_equals_the_same_position_as_a_tensor():
    cfg = registry.get(MINICPM).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)))
    with torch.inference_mode():
        _, c1 = model_zoo.prefill(cfg, params, {"tokens": prompt}, 10)
        _, c2 = model_zoo.prefill(cfg, params, {"tokens": prompt}, 10)
        a, _ = model_zoo.decode_step(cfg, params, prompt[:, -1:], c1, 6)
        b, _ = model_zoo.decode_step(cfg, params, prompt[:, -1:], c2,
                                     torch.tensor([6, 6]))
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(leaves(c1), leaves(c2)))


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Greedy tokens equal the reference's ``generate`` (run op by op),
    but where the reference's top-1/top-2 gap is under the bf16 model
    tolerance (the models' margin rule); a row is compared no further
    after its first such difference."""
    from repro.serve import serve_step as jax_serve
    jcfg, jtree, cfg, tree = _pair(arch, torch.bfloat16)
    B, P, N = 2, 8, 5
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    with jax.disable_jit():
        ref = np.asarray(jax_serve.generate(jcfg, jtree,
                                            jnp.asarray(prompt), N))
        lg, c = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(prompt)},
                                cache_len=P + N)
        logits = [np.asarray(lg[:, -1], np.float32)]
        for t in range(N):
            lg, c = jax_zoo.decode_step(jcfg, jtree,
                                        jnp.asarray(ref[:, t:t + 1]), c,
                                        jnp.int32(P + t))
            logits.append(np.asarray(lg[:, 0], np.float32))
    top2 = np.sort(np.stack(logits, axis=1), axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    out = serve_step.generate(cfg, tree, _t(prompt), N).numpy()
    assert out.shape == (B, N + 1)
    for b in range(B):
        for t in range(N + 1):
            if out[b, t] != ref[b, t]:
                assert gaps[b, t] < BF16_ATOL, (b, t, gaps[b, t])
                break
