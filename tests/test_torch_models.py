"""The port's LM stack (``repro_torch.configs``, ``models``, ``serve``,
``launch.serve``) against the JAX reference, on the CPU.

Parameters come from the reference's own ``model_zoo.init`` and cross
over as numpy arrays (``models.from_jax.params_from_numpy``); inputs are
made with numpy from a seed.  On the CPU the attention entry runs the
unblocked f32 oracle and the grouped matmul its f32 plain version; the
CUDA kernels K7 and K8 run in ``test_torch_cuda.py``.

Tolerances:

* module checks in f32, 2e-4: the algorithm, with f32 sums taken in
  another order;
* the whole slice at kimi-k2's ``reduced()`` config, in bf16, at the
  reference's bf16 model tolerance (atol 0.25, rtol 0.1,
  tests/test_models.py), with the MoE layers' top-k choices equal and
  the greedy tokens equal (see ``test_generate_matches_reference``).

The whole-slice tests pin the reference's prefill attention to its
unblocked f32 oracle (``REPRO_TUNE_PIN_FLASH_ATTENTION='{"impl":
"xla_ref"}'``), which is what K7 computes, and run the reference op by
op (``jax.disable_jit()``), both around the reference's calls only
(``torch_ref_pin.ref_op_by_op``): the port's layers read the pin too,
and ``xla_ref`` is no impl of the port's.  Compiled, XLA drops some of
the bf16 roundings between fused ops, and at this config the reference's
compiled and op-by-op forwards differ from each other by up to ~0.8 in
the logits (an ulp moves a token past an expert's capacity); PyTorch
rounds every op's result, as the reference's op-by-op form does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model_zoo as jax_zoo
from repro.models import moe as jax_moe
from repro.models import param as jax_param
from repro.serve import serve_step as jax_serve
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention, layers, model_zoo, moe
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from repro_torch.serve import plain_check, serve_step
from torch_ref_pin import ref_op_by_op

KIMI = "kimi-k2-1t-a32b"
BF16_ATOL, BF16_RTOL = 0.25, 0.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=2e-4):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _ref_params(cfg, seed=0):
    tree = jax_param.values(jax_zoo.init(cfg, jax.random.key(seed)))
    return tree, jax.tree.map(np.asarray, tree)


def _pair(cfg, dtype=torch.float32):
    """The reference's params for ``cfg`` and the port's copy of them."""
    jtree, ntree = _ref_params(cfg)
    return jtree, params_from_numpy(ntree, cfg, device="cpu", dtype=dtype)


def _shapes(tree, path=""):
    """{path: shape} of every tensor in a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


def _kimi():
    return jax_registry.get(KIMI).reduced(), registry.get(KIMI).reduced()


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_configs_are_the_references(arch):
    assert registry.ARCH_IDS == jax_registry.ARCH_IDS
    assert repr(registry.get(arch)) == repr(jax_registry.get(arch))
    assert repr(registry.get(arch).reduced()) == repr(
        jax_registry.get(arch).reduced())


def test_init_has_the_references_tree():
    """The port's random init builds the reference's tree (groups
    un-stacked): the same shapes, bf16 weights, f32 norms."""
    jcfg, cfg = _kimi()
    _, ntree = _ref_params(jcfg)
    ref = params_from_numpy(ntree, cfg, device="cpu")
    mine = model_zoo.init(cfg, 3, device="cpu")
    assert _shapes(mine) == _shapes(ref)
    assert mine["final_norm"]["scale"].dtype == torch.float32
    assert mine["stack"]["groups"][0]["l0"]["ffn"]["w_up"].dtype \
        == torch.bfloat16
    assert len(mine["stack"]["groups"]) == cfg.n_layers - 1
    again = model_zoo.init(cfg, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(mine),
                                                 leaves(again)))


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm_type):
    _, cfg = _kimi()
    cfg = cfg.replace(norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    out = layers.norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    ref = jax_layers.norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), cfg)
    _close(out, ref)
    _close(layers.rms_norm_simple(_t(x), _t(p["scale"])),
           jax_layers.rms_norm_simple(jnp.asarray(x),
                                      jnp.asarray(p["scale"])))


@pytest.mark.parametrize("d", [256, 768, 2560, 7168])
def test_norms_of_a_batch_are_each_rows_norm_bitwise(d):
    """A row's norm is the same bits in a batch of 4 rows as alone (the
    mean is summed in two fixed stages), as the continuous
    engine's slot step needs; 7168 = kimi-k2's d_model."""
    _, cfg = _kimi()
    x = torch.randn((4, 1, d), generator=torch.Generator().manual_seed(d),
                    dtype=torch.float32).bfloat16()
    p = {"scale": torch.rand(d, generator=torch.Generator().manual_seed(1))}
    for c in (cfg, cfg.replace(norm_type="layernorm")):
        q = dict(p, bias=torch.rand(d)) if c.norm_type == "layernorm" else p
        batch = layers.norm(q, x, c)
        for b in range(4):
            assert torch.equal(batch[b:b + 1], layers.norm(q, x[b:b + 1], c))
    batch = layers.rms_norm_simple(x, p["scale"])
    for b in range(4):
        assert torch.equal(batch[b:b + 1],
                           layers.rms_norm_simple(x[b:b + 1], p["scale"]))


def test_rope_matches_reference():
    pos = np.array([0, 3, 17, 1000], dtype=np.int32)
    sin, cos = layers.rope_table(32, 0, 10000.0, _t(pos))
    jsin, jcos = jax_layers.rope_table(32, 0, 10000.0, jnp.asarray(pos))
    _close(sin, jsin)
    _close(cos, jcos)
    x = np.random.default_rng(2).standard_normal((2, 4, 3, 32)).astype(
        np.float32)
    _close(layers.apply_rope(_t(x), sin, cos),
           jax_layers.apply_rope(jnp.asarray(x), jsin, jcos))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_matches_reference(act):
    jcfg, cfg = _kimi()
    jcfg, cfg = jcfg.replace(act=act), cfg.replace(act=act)
    jtree, tree = _pair(jcfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    ffn = tree["stack"]["prefix"][0]["ffn"]
    jffn = jtree["stack"]["prefix"][0]["ffn"]
    _close(layers.mlp(ffn, _t(x), cfg),
           jax_layers.mlp(jffn, jnp.asarray(x), jcfg))


def test_silu_rounds_like_the_reference_in_bf16():
    """XLA rounds each op of jax.nn.silu's bf16 chain; the port's silu
    does the same, bit for bit."""
    x = jnp.asarray(np.random.default_rng(4).standard_normal(4096) * 3,
                    jnp.bfloat16)
    out = layers.ACTS["silu"](_t(np.asarray(x, np.float32)).bfloat16())
    np.testing.assert_array_equal(_np(out), _np(jax.nn.silu(x)))


# ----------------------------------------------------------- attention
@pytest.mark.parametrize("window", [0, 5])
def test_attention_matches_reference(window):
    """Plain causal attention (the flash entry) and a sliding window
    (the einsum path), with the decode cache the prefill makes."""
    jcfg, cfg = _kimi()
    jcfg = jcfg.replace(sliding_window=window)
    cfg = cfg.replace(sliding_window=window)
    jtree, tree = _pair(jcfg)
    T = 11
    x = np.random.default_rng(5).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    sin, cos = layers.rope_table(cfg.head_dim, T, cfg.rope_theta)
    jsin, jcos = jax_layers.rope_table(cfg.head_dim, T, cfg.rope_theta)
    mix = tree["stack"]["prefix"][0]["mix"]
    jmix = jtree["stack"]["prefix"][0]["mix"]
    y, cache = attention.attention(mix, _t(x), cfg, sin=sin, cos=cos,
                                   make_cache_len=16)
    jy, jcache = jax_attn.attention(jmix, jnp.asarray(x), jcfg, sin=jsin,
                                    cos=jcos, make_cache_len=16)
    _close(y, jy)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_matches_reference(window):
    """Decode steps against a cache; a window of 4 wraps its ring
    buffer.  The port writes the slot in place."""
    jcfg, cfg = _kimi()
    jcfg = jcfg.replace(sliding_window=window)
    cfg = cfg.replace(sliding_window=window)
    jtree, tree = _pair(jcfg)
    rng = np.random.default_rng(6)
    mix = tree["stack"]["prefix"][0]["mix"]
    jmix = jtree["stack"]["prefix"][0]["mix"]
    cache = attention.init_cache(cfg, 2, 9, "cpu", dtype=torch.float32)
    jcache = jax_attn.init_cache(jcfg, 2, 9, dtype=jnp.float32)
    for pos in range(7):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        sin, cos = layers.rope_table(cfg.head_dim, 1, cfg.rope_theta,
                                     torch.tensor([pos]))
        jsin, jcos = jax_layers.rope_table(cfg.head_dim, 1, cfg.rope_theta,
                                           jnp.asarray([pos]))
        y, out = attention.attention_decode(mix, _t(x), cfg, cache, pos,
                                            sin=sin, cos=cos)
        assert out is cache
        jy, jcache = jax_attn.attention_decode(jmix, jnp.asarray(x), jcfg,
                                               jcache, jnp.int32(pos),
                                               sin=jsin, cos=jcos)
        _close(y, jy)
        for key in ("k", "v"):
            _close(cache[key], jcache[key])


# ----------------------------------------------------------------- moe
# (dispatch, capacity_factor, overflow_passes): the default capacity
# (drops into the tail), a capacity so small that assignments are
# dropped even after two tail passes, no tail at all, and the
# sort-free dispatch
MOE_CASES = [("sort", 1.25, 1), ("sort", 0.3, 2), ("sort", 0.5, 0),
             ("onehot", 1.25, 1), ("onehot", 0.3, 2)]


@pytest.mark.parametrize("dispatch,cf,passes", MOE_CASES)
def test_moe_ffn_matches_reference(dispatch, cf, passes):
    jcfg, cfg = _kimi()
    m = dataclasses.replace(jcfg.moe, dispatch=dispatch,
                            capacity_factor=cf, overflow_passes=passes)
    jcfg, cfg = jcfg.replace(moe=m), cfg.replace(moe=m)
    jtree, tree = _pair(jcfg)
    x = np.random.default_rng(7).standard_normal(
        (3, 24, cfg.d_model)).astype(np.float32)
    ffn = tree["stack"]["groups"][0]["l0"]["ffn"]
    jffn = jax.tree.map(lambda a: a[0],
                        jtree["stack"]["groups"])["l0"]["ffn"]
    y, aux = moe.moe_ffn(ffn, _t(x), cfg)
    jy, jaux = jax_moe.moe_ffn(jffn, jnp.asarray(x), jcfg)
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the case does what its name says: some assignment overflows C
    flat = moe._top_k(layers.softmax(layers.linear(
        ffn["router"], _t(x)).float()), m.top_k)[1].reshape(3, -1)
    C = max(1, int(24 * m.top_k / m.n_routed * cf))
    counts = torch.stack([torch.bincount(r, minlength=m.n_routed)
                          for r in flat])
    assert int(counts.max()) > C


def test_moe_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = moe._top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 4]]
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist()


def test_moe_smap_raises():
    """``shard_mode="smap"`` no longer raises: without a mesh it is the
    dense MoE, bitwise, as in the reference (under a mesh it is the
    shard_map MoE: ``tests/test_torch_moe_smap.py``)."""
    _, cfg = _kimi()
    smap = cfg.replace(moe=dataclasses.replace(cfg.moe, shard_mode="smap"))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    y0, a0 = moe.moe_ffn(p, x, cfg)
    y1, a1 = moe.moe_ffn(p, x, smap)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


# --------------------------------------------------------- whole slice
@pytest.fixture
def kimi_pair():
    jcfg, cfg = _kimi()
    jtree, tree = _pair(jcfg, torch.bfloat16)
    return jcfg, jtree, cfg, tree


def _record_top_k(monkeypatch):
    """Record every MoE layer's top-k choices, the reference's and the
    port's, in call order."""
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


def _assert_same_choices(seen):
    assert len(seen["ref"]) == len(seen["port"]) > 0
    for i, (r, p) in enumerate(zip(seen["ref"], seen["port"])):
        np.testing.assert_array_equal(p, r, err_msg=f"MoE call {i}")


def test_prefill_and_decode_match_reference(kimi_pair, monkeypatch):
    """Prefill logits and teacher-forced decode logits at the bf16 model
    tolerance; every MoE layer picks the same experts."""
    jcfg, jtree, cfg, tree = kimi_pair
    seen = _record_top_k(monkeypatch)
    B, P, N = 2, 12, 5
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, P + N)).astype(np.int32)
    with ref_op_by_op():
        jlog, jc = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(
            toks[:, :P])}, cache_len=P + N)
        jsteps = []
        for t in range(P, P + N):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t))
            jsteps.append(lg)
    with torch.inference_mode():
        log, c = model_zoo.prefill(cfg, tree, {"tokens": _t(toks[:, :P])},
                                   cache_len=P + N)
        steps = []
        for t in range(P, P + N):
            lg, c = model_zoo.decode_step(cfg, tree, _t(toks[:, t:t + 1]),
                                          c, t)
            steps.append(lg)
    assert log.dtype == torch.bfloat16 and log.shape == (B, P,
                                                         cfg.vocab_size)
    np.testing.assert_allclose(_np(log), _np(jlog), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
    # (n_layers - 1) MoE layers, at prefill and at each decode step
    assert len(seen["port"]) == (cfg.n_layers - 1) * (1 + N)
    _assert_same_choices(seen)


def test_forward_and_decode_from_empty_caches(kimi_pair):
    """``forward`` gives ``prefill``'s logits; decoding a prompt token by
    token from ``init_caches`` matches the reference doing the same."""
    jcfg, jtree, cfg, tree = kimi_pair
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    with torch.inference_mode():
        logits, aux = model_zoo.forward(cfg, tree, {"tokens": _t(toks)})
        pre, _ = model_zoo.prefill(cfg, tree, {"tokens": _t(toks)}, 4)
        assert torch.equal(logits, pre) and aux.dtype == torch.float32
        caches = model_zoo.init_caches(cfg, 2, 4, device="cpu")
        assert caches["prefix"][0]["k"].dtype == torch.bfloat16
        steps = [model_zoo.decode_step(cfg, tree, _t(toks[:, t:t + 1]),
                                       caches, t)[0] for t in range(4)]
    with ref_op_by_op():
        jc = jax_zoo.init_caches(jcfg, 2, 4)
        for t in range(4):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t))
            np.testing.assert_allclose(_np(steps[t]), _np(lg),
                                       atol=BF16_ATOL, rtol=BF16_RTOL,
                                       err_msg=f"step {t}")


def _top2_gaps(jcfg, jtree, prompt, tokens):
    """The reference's top-1 minus top-2 logit before each generated
    token, teacher-forced along ``tokens`` (B, n_new + 1)."""
    B, P = prompt.shape
    n_new = tokens.shape[1] - 1
    with ref_op_by_op():
        lg, c = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(prompt)},
                                cache_len=P + n_new)
        logits = [np.asarray(lg[:, -1], np.float32)]
        for t in range(n_new):
            lg, c = jax_zoo.decode_step(
                jcfg, jtree, jnp.asarray(tokens[:, t:t + 1]), c,
                jnp.int32(P + t))
            logits.append(np.asarray(lg[:, 0], np.float32))
    top2 = np.sort(np.stack(logits, axis=1), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]                 # (B, n_new + 1)


def test_generate_matches_reference(kimi_pair, monkeypatch):
    """Greedy tokens equal the reference's ``generate``, in its layout
    (the prefill's argmax, then one token per decode step).  A position
    may differ only where the reference's top-1 / top-2 logit gap is
    under the bf16 model tolerance (an ulp may flip a near-tie); the row
    is compared no further, since later tokens continue another text."""
    jcfg, jtree, cfg, tree = kimi_pair
    seen = _record_top_k(monkeypatch)
    B, P, N = 2, 10, 6
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    with ref_op_by_op():
        ref = np.asarray(jax_serve.generate(jcfg, jtree, jnp.asarray(prompt),
                                            N))
    out = serve_step.generate(cfg, tree, _t(prompt), N)
    assert out.dtype == torch.int32 and out.shape == (B, N + 1)
    out = out.numpy()
    gaps = _top2_gaps(jcfg, jtree, prompt, ref)
    for b in range(B):
        for t in range(N + 1):
            if out[b, t] != ref[b, t]:
                assert gaps[b, t] < BF16_ATOL, (
                    f"row {b} token {t}: {out[b, t]} != {ref[b, t]} where "
                    f"the reference's top-1/top-2 gap {gaps[b, t]:.3f} is "
                    f"not under {BF16_ATOL}")
                break
    n_moe = cfg.n_layers - 1
    if np.array_equal(out, ref):
        _assert_same_choices({k: v[:n_moe * (1 + N)]
                              for k, v in seen.items()})


def test_generate_layout_is_prefill_then_steps():
    """Token 0 is the prefill's argmax; token i the i-th decode step's."""
    _, cfg = _kimi()
    tree = model_zoo.init(cfg, 1, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 7),
                           generator=torch.Generator().manual_seed(2))
    out = serve_step.generate(cfg, tree, prompt, 3)
    first, caches = serve_step.make_prefill_step(cfg, cache_len=10)(
        tree, {"tokens": prompt})
    assert torch.equal(out[:, :1], first.to(torch.int32))
    step = serve_step.make_serve_step(cfg)
    tok = out[:, :1]
    for i in range(3):
        tok, caches = step(tree, tok, caches, 7 + i)
        assert torch.equal(out[:, i + 1:i + 2], tok)


def test_plain_path_helpers_on_cpu():
    """On the CPU K7's and K8's entries already run their plain versions:
    inside ``plain_kernels`` the model gives ``generate``'s tokens,
    ``greedy_with_gaps`` returns them with their gaps, the margin rule
    finds no differing row, and the entries come back after the block."""
    _, cfg = _kimi()
    tree = model_zoo.init(cfg, 1, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 7),
                           generator=torch.Generator().manual_seed(3))
    out = serve_step.generate(cfg, tree, prompt, 3)
    saved = flash_ops.sdpa, gmm_ops.gmm_model
    with plain_check.plain_kernels():
        assert flash_ops.sdpa is not saved[0]
        assert gmm_ops.gmm_model is not saved[1]
        toks, gaps, last = plain_check.greedy_with_gaps(cfg, tree, prompt, 3)
    assert (flash_ops.sdpa, gmm_ops.gmm_model) == saved
    assert torch.equal(toks, out)
    assert gaps.shape == out.shape and bool((gaps >= 0).all())
    assert last.shape == (2, cfg.vocab_size) and last.dtype == torch.float32
    assert plain_check.check_tokens(out, toks, gaps) == []


@pytest.mark.parametrize("gap,allowed", [(0.125, True), (0.25, False),
                                         (0.5, False)])
def test_check_tokens_margin_rule(gap, allowed):
    """A row may differ only where the plain path's gap at its first
    differing token is under the margin; the row's later tokens are not
    compared."""
    toks = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    plain = toks.clone()
    plain[1, 1], plain[1, 2] = 9, 7
    gaps = torch.ones((2, 3))
    gaps[1, 1] = gap
    if allowed:
        assert plain_check.check_tokens(toks, plain, gaps) == [(1, 1, gap)]
    else:
        with pytest.raises(AssertionError, match="row 1 token 1"):
            plain_check.check_tokens(toks, plain, gaps)
    with pytest.raises(AssertionError, match="against"):
        plain_check.check_tokens(toks[:, :2], plain, gaps)


def test_serve_launcher_runs_on_an_explicit_cpu(capsys):
    out = serve_launch.main(["--arch", KIMI, "--batch", "2",
                             "--prompt-len", "5", "--new-tokens", "3"],
                            device="cpu")
    assert out.shape == (2, 4)
    assert "kimi-k2-1t-a32b: generated (2, 4)" in capsys.readouterr().out


def test_serve_launcher_needs_a_gpu_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launch.main(["--arch", KIMI])


def test_embeds_of_tokens_equal_the_tokens():
    """The embeddings of a token batch, given as ``embeds``, give the
    tokens' logits bitwise (forward, prefill and a decode step): the
    float input path only skips the embedding lookup."""
    _, cfg = _kimi()
    tree = model_zoo.init(cfg, 1, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(5))
    emb = layers.embed(tree["embed"], toks, cfg)
    with torch.inference_mode():
        a, _ = model_zoo.forward(cfg, tree, {"tokens": toks})
        b, _ = model_zoo.forward(cfg, tree, {"embeds": emb, "tokens": toks})
        assert emb.dtype == torch.bfloat16 and torch.equal(a, b)
        _, ct = model_zoo.prefill(cfg, tree, {"tokens": toks[:, :8]}, 9)
        _, ce = model_zoo.prefill(cfg, tree, {"embeds": emb[:, :8]}, 9)
        st, _ = model_zoo.decode_step(cfg, tree, toks[:, 8:], ct, 8)
        se, _ = model_zoo.decode_step(cfg, tree, emb[:, 8:], ce, 8)
    assert torch.equal(st, se)


def test_stub_embeddings_match_reference():
    """A float (B, T, d) input is taken as precomputed embeddings (the
    reference's frontend stub, ``transformer._inputs_to_h``):
    ``forward`` and ``prefill`` read ``batch["embeds"]`` before
    ``batch["tokens"]``, and a decode step takes a (B, 1, d) embedding.
    chameleon-34b's reduced config (``frontend="vq_stub"``) against the
    reference's logits at the bf16 model tolerance."""
    arch = "chameleon-34b"
    jcfg = jax_registry.get(arch).reduced()
    cfg = registry.get(arch).reduced()
    assert cfg.frontend == "vq_stub" and cfg.qk_norm
    jtree, tree = _pair(jcfg, torch.bfloat16)
    rng = np.random.default_rng(12)
    B, T = 2, 16
    emb = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    eb = _t(emb).bfloat16()
    jeb = jnp.asarray(emb, jnp.bfloat16)
    with ref_op_by_op():
        jlog, _ = jax_zoo.forward(jcfg, jtree, {"embeds": jeb})
        jpre, jc = jax_zoo.prefill(jcfg, jtree, {"embeds": jeb[:, :T - 1]},
                                   cache_len=T)
        jstep, _ = jax_zoo.decode_step(jcfg, jtree, jeb[:, T - 1:], jc,
                                       jnp.int32(T - 1))
    with torch.inference_mode():
        log, aux = model_zoo.forward(cfg, tree, {"embeds": eb})
        pre, c = model_zoo.prefill(cfg, tree, {"embeds": eb[:, :T - 1]},
                                   cache_len=T)
        step, _ = model_zoo.decode_step(cfg, tree, eb[:, T - 1:], c, T - 1)
    assert log.shape == (B, T, cfg.vocab_size)
    assert bool(torch.isfinite(log.float()).all())
    for got, want, what in [(log, jlog, "forward"), (pre, jpre, "prefill"),
                            (step, jstep, "decode step")]:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=what)
