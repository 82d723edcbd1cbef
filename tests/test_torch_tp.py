"""``tp=`` / ``kv_repeat`` through the port's LM stack against the JAX
reference, on the CPU.

At a model-parallel degree ``tp`` above ``n_kv_heads`` both packages
repeat the K/V activations and caches ``kv_repeat``-fold along the head
axis (``attention.kv_repeat_for``); the weights do not change.  At the
``reduced()`` configs (4 query and 2 KV heads) tp = 4 gives kv_repeat 2.

* ``kv_repeat_for`` equals the reference's for every registry config,
  full and reduced, at tp 1-32; the caches of ``init_caches(tp=)`` and
  of ``input_specs(tp=16)`` (every arch and applicable cell) have the
  reference's shapes and types.
* The attention layer at kv_repeat 2 in f32 at 2e-5, a prefill with its
  cache then decode steps on it: h2o-danube's sliding window (cut to 8,
  so that the steps wrap the ring buffer) and jamba's attention layer.
* In the port the repeat changes no value: tp = 4 gives tp = 1's logits
  within f32 2e-5 (f32 weights); whisper and minicpm3 (kv_repeat 1)
  take tp = 16 bitwise as tp = 1.
* ``LMStepper(tp=4)``: rows that join and leave the slots give a solo
  ``generate(tp=4)``'s tokens bitwise.

The whole kimi-k2 slice at tp = 4 is held in
``tests/test_torch_tp_slice.py``, training in
``tests/test_torch_tp_train.py`` (files of their own for ``--dist
loadfile``).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeCell as JaxCell
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.kernels.common import lane_device
from repro_torch.models import attention, layers, model_zoo
from repro_torch.serve import continuous, serve_step
from repro_torch.workloads.requests import Inputs
from test_torch_models import _np, _t

KIMI, H2O, JAMBA = "kimi-k2-1t-a32b", "h2o-danube-1.8b", \
    "jamba-1.5-large-398b"
F32_TOL = 2e-5
TP = 4


def _configs(arch, **kw):
    return (jax_registry.get(arch).reduced().replace(**kw),
            registry.get(arch).reduced().replace(**kw))


def _shape_tree(tree):
    """Each tensor (or jax stand-in) of a tree of dicts, lists and
    tuples replaced by (shape, type name); every sequence a list."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


def _is_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], str)


def _port_vs_ref_caches(cfg, port, ref):
    """The port's caches against the reference's: the reference stacks
    each group's (and an encoder-decoder's every layer's) caches on a
    leading axis, the port keeps a list."""
    p, r = _shape_tree(port), _shape_tree(ref)
    if cfg.is_encoder_decoder:
        for key in ("self", "cross"):
            want = jax.tree.map(lambda s: (s[0][1:], s[1]), r[key],
                                is_leaf=_is_leaf)
            assert p[key] == [want] * cfg.n_layers, key
        return
    want = jax.tree.map(lambda s: (s[0][1:], s[1]), r["groups"],
                        is_leaf=_is_leaf)
    for g in p["groups"]:
        assert jax.tree.leaves(g, is_leaf=_is_leaf) == \
            jax.tree.leaves(want, is_leaf=_is_leaf)
    assert p.get("prefix", []) == r.get("prefix", [])


# --------------------------------------------------------- the repeat
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_kv_repeat_for_is_the_references(arch):
    for reduced in (False, True):
        cfg, jcfg = registry.get(arch), jax_registry.get(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for tp in (1, 2, 4, 8, 16, 32):
            assert attention.kv_repeat_for(cfg, tp) == \
                jax_attn.kv_repeat_for(jcfg, tp), (arch, reduced, tp)


@pytest.mark.parametrize("arch", [a for a in registry.ARCH_IDS
                                  if not registry.get(a).is_encoder_decoder])
def test_init_caches_at_tp_have_the_references_shapes(arch):
    """``init_caches(tp=)``: the reference's shapes and types at tp 1, 4
    and 16 (``reduced()``: kv_repeat 1, 2 and 2)."""
    jcfg, cfg = _configs(arch)
    for tp in (1, 4, 16):
        port = model_zoo.init_caches(cfg, 2, 12, tp=tp, device="cpu")
        ref = jax.eval_shape(lambda tp=tp: jax_zoo.init_caches(jcfg, 2, 12,
                                                               tp=tp))
        _port_vs_ref_caches(cfg, port, ref)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_at_tp16_match_reference(arch):
    """``input_specs(tp=16)`` for every applicable cell at full width:
    the reference's keys, shapes and types, the decode cells' caches
    with the repeated K/V heads."""
    cfg, jcfg = registry.get(arch), jax_registry.get(arch)
    for cell in SHAPES:
        if not shape_applicable(cfg, cell)[0]:
            continue
        specs = model_zoo.input_specs(cfg, cell, tp=16)
        ref = jax_zoo.input_specs(jcfg, JaxCell(cell.name, cell.seq_len,
                                                cell.global_batch,
                                                cell.kind), tp=16)
        assert set(specs) == set(ref), (arch, cell.name)
        for key, v in specs.items():
            if key == "caches":
                _port_vs_ref_caches(cfg, v, ref[key])
            else:
                assert _shape_tree(v) == _shape_tree(ref[key]), (
                    arch, cell.name, key)


# ------------------------------------------ the layers at kv_repeat 2
def _attention_layer_vs_reference(jcfg, cfg, mix, jmix, T, n_steps, seed):
    """The attention layer at kv_repeat 2 in f32: a prefill of ``T``
    positions with its cache, then ``n_steps`` decode steps on it."""
    rng = np.random.default_rng(seed)
    L = T + n_steps
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    sin, cos = layers.rope_table(cfg.head_dim, T, cfg.rope_theta)
    jsin, jcos = jax_layers.rope_table(cfg.head_dim, T, cfg.rope_theta)
    y, cache = attention.attention(mix, _t(x), cfg, sin=sin, cos=cos,
                                   kv_repeat=2, make_cache_len=L)
    jy, jcache = jax_attn.attention(jmix, jnp.asarray(x), jcfg, sin=jsin,
                                    cos=jcos, kv_repeat=2,
                                    make_cache_len=L)
    np.testing.assert_allclose(_np(y), _np(jy), atol=F32_TOL, rtol=F32_TOL)
    assert cache["k"].shape[2] == 2 * cfg.n_kv_heads
    for pos in range(T, L):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        sin, cos = layers.rope_table(cfg.head_dim, 1, cfg.rope_theta,
                                     torch.tensor([pos]))
        jsin, jcos = jax_layers.rope_table(cfg.head_dim, 1, cfg.rope_theta,
                                           jnp.asarray([pos]))
        y, cache = attention.attention_decode(mix, _t(x), cfg, cache, pos,
                                              sin=sin, cos=cos, kv_repeat=2)
        jy, jcache = jax_attn.attention_decode(jmix, jnp.asarray(x), jcfg,
                                               jcache, jnp.int32(pos),
                                               sin=jsin, cos=jcos,
                                               kv_repeat=2)
        np.testing.assert_allclose(_np(y), _np(jy), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"position {pos}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                       atol=F32_TOL, rtol=F32_TOL)


def _attention_pair(jcfg):
    """One attention layer's parameters from the reference's initialiser
    and the port's f32 copy of them."""
    jmix = jax_param.values(jax_attn.init_attention(jax.random.key(2),
                                                    jcfg))
    return jmix, jax.tree.map(lambda a: torch.tensor(np.asarray(
        a, np.float32)), jmix)


def test_h2o_sliding_window_at_kv_repeat_2_matches_reference():
    """h2o-danube's sliding window at kv_repeat 2: a prefill longer than
    the window (8) keeps the last 8 positions' repeated K/V, and the
    decode steps wrap the ring buffer."""
    jcfg, cfg = _configs(H2O, sliding_window=8)
    jmix, mix = _attention_pair(jcfg)
    _attention_layer_vs_reference(jcfg, cfg, mix, jmix, 11, 6, seed=23)


def test_jamba_attention_layer_at_kv_repeat_2_matches_reference():
    """jamba's attention layer (its group's one, 4/2 heads at
    ``reduced()``) at kv_repeat 2."""
    jcfg, cfg = _configs(JAMBA)
    assert cfg.attn_offset < cfg.attn_every
    jmix, mix = _attention_pair(jcfg)
    _attention_layer_vs_reference(jcfg, cfg, mix, jmix, 9, 4, seed=24)


# ------------------------------------------- the repeat changes nothing
@pytest.mark.parametrize("arch,tp", [(KIMI, 4), (H2O, 4), (JAMBA, 4),
                                     ("whisper-tiny", 16),
                                     ("minicpm3-4b", 16)])
def test_tp_changes_no_logit(arch, tp):
    """f32 weights: ``forward`` and a prefill + 2 decode steps at ``tp``
    give tp = 1's logits within 2e-5; where kv_repeat is 1 (whisper,
    minicpm3) bitwise."""
    cfg = registry.get(arch).reduced()
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(25)
    B, P = 2, 8
    toks = _t(rng.integers(0, cfg.vocab_size, (B, P + 2))).long()
    if cfg.is_encoder_decoder:
        frames = _t(rng.standard_normal((B, 10, cfg.d_model))
                    .astype(np.float32))
        batch = {"frames": frames, "dec_tokens": toks[:, :P]}
    else:
        batch = {"tokens": toks[:, :P]}

    def run(tp):
        with torch.inference_mode():
            full, _ = model_zoo.forward(cfg, params, batch, tp=tp)
            _, c = model_zoo.prefill(cfg, params, batch, P + 2, tp=tp)
            steps = [model_zoo.decode_step(cfg, params, toks[:, t:t + 1], c,
                                           t, tp=tp)[0]
                     for t in range(P, P + 2)]
        return [full] + steps

    rep = attention.kv_repeat_for(cfg, tp)
    for a, b in zip(run(tp), run(1)):
        if rep == 1:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a.float(), b.float(), atol=F32_TOL,
                                       rtol=F32_TOL)
    assert rep == (1 if arch in ("whisper-tiny", "minicpm3-4b") else 2)


# -------------------------------------------------- the slots at tp = 4
def test_lm_stepper_at_tp4_join_evict_is_solo_generate():
    """Two slots, three rows: row 0 joins, row 1 joins two steps later,
    row 2 takes row 0's slot when it leaves; each row's tokens equal a
    solo ``generate(tp=4)`` bitwise, and the slots hold the repeated
    K/V heads."""
    cfg = registry.get(KIMI).reduced()
    params = model_zoo.init(cfg, 0, device="cpu")
    P, N = 8, 5
    stepper = continuous.LMStepper(cfg, params, prompt_len=P, new_tokens=N,
                                   n_slots=2, tp=TP)
    prompts = np.random.default_rng(26).integers(0, cfg.vocab_size, (3, P))
    live, done = {}, {}
    with lane_device("cpu"):
        state = stepper.init_slots()
        assert state["caches"]["prefix"][0]["k"].shape[2] == \
            2 * cfg.n_kv_heads

        def join(row, slot):
            spec = SimpleNamespace(arrays=[Inputs(prompts[row:row + 1])])
            (row_state, first, _), = stepper.prefill(spec)
            stepper.insert(state, slot, row_state)
            live[slot] = (row, first, [])

        join(0, 0)
        step = 0
        while len(done) < 3:
            if step == 2:
                join(1, 1)
            state, toks = stepper.step(state)
            step += 1
            for slot, (row, first, got) in list(live.items()):
                got.append(int(toks[slot]))
                if len(got) == N:
                    done[row] = stepper.finish(state, slot, first, got)
                    del live[slot]
                    if row == 0:
                        join(2, slot)
    for row in range(3):
        solo = serve_step.generate(cfg, params, _t(prompts[row:row + 1]),
                                   N, tp=TP, cache_len=stepper.cache_len)
        assert torch.equal(done[row], solo), row
