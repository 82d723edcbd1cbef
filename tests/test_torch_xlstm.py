"""The port's xLSTM (``repro_torch.models.xlstm``) and xlstm-350m against
the JAX reference on the CPU.

Parameters come from the reference's ``model_zoo.init`` (or its block
initialisers) and cross over as numpy arrays
(``models.from_jax.params_from_numpy``); inputs are made with numpy from
a seed.  Tolerances:

* the cells and blocks in f32 (``mlstm_chunkwise`` at chunks 4, 8 and
  32, ``mlstm_recurrent``, ``mlstm_block``, ``slstm_block``): 2e-5
  absolute, 2e-4 relative, the reference's own chunkwise-vs-recurrent
  tolerance (``tests/test_models.py``);
* xlstm-350m ``reduced()`` in bf16, at the reference's bf16 model
  tolerance (atol 0.25, rtol 0.1), the reference run op by op
  (``jax.disable_jit()``);
* a decode step at a (B,) position tensor: bitwise the B one-row steps
  at each row's ``int`` position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ArchConfig, ParallelConfig, XLSTMConfig
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_launch
from repro_torch.models import model_zoo, xlstm
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from repro_torch.serve import continuous, serve_step

XLSTM = "xlstm-350m"
BF16_ATOL, BF16_RTOL = 0.25, 0.1
F32_ATOL, F32_RTOL = 2e-5, 2e-4
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
    jcfg = jax_registry.get(XLSTM).reduced()
    cfg = registry.get(XLSTM).reduced()
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                             device="cpu", dtype=dtype)
    return jcfg, jtree, cfg, tree


def _layer(tree, jtree, i):
    """Layer ``l{i}`` of the first group's mixer (port, reference)."""
    return (tree["stack"]["groups"][0][f"l{i}"]["mix"],
            jax.tree.map(lambda a: a[0], jtree["stack"]["groups"])
            [f"l{i}"]["mix"])


def _cell_inputs(seed, B=2, T=32, nh=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, nh, dh)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((B, T, nh)) * 2).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((B, T, nh)) * 2, jnp.float32)))
    return q, k, v, li, lf


# -------------------------------------------------------------- layout
def test_init_has_the_references_tree():
    """The port's random init builds the reference's tree: the same
    shapes; bf16 weights; f32 norms, ``gn_scale`` and sLSTM's ``r``
    (the reference casts both to f32 at use)."""
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
        g = tree["stack"]["groups"][0]
        assert g["l0"]["mix"]["gn_scale"].dtype == torch.float32
        assert g["l1"]["mix"]["gn_scale"].dtype == torch.float32
        assert g["l1"]["mix"]["r"].dtype == torch.float32
        assert g["l0"]["mix"]["conv_b"].dtype == torch.bfloat16
        assert g["l0"]["mix"]["wq"]["w"].dtype == torch.bfloat16


def test_group_layout_is_the_references():
    from repro.models import blocks as jax_blocks
    from repro_torch.models import blocks, transformer
    for c, jc in ((registry.get(XLSTM), jax_registry.get(XLSTM)),
                  (registry.get(XLSTM).reduced(),
                   jax_registry.get(XLSTM).reduced())):
        assert blocks.group_layout(c) == jax_blocks.group_layout(jc)
        assert not transformer._has_attn(c)
    kinds, _, n = blocks.group_layout(registry.get(XLSTM))
    assert kinds == ["mlstm"] * 7 + ["slstm"] and n == 3
    assert xlstm._mdims(registry.get(XLSTM)) == (2048, 4, 512)


# ---------------------------------------------------------- the cells
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mlstm_chunkwise_matches_reference_f32(chunk):
    """h and the final (C, n, m) state in f32."""
    args = _cell_inputs(0)
    h, st = xlstm.mlstm_chunkwise(*map(_t, args), chunk=chunk)
    jh, jst = jax_xlstm.mlstm_chunkwise(*map(jnp.asarray, args),
                                        chunk=chunk)
    _close(h, jh, "h")
    for a, b, what in zip(st, jst, "Cnm"):
        _close(a, b, what)


def test_mlstm_recurrent_matches_reference_f32():
    """From the empty state and from a given one; the given state is
    not written."""
    args = _cell_inputs(1, T=9)
    h, st = xlstm.mlstm_recurrent(*map(_t, args))
    jh, jst = jax_xlstm.mlstm_recurrent(*map(jnp.asarray, args))
    _close(h, jh, "h")
    more = _cell_inputs(2, T=3)
    given = tuple(s.clone() for s in st)
    h2, st2 = xlstm.mlstm_recurrent(*map(_t, more), state=given)
    jh2, jst2 = jax_xlstm.mlstm_recurrent(*map(jnp.asarray, more),
                                          state=jst)
    _close(h2, jh2, "h from a state")
    for a, b, g, s, what in zip(st2, jst2, given, st, "Cnm"):
        _close(a, b, what)
        assert torch.equal(g, s)


def test_mlstm_chunkwise_vs_recurrent_fp32():
    """The reference's tests/test_models.py::
    test_mlstm_chunkwise_vs_recurrent_fp32, on the port."""
    args = tuple(map(_t, _cell_inputs(3)))
    h2, s2 = xlstm.mlstm_recurrent(*args)
    for chunk in (4, 8, 32):
        h1, s1 = xlstm.mlstm_chunkwise(*args, chunk=chunk)
        np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(s1[0].numpy(), s2[0].numpy(),
                                   atol=2e-5, rtol=2e-4)


def test_mlstm_per_row_products_equal_batched():
    """``per_row`` changes which calls compute the products, not what
    they compute."""
    args = tuple(map(_t, _cell_inputs(4, B=3, T=2)))
    h1, s1 = xlstm.mlstm_recurrent(*args)
    h2, s2 = xlstm.mlstm_recurrent(*args, per_row=True)
    torch.testing.assert_close(h1, h2, atol=1e-6, rtol=1e-6)
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_chunkwise_keeps_the_references_divisibility_assert():
    args = tuple(map(_t, _cell_inputs(5, T=12)))
    with pytest.raises(AssertionError):
        xlstm.mlstm_chunkwise(*args, chunk=8)
    with pytest.raises(AssertionError):
        jax_xlstm.mlstm_chunkwise(*map(jnp.asarray, _cell_inputs(5, T=12)),
                                  chunk=8)


# ---------------------------------------------------------- the blocks
def test_mlstm_block_matches_reference_f32():
    """The prefill (chunkwise) form with its cache, then decode steps
    (the recurrent form) that write the cache in place, in f32."""
    jcfg, jtree, cfg, tree = _pair()
    mix, jmix = _layer(tree, jtree, 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    y, cache = xlstm.mlstm_block(mix, _t(x), cfg, make_cache=True)
    jy, jcache = jax_xlstm.mlstm_block(jmix, jnp.asarray(x), jcfg,
                                       make_cache=True)
    _close(y, jy, "prefill")
    _close(cache["conv"], jcache["conv"], "conv state")
    for a, b in zip(cache["state"], jcache["state"]):
        _close(a, b, "state")
    for t in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y, out = xlstm.mlstm_block(mix, _t(xt), cfg, decode_state=cache)
        assert out is cache
        jy, jcache = jax_xlstm.mlstm_block(jmix, jnp.asarray(xt), jcfg,
                                           decode_state=jcache)
        _close(y, jy, f"step {t}")
        for a, b in zip(leaves(cache), jax.tree.leaves(jcache)):
            _close(a, b, f"step {t} cache")


def test_mlstm_block_short_prompt_pads_the_conv_state():
    """A prompt shorter than the conv window: the cache's conv state is
    left-padded with zeros, as in the reference."""
    jcfg, jtree, cfg, tree = _pair()
    mix, jmix = _layer(tree, jtree, 0)
    x = np.random.default_rng(7).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    _, cache = xlstm.mlstm_block(mix, _t(x), cfg, make_cache=True)
    _, jcache = jax_xlstm.mlstm_block(jmix, jnp.asarray(x), jcfg,
                                      make_cache=True)
    assert cache["conv"].shape == (1, cfg.xlstm.conv_width - 1,
                                   xlstm._mdims(cfg)[0])
    _close(cache["conv"], jcache["conv"])


def test_slstm_block_matches_reference_f32():
    """From the empty state (the prefill) and from that state (decode
    steps, written in place), in f32."""
    jcfg, jtree, cfg, tree = _pair()
    mix, jmix = _layer(tree, jtree, 1)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    y, st = xlstm.slstm_block(mix, _t(x), cfg)
    jy, jst = jax_xlstm.slstm_block(jmix, jnp.asarray(x), jcfg)
    _close(y, jy, "prefill")
    for a, b, what in zip(st, jst, "cnhm"):
        _close(a, b, what)
    for t in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y, out = xlstm.slstm_block(mix, _t(xt), cfg, state=st)
        assert out is st
        jy, jst = jax_xlstm.slstm_block(jmix, jnp.asarray(xt), jcfg,
                                        state=jst)
        _close(y, jy, f"step {t}")
        for a, b in zip(st, jst):
            _close(a, b, f"step {t} state")


def test_caches_are_the_references():
    jcfg, _, cfg, _ = _pair()
    caches = model_zoo.init_caches(cfg, 3, 10, device="cpu")
    jc = jax_zoo.init_caches(jcfg, 3, 10)
    jg = jax.tree.map(lambda a: a[0], jc["groups"])
    for i in ("l0", "l1"):
        mine, ref = leaves(caches["groups"][0][i]), jax.tree.leaves(jg[i])
        assert [tuple(a.shape) for a in mine] == [a.shape for a in ref]
        for a, b in zip(mine, ref):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(_np(a), _np(b))


# ------------------------------------------------------- whole models
def test_model_forward_prefill_decode_match_reference():
    """``forward``, ``prefill`` and teacher-forced ``decode_step``
    logits at the bf16 model tolerance."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    B, P, N = 2, 8, 4
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
        full, aux = model_zoo.forward(cfg, tree, {"tokens": _ids(toks)})
        log, c = model_zoo.prefill(cfg, tree, {"tokens": _ids(toks[:, :P])},
                                   cache_len=P + N)
        steps = [model_zoo.decode_step(cfg, tree, _ids(toks[:, t:t + 1]), c,
                                       t)[0] for t in range(P, P + N)]
    assert full.dtype == torch.bfloat16 and float(aux) == 0.0
    for got, want, what in [(full, jfull, "forward"), (log, jlog, "prefill")]:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=what)
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, P + t]),
                                   atol=BF16_ATOL, rtol=BF16_RTOL,
                                   err_msg=f"step {t} against forward")


def test_decode_from_empty_caches_matches_reference():
    """Decoding a prompt token by token from ``init_caches`` (the
    recurrent states from zero, ``m`` at NEG) matches the reference."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    with torch.inference_mode():
        caches = model_zoo.init_caches(cfg, 2, 5, device="cpu")
        steps = [model_zoo.decode_step(cfg, tree, _ids(toks[:, t:t + 1]),
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


def test_decode_xlstm():
    """The reference's tests/test_models.py::test_decode_xlstm, on the
    port: prefill(P) + step decode match the full forward."""
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.configs.base import ParallelConfig as TPar
    from repro_torch.configs.base import XLSTMConfig as TX
    kw = dict(name="t", family="ssm", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16,
              block_pattern="xlstm")
    cfg = TArch(**kw, xlstm=TX(slstm_every=2, chunk_size=4),
                parallel=TPar(remat="none"))
    jcfg = ArchConfig(**kw, xlstm=XLSTMConfig(slstm_every=2, chunk_size=4),
                      parallel=ParallelConfig(remat="none"))
    assert repr(cfg) == repr(jcfg)
    T = 8
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
def test_row_positions_equal_int_steps():
    """One ``decode_step`` over B rows at a (B,) position tensor (the
    engine's slots, rows at different depths) equals B one-row steps at
    each row's ``int`` position, bitwise: the logits and every
    recurrent state."""
    cfg = registry.get(XLSTM).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    rng = np.random.default_rng(11)
    B, P, L = 3, 4, 16
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
                assert torch.equal(x, y), f"row {b}'s state"


def test_decode_step_advances_the_state_in_place():
    """Each step writes every layer's new state into the cache tensors
    the caller holds: two steps from one cache differ from two
    different first steps, and the tree's tensors stay the same
    objects."""
    cfg = registry.get(XLSTM).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    prompt = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 4)))
    with torch.inference_mode():
        _, c = model_zoo.prefill(cfg, params, {"tokens": prompt}, 8)
        before = [t.clone() for t in leaves(c)]
        ids = [id(t) for t in leaves(c)]
        a, _ = model_zoo.decode_step(cfg, params, prompt[:, -1:], c, 4)
        assert [id(t) for t in leaves(c)] == ids
        assert all(not torch.equal(x, y) for x, y in zip(before, leaves(c)))
        b, _ = model_zoo.decode_step(cfg, params, prompt[:, -1:], c, 5)
    assert not torch.equal(a, b)


# ------------------------------------------------------------ serving
def test_generate_matches_reference():
    """Greedy tokens equal the reference's ``generate`` (run op by op),
    but where the reference's top-1/top-2 gap is under the bf16 model
    tolerance (the models' margin rule)."""
    from repro.serve import serve_step as jax_serve
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
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
    out = serve_step.generate(cfg, tree, _ids(prompt), N).numpy()
    assert out.shape == (B, N + 1)
    for b in range(B):
        for t in range(N + 1):
            if out[b, t] != ref[b, t]:
                assert gaps[b, t] < BF16_ATOL, (b, t, gaps[b, t])
                break


def test_launcher_streams_xlstm_on_the_cpu(capsys):
    """``launch/serve.py --arch xlstm-350m --stream --continuous`` (the
    reference's documented recipe) at the reduced config on the CPU:
    every request's tokens are the solo run's, the recurrent caches
    stepping in the engine's slots."""
    from repro_torch.workloads import requests as adapters

    argv = ["--arch", XLSTM, "--batch", "1", "--prompt-len", "8",
            "--new-tokens", "3"]
    solo = serve_launch.main(argv, device="cpu")
    out = serve_launch.main(argv + ["--stream", "--continuous", "--rate",
                                    "20", "--duration", "0.3"],
                            device="cpu")
    assert out["rejected"] == 0 and out["tokens"]
    assert all(torch.equal(t, solo) for t in out["tokens"])
    st = out["stats"]
    assert st.engine_steps > 0 and st.in_flight == 0
    assert "xlstm-350m" in capsys.readouterr().out
    adapters.unregister(out["workload"])


# ------------------------------------------- where the reference stops
def _ref_decode_gaps(jcfg, jtree, toks, P):
    """The reference's own decode-vs-forward gap, op by op: the max
    |diff| of the prefill's last position and each teacher-forced step
    against ``forward``'s logits at the same position."""
    with jax.disable_jit():
        full, _ = jax_zoo.forward(jcfg, jtree, {"tokens": jnp.asarray(toks)})
        lg, c = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(
            toks[:, :P])}, cache_len=toks.shape[1])
        gaps = [float(jnp.max(jnp.abs(lg[:, -1].astype(jnp.float32)
                                      - full[:, P - 1].astype(jnp.float32))))]
        for t in range(P, toks.shape[1]):
            lg, c = jax_zoo.decode_step(jcfg, jtree,
                                        jnp.asarray(toks[:, t:t + 1]), c,
                                        jnp.int32(t))
            gaps.append(float(jnp.max(jnp.abs(
                lg[:, 0].astype(jnp.float32)
                - full[:, t].astype(jnp.float32)))))
    return gaps


def test_reference_misses_decode_consistency_at_full_width():
    """At xlstm-350m's full width (one 8-layer group, d_model 1024) the
    reference's own decode steps miss its forward's logits by more than
    the bf16 model tolerance (0.25), run op by op: a prefill whose
    chunk differs from the forward's (64 against 68) already moves the
    last position's logits, and a bf16 ulp in a few percent of each
    random layer's outputs grows through the stack.  So
    ``chip_smoke.py`` prints the full-width gap and holds the chunkwise
    and recurrent cells in f32 and the reference's own small
    decode-consistency config instead."""
    import dataclasses
    jcfg = jax_registry.get(XLSTM).replace(n_layers=8)
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel,
                                                     remat="none"))
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(1)))
    P, n = 64, 4
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, P + n)).astype(np.int32)
    gaps = _ref_decode_gaps(jcfg, jtree, toks, P)
    print("the reference's decode-vs-forward gap a step:", gaps)
    assert len(gaps) == n + 1 and max(gaps) > BF16_ATOL, gaps
