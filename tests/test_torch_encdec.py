"""The port's encoder-decoder (``repro_torch.models.encdec``) and its
cross-attention (``models.attention.cross_attention``) against the JAX
reference on the CPU, at whisper-tiny's ``reduced()`` config.

Parameters come from the reference's ``model_zoo.init`` and cross over
as numpy arrays (``models.from_jax.params_from_numpy``, which un-stacks
``enc_layers`` / ``dec_layers``); inputs are made with numpy from a
seed.  Tolerances:

* cross-attention in f32 on the CPU peer (K7's plain version) against
  the reference's grouped-einsum ``_sdpa``: 2e-5, the f32 attention
  tolerance of ``tests/test_kernels.py``;
* the whole model in bf16 (``forward``, ``encode``, ``decode_step``) at
  the reference's bf16 model tolerance (atol 0.25, rtol 0.1,
  tests/test_models.py), the reference run op by op
  (``jax.disable_jit()``) with its unmasked attention pinned to its
  unblocked f32 oracle (``xla_ref``), which is what K7's plain version
  computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ArchConfig, ParallelConfig
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention, encdec, model_zoo
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from torch_ref_pin import ref_op_by_op

WHISPER = "whisper-tiny"
BF16_ATOL, BF16_RTOL = 0.25, 0.1
F32_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(dtype=torch.float32, arch=WHISPER):
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


def _inputs(cfg, B=2, S=10, T=8, seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dec = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return frames, dec


# -------------------------------------------------------------- layout
def test_init_has_the_references_tree():
    """The port's random init builds the reference's tree with its layer
    stacks as lists: the same shapes, bf16 weights, f32 norms."""
    _, _, cfg, _ = _pair()
    _, _, _, ref = _pair(torch.bfloat16)
    mine = model_zoo.init(cfg, 3, device="cpu")
    assert _shapes(mine) == _shapes(ref)
    assert len(mine["enc_layers"]) == cfg.n_enc_layers == 2
    assert len(mine["dec_layers"]) == cfg.n_layers
    for key in ("enc_norm", "dec_norm"):
        assert mine[key]["scale"].dtype == torch.float32
    assert mine["dec_layers"][0]["norm3"]["bias"].dtype == torch.float32
    assert mine["dec_layers"][0]["cross_attn"]["wq"]["w"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("T,offset", [(7, 0), (1, 5), (3, 1499)])
def test_sinusoid_pos_matches_reference(T, offset):
    np.testing.assert_allclose(
        _np(encdec.sinusoid_pos(T, 64, offset=offset)),
        _np(jax_encdec.sinusoid_pos(T, 64, offset=offset)), rtol=1e-5,
        atol=1e-5)


# ------------------------------------------------------ cross-attention
@pytest.mark.parametrize("T,S", [(8, 10), (1, 13), (5, 5)])
def test_cross_attention_matches_reference_sdpa_f32(T, S):
    """The CPU peer of K7's full route against the reference's grouped
    einsum (its cross-attention with no pin and no tune-cache hit), and
    ``encode_cross_kv``, in f32."""
    jcfg, jtree, cfg, tree = _pair()
    lp = tree["dec_layers"][0]["cross_attn"]
    jlp = jax.tree.map(lambda a: a[0], jtree["dec_layers"])["cross_attn"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    kv = attention.encode_cross_kv(lp, _t(enc), cfg)
    jkv = jax_attn.encode_cross_kv(jlp, jnp.asarray(enc), jcfg)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(kv[key]), _np(jkv[key]),
                                   rtol=F32_TOL, atol=F32_TOL)
    assert jax_attn._can_use_tuned_sdpa(jcfg, causal=False)
    y = attention.cross_attention(lp, _t(x), kv, cfg)
    jy = jax_attn.cross_attention(jlp, jnp.asarray(x), jkv, jcfg)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=F32_TOL, atol=F32_TOL)


def test_cross_attention_goes_through_the_flash_entry(monkeypatch):
    """Cross-attention and the encoder's self-attention call K7's entry
    unmasked (``causal=False``), the decoder's self-attention causal."""
    _, _, cfg, tree = _pair()
    calls = []
    real = flash_ops.sdpa

    def spy(q, k, v, *, causal=True, config=None):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, config=config)

    monkeypatch.setattr(flash_ops, "sdpa", spy)
    frames, dec = _inputs(cfg, S=12, T=5)
    with torch.inference_mode():
        model_zoo.forward(cfg, tree, {"frames": _t(frames),
                                      "dec_tokens": _t(dec)})
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    assert calls == ([(12, 12, False)] * n_enc
                     + [(5, 5, True), (5, 12, False)] * n_dec)


# --------------------------------------------------------- whole model
def test_forward_and_encode_match_reference():
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    frames, dec = _inputs(cfg)
    fb = _t(frames).bfloat16()
    jfb = jnp.asarray(frames, jnp.bfloat16)
    with ref_op_by_op():
        jenc = jax_encdec.encode(jtree, jfb, jcfg)
        jfull, _ = jax_zoo.forward(jcfg, jtree, {"frames": jfb,
                                                 "dec_tokens": jnp.asarray(
                                                     dec)})
    with torch.inference_mode():
        enc = encdec.encode(tree, fb, cfg)
        full, aux = model_zoo.forward(cfg, tree, {"frames": fb,
                                                  "dec_tokens": _t(dec)})
    assert enc.dtype == torch.bfloat16 and enc.shape == (2, 10, cfg.d_model)
    assert full.shape == (2, 8, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(enc), _np(jenc), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    np.testing.assert_allclose(_np(full), _np(jfull), atol=BF16_ATOL,
                               rtol=BF16_RTOL)


def test_decode_step_matches_reference():
    """``init_caches(params=, enc_out=)`` then teacher-forced
    ``decode_step``s, against the reference doing the same."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    frames, dec = _inputs(cfg)
    fb = _t(frames).bfloat16()
    jfb = jnp.asarray(frames, jnp.bfloat16)
    with ref_op_by_op():
        jenc = jax_encdec.encode(jtree, jfb, jcfg)
        jc = jax_zoo.init_caches(jcfg, 2, 8, params=jtree, enc_out=jenc)
        jsteps = []
        for t in range(8):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(dec[:, t:t + 1]), jc,
                                         jnp.int32(t))
            jsteps.append(lg)
    with torch.inference_mode():
        enc = encdec.encode(tree, fb, cfg)
        c = model_zoo.init_caches(cfg, 2, 8, params=tree, enc_out=enc)
        assert len(c["self"]) == len(c["cross"]) == cfg.n_layers
        assert c["self"][0]["k"].dtype == torch.bfloat16
        steps = []
        for t in range(8):
            lg, out = model_zoo.decode_step(cfg, tree, _t(dec[:, t:t + 1]),
                                            c, t)
            assert out is c
            steps.append(lg)
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        assert lg.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")


def test_prefill_returns_empty_self_caches_as_the_reference():
    """The reference's enc-dec ``prefill`` returns ``init_dec_caches``:
    the decoder prompt's self-attention K/V are not written (kept as
    the reference has it).  The port does the same; its logits are
    ``forward``'s."""
    jcfg, jtree, cfg, tree = _pair(torch.bfloat16)
    frames, dec = _inputs(cfg)
    fb = _t(frames).bfloat16()
    batch = {"frames": fb, "dec_tokens": _t(dec)}
    with ref_op_by_op():
        _, jc = jax_zoo.prefill(jcfg, jtree, {
            "frames": jnp.asarray(frames, jnp.bfloat16),
            "dec_tokens": jnp.asarray(dec)}, cache_len=12)
    with torch.inference_mode():
        log, c = model_zoo.prefill(cfg, tree, batch, cache_len=12)
        full, _ = model_zoo.forward(cfg, tree, batch)
    assert torch.equal(log, full)
    assert not bool(np.asarray(jc["self"]["k"]).any())
    for self_c in c["self"]:
        assert self_c["k"].shape == (2, 12, cfg.n_kv_heads, cfg.head_dim)
        assert not self_c["k"].any() and not self_c["v"].any()
    for i, cross in enumerate(c["cross"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cross[key]),
                                       _np(jc["cross"][key][i]),
                                       atol=BF16_ATOL, rtol=BF16_RTOL)


def test_init_caches_needs_params_and_enc_out():
    _, _, cfg, tree = _pair()
    with pytest.raises(ValueError, match="enc_out"):
        model_zoo.init_caches(cfg, 2, 8, params=tree)


# the reference's tests/test_models.py::test_whisper_decode_consistency,
# on the port
def test_whisper_decode_consistency():
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.configs.base import ParallelConfig as TPar
    kw = dict(name="w", family="audio", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
              is_encoder_decoder=True, n_enc_layers=2,
              norm_type="layernorm", use_bias=True, mlp_gated=False,
              act="gelu")
    cfg = TArch(**kw, parallel=TPar(remat="none"))
    assert repr(cfg) == repr(ArchConfig(**kw,
                                        parallel=ParallelConfig(remat="none")))
    params = model_zoo.init(cfg, 1, device="cpu")
    gen = torch.Generator().manual_seed(3)
    frames = torch.randn((2, 10, 64), generator=gen).bfloat16()
    dec = torch.randint(0, 256, (2, 8), generator=gen)
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, params, {"frames": frames,
                                                  "dec_tokens": dec})
        enc_out = encdec.encode(params, frames, cfg)
        caches = encdec.init_dec_caches(params, enc_out, cfg, 2, 8)
        for t in range(8):
            lg, caches = encdec.decode_step(params, dec[:, t:t + 1], cfg,
                                            caches, t)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]),
                                       atol=0.25, rtol=0.1)


@pytest.mark.parametrize("arch", [WHISPER])
def test_whisper_full_config_runs_at_a_short_window(arch):
    """The full whisper-tiny config (4 + 4 layers, d_model 384) runs
    forward and decode steps on the CPU at a short window, finite and
    consistent."""
    cfg = registry.get(arch)
    params = model_zoo.init(cfg, 0, device="cpu")
    assert sum(t.numel() for t in leaves(params)) > 30_000_000
    gen = torch.Generator().manual_seed(4)
    frames = torch.randn((1, 24, cfg.d_model), generator=gen).bfloat16()
    dec = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen)
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, params, {"frames": frames,
                                                  "dec_tokens": dec})
        enc = encdec.encode(params, frames, cfg)
        c = model_zoo.init_caches(cfg, 1, 4, params=params, enc_out=enc)
        for t in range(4):
            lg, c = model_zoo.decode_step(cfg, params, dec[:, t:t + 1], c, t)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]),
                                       atol=0.25, rtol=0.1)
    assert bool(torch.isfinite(full.float()).all())


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("argv", [["--arch", WHISPER],
                                  ["--arch", WHISPER, "--stream"]])
def test_launcher_refuses_enc_dec_as_the_reference(argv):
    """``launch/serve.py`` refuses an encoder-decoder arch with the
    reference's ``SystemExit`` (``src/repro/launch/serve.py``), before it
    needs a device or makes weights."""
    with pytest.raises(SystemExit, match="enc-dec serving"):
        serve_launch.main(argv, device="cpu")
    with pytest.raises(SystemExit, match="enc-dec serving"):
        serve_launch.main(argv)
