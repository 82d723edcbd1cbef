"""The model layers' tune-cache lookup (``autotune.cached_or_default``,
``flash_attention.ops.model_config`` / ``sdpa(config=)``,
``gmm.ops.gmm_model``) against the JAX reference's, on the CPU.

* ``cached_or_default`` resolves pin > search disabled > cache hit >
  default in both packages on the same scenario, each under its own
  backend key: the port reads a ``torch:cpu`` hit and never the
  reference's ``cpu`` entry, and times nothing.
* ``sdpa``: the reference's ``tests/test_cost_model.py::
  test_sdpa_matches_reference_and_uses_pinned_config`` through both
  packages on the same f32 inputs at 2e-5: the default, then a pin of
  the kernel (the port's ``cuda``, the reference's ``pallas``), which a
  CPU tensor runs on the blocked attention, with gradients through it
  equal to the reference's.  An impl the port lacks raises a
  ``ValueError`` that names it.
* The attention layer (``test_model_attention_routes_through_tuned_
  path``): with no pin and no hit the route is what it was (the flash
  entry on its default where autograd does not record, the einsum
  where it does); a pin or hit takes ``sdpa`` on its config, also under
  autograd; windows and softcaps never do; under an active mesh no pin
  is read.  Its output equals the reference layer's under the same pin
  at 2e-5.
* ``gmm_model`` (``test_moe_gmm_model_parity_and_grads``): the default
  and a ``cuda`` pin under autograd against the reference's einsum at
  2e-5 with equal gradients; a ``torch_plain`` pin runs ``gmm_torch``;
  a hit is read for its own bucket only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.kernels import autotune as ref_at
from repro.kernels.flash_attention import ops as ref_flash
from repro.kernels.gmm import ops as ref_gmm
from repro.models import attention as jax_attn
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.kernels import autotune as at
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention
from repro_torch.parallel.sharding import use_mesh

TOL = 2e-5
FLASH_PIN = "REPRO_TUNE_PIN_FLASH_ATTENTION"
GMM_PIN = "REPRO_TUNE_PIN_GMM"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Search on, no pin, one throwaway tune file for both packages, and
    a timer that fails: the lookup never searches."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    for var in (FLASH_PIN, GMM_PIN):
        monkeypatch.delenv(var, raising=False)

    def boom(fn):
        pytest.fail("the model layers' lookup timed a candidate")
    prev = at.set_timer(boom)
    at.reset_tune_cache()
    ref_at.reset_tune_cache()
    yield tmp_path
    at.set_timer(prev)
    at.reset_tune_cache()
    ref_at.reset_tune_cache()


# ------------------------------------------------- cached_or_default
def test_cached_or_default_resolves_like_the_reference(stores, monkeypatch):
    default = {"impl": "a", "tile": 1}
    port = at.get_tune_cache()
    ref = ref_at.get_tune_cache()

    def both():
        return (at.cached_or_default("k", "B1", default),
                ref_at.cached_or_default("k", "B1", default))

    # no pin, no hit: the default
    assert both() == (default, default)
    # a hit under each package's own key; the port reads torch:cpu only
    ref.put(jax.default_backend(), "k", "B1", {"impl": "b"}, 1.0)
    assert at.cached_or_default("k", "B1", default) == default
    port.put("torch:cpu", "k", "B1", {"impl": "c"}, 1.0)
    assert both() == ({"impl": "c", "tile": 1}, {"impl": "b", "tile": 1})
    assert at.cached_or_default("k", "B1", default,
                                device="cpu") == {"impl": "c", "tile": 1}
    # another bucket, and a CUDA device's key, miss
    assert at.cached_or_default("k", "B2", default) == default
    assert at.cached_or_default("k", "B1", default,
                                device="cuda") == default
    # search disabled: the default, hit or not
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert both() == (default, default)
    # a pin wins over everything, merged over the default
    monkeypatch.setenv("REPRO_TUNE_PIN_K", '{"tile": 7}')
    assert both() == ({"impl": "a", "tile": 7},) * 2
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert both() == ({"impl": "a", "tile": 7},) * 2


# ---------------------------------------------------------------- sdpa
def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))


def test_sdpa_matches_reference_and_uses_pinned_config(stores, monkeypatch):
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(_t, (q, k, v))
    ref = ref_flash.flash_attention(jq, jk, jv, causal=True,
                                    use_kernel=False)
    assert flash_ops.model_config(tq, tk, tv, causal=True) is None
    out = flash_ops.sdpa(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    # the kernel pinned: the reference's pallas, the port's cuda; both
    # map onto the blocked attention, whose gradients flow
    monkeypatch.setenv(FLASH_PIN,
                       '{"impl": "pallas", "block_q": 32, "block_k": 32}')
    jout = ref_flash.sdpa(jq, jk, jv, causal=True)
    jg = jax.grad(lambda q_: ref_flash.sdpa(q_, jk, jv, causal=True)
                  .astype(jnp.float32).sum())(jq)
    monkeypatch.setenv(FLASH_PIN, '{"impl": "cuda", "block_q": 32}')
    cfg = flash_ops.model_config(tq, tk, tv, causal=True)
    assert cfg == {"impl": "torch_blocked", "block_q": 32}
    assert flash_ops.model_config(tq, tk, tv, causal=False)["impl"] == \
        "torch_ref"
    out2 = flash_ops.sdpa(tq, tk, tv, causal=True, config=cfg)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    tq.requires_grad_(True)
    cfg = flash_ops.model_config(tq, tk, tv, causal=True)
    assert cfg["impl"] == "torch_blocked"
    flash_ops.sdpa(tq, tk, tv, causal=True, config=cfg).sum().backward()
    assert bool(torch.isfinite(tq.grad).all()) and \
        float(tq.grad.abs().max()) > 0
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl", ["xla_ref", "pallas", "xla_blocked"])
def test_unknown_impl_raises_naming_it(stores, monkeypatch, impl):
    """A pin or hit naming an impl the port lacks raises a ValueError
    that names it; nothing falls back to the default."""
    tq, tk, tv = map(_t, _qkv())

    def attend():
        return flash_ops.sdpa(tq, tk, tv, causal=True,
                              config=flash_ops.model_config(tq, tk, tv,
                                                            causal=True))
    monkeypatch.setenv(FLASH_PIN, f'{{"impl": "{impl}"}}')
    with pytest.raises(ValueError, match=impl):
        attend()
    monkeypatch.delenv(FLASH_PIN)
    at.get_tune_cache().put(
        "torch:cpu", "flash_attention",
        flash_ops.shape_bucket(8, 64, 64, 32, True), {"impl": impl}, 1.0)
    with pytest.raises(ValueError, match=impl):
        attend()
    monkeypatch.setenv(GMM_PIN, f'{{"impl": "{impl}"}}')
    with pytest.raises(ValueError, match=impl):
        gmm_ops.gmm_model(torch.zeros(2, 3, 4), torch.zeros(2, 4, 5))


def test_model_config_reads_the_hit_of_its_bucket(stores):
    tq, tk, tv = map(_t, _qkv())
    at.get_tune_cache().put(
        "torch:cpu", "flash_attention",
        flash_ops.shape_bucket(8, 64, 64, 32, True),
        {"impl": "torch_blocked", "block_q": 16}, 1.0)
    assert flash_ops.model_config(tq, tk, tv, causal=True) == \
        {"impl": "torch_blocked", "block_q": 16}
    # the causal flag is part of the bucket
    assert flash_ops.model_config(tq, tk, tv, causal=False) is None
    # a CUDA entry of the same bucket is not this backend's
    at.get_tune_cache().put(
        "torch:cuda", "flash_attention",
        flash_ops.shape_bucket(8, 64, 64, 32, False), {"impl": "cuda"}, 1.0)
    assert flash_ops.model_config(tq, tk, tv, causal=False) is None


# --------------------------------------------------- the attention layer
def _layer_cfgs(**kw):
    common = dict(name="t", family="dense", n_layers=1, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64, **kw)
    return (JaxArchConfig(parallel=JaxParallelConfig(remat="none"),
                          **common),
            ArchConfig(parallel=ParallelConfig(remat="none"), **common))


def _layer(jcfg, cfg):
    from repro.models.param import values
    jp = values(jax_attn.init_attention(jax.random.key(0), jcfg))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                      jp)
    x = np.random.default_rng(3).standard_normal((2, 16, 32)) \
        .astype(np.float32)
    return jp, tp, x


def _spy(monkeypatch):
    """Record the config of every ``flash_ops.sdpa`` call."""
    seen, real = [], flash_ops.sdpa

    def sdpa(q, k, v, *, causal=True, config=None):
        seen.append(config)
        return real(q, k, v, causal=causal, config=config)
    monkeypatch.setattr(flash_ops, "sdpa", sdpa)
    return seen


def test_model_attention_routes_through_tuned_path(stores, monkeypatch):
    jcfg, cfg = _layer_cfgs()
    jp, tp, x = _layer(jcfg, cfg)
    seen = _spy(monkeypatch)
    # no pin, no hit: the default where autograd does not record ...
    with torch.no_grad():
        y0, _ = attention.attention(tp, _t(x), cfg)
    assert seen == [None]
    # ... and the einsum where it does
    xg = _t(x).requires_grad_(True)
    yg, _ = attention.attention(tp, xg, cfg)
    assert seen == [None]
    torch.testing.assert_close(yg.detach(), y0, rtol=TOL, atol=TOL)
    # a pin: sdpa on its config, also under autograd, the kernel mapped
    # onto the blocked attention; the reference's layer under its pin
    monkeypatch.setenv(FLASH_PIN, '{"impl": "pallas", "block_q": 8}')
    jy, _ = jax_attn.attention(jp, jnp.asarray(x), jcfg)
    monkeypatch.setenv(FLASH_PIN, '{"impl": "cuda", "block_q": 8}')
    y1, _ = attention.attention(tp, xg, cfg)
    assert seen[1:] == [{"impl": "torch_blocked", "block_q": 8}]
    y1.sum().backward()
    assert bool(torch.isfinite(xg.grad).all())
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    # windows and softcaps keep the einsum; a full-attention call with a
    # window takes the pin
    for extra, causal, takes in [({"sliding_window": 8}, True, False),
                                 ({"sliding_window": 8}, False, True),
                                 ({"logit_softcap": 30.0}, True, False)]:
        del seen[:]
        attention.attention(tp, _t(x), cfg.replace(**extra), causal=causal)
        assert (seen != []) == takes, (extra, causal)


def test_model_attention_reads_a_hit(stores, monkeypatch):
    """A tune-cache hit for the layer's bucket (B*H = 8, T = S = 16,
    d = 8, causal) is read: sdpa runs on it."""
    jcfg, cfg = _layer_cfgs()
    _, tp, x = _layer(jcfg, cfg)
    seen = _spy(monkeypatch)
    at.get_tune_cache().put(
        "torch:cpu", "flash_attention",
        flash_ops.shape_bucket(8, 16, 16, 8, True),
        {"impl": "torch_blocked", "block_q": 4}, 1.0)
    with torch.no_grad():
        y, _ = attention.attention(tp, _t(x), cfg)
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        y0, _ = attention.attention(tp, _t(x), cfg)
    assert seen == [{"impl": "torch_blocked", "block_q": 4}, None]
    torch.testing.assert_close(y, y0, rtol=TOL, atol=TOL)


def test_no_pin_is_read_under_an_active_mesh(stores, monkeypatch):
    """Under a mesh the reference reads no pin: a pin naming an impl the
    port lacks (which raises where it is read) changes nothing, and the
    route is the default's."""
    jcfg, cfg = _layer_cfgs()
    _, tp, x = _layer(jcfg, cfg)
    with torch.no_grad():
        y0, _ = attention.attention(tp, _t(x), cfg)
    seen = _spy(monkeypatch)
    monkeypatch.setenv(FLASH_PIN, '{"impl": "xla_ref"}')
    mesh = mesh_mod.make_host_mesh(device="cpu")
    try:
        with use_mesh(mesh), torch.no_grad():
            y, _ = attention.attention(tp, _t(x), cfg)
    finally:
        mesh_mod.release()
    assert seen == [None]
    assert torch.equal(y, y0)
    with pytest.raises(ValueError, match="xla_ref"):
        attention.attention(tp, _t(x), cfg)


# ----------------------------------------------------------- gmm_model
def _gmm_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, 32, 16)).astype(np.float32),
            rng.standard_normal((4, 16, 24)).astype(np.float32))


def _ran(monkeypatch):
    """Record which formulation each ``gmm_model`` call ran."""
    ran = []
    for name, impl in (("gmm_ref", "torch_einsum"),
                       ("gmm_torch", "torch_plain")):
        real = getattr(gmm_ops, name)
        monkeypatch.setattr(gmm_ops, name, lambda x, w, _r=real, _i=impl:
                            (ran.append(_i), _r(x, w))[1])
    return ran


def test_moe_gmm_model_parity_and_grads(stores, monkeypatch):
    x, w = _gmm_inputs()
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    ref = jnp.einsum("ecd,edf->ecf", jx, jw)
    jg = jax.grad(lambda x_: ref_gmm.gmm_model(x_, jw).sum())(jx)
    ran = _ran(monkeypatch)
    np.testing.assert_allclose(gmm_ops.gmm_model(_t(x), _t(w)).numpy(),
                               np.asarray(ref), rtol=TOL, atol=TOL)
    # a cuda pin under autograd: the einsum, whose gradients flow
    monkeypatch.setenv(GMM_PIN, '{"impl": "cuda"}')
    tx = _t(x).requires_grad_(True)
    out = gmm_ops.gmm_model(tx, _t(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    out.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)
    # ... and on a CPU tensor without autograd too
    with torch.no_grad():
        gmm_ops.gmm_model(_t(x), _t(w))
    # a torch_plain pin runs gmm_torch
    monkeypatch.setenv(GMM_PIN, '{"impl": "torch_plain"}')
    gmm_ops.gmm_model(_t(x), _t(w))
    assert ran == ["torch_plain", "torch_einsum", "torch_einsum",
                   "torch_plain"]


def test_gmm_model_reads_the_hit_of_its_bucket(stores, monkeypatch):
    x, w = _gmm_inputs()
    at.get_tune_cache().put("torch:cpu", "gmm",
                            gmm_ops.shape_bucket(4, 32, 16, 24),
                            {"impl": "torch_einsum"}, 1.0)
    ran = _ran(monkeypatch)
    with torch.no_grad():
        gmm_ops.gmm_model(_t(x), _t(w))                # the hit
        gmm_ops.gmm_model(_t(x[:, :3]), _t(w))         # C = 3: a miss
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        gmm_ops.gmm_model(_t(x), _t(w))                # search off
    assert ran == ["torch_einsum", "torch_plain", "torch_plain"]
