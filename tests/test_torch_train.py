"""The port's train step (``repro_torch.train.train_step``), remat and
the route under autograd, against the reference, on the CPU.

* ``cross_entropy`` with and without a mask at 1e-6;
* ``make_train_step(accum=4)`` against the reference's on the same f32
  weights and batch (the reference op by op, its ``lax.scan`` and the
  port's loop both summing in the config's ``grad_reduce_dtype``, bf16;
  the reference is given it as ``"bfloat16"``, its own spelling
  ``"bf16"`` being no name ``jnp.dtype`` knows):
  the summed gradients at the parity tolerance of
  ``tests/torch_train_parity.py``, the loss at its ``LOSS_ATOL``;
* ``accum=4`` against ``accum=1`` in the port, as relative L2 errors a
  leaf: a weight's gradient is a bf16 product, rounded to bf16 (2^-9
  relative) in each micro-batch and in the whole batch alike, so with
  an f32 reduce the two agree to ~2^-9 (held to 2^-8; measured 2.4e-3),
  and the bf16 reduce adds its own five roundings (held to 2^-7;
  measured 3.9e-3);
* remat ``"dots"`` and ``"full"`` give gradients bit for bit those of
  ``"none"``, ``"dots"`` recomputing no matmul and ``"full"`` all of
  them; the named policies raise;
* the route: under autograd, attention takes the grouped einsum
  ``_sdpa`` and the MoE's grouped matmuls ``torch_einsum`` (the
  reference's differentiable formulations); under ``no_grad`` both take
  the device's default (on the CPU the oracle and the plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jax_registry
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.optim import optimizer as jax_opt
from repro.train import train_step as jax_train
from repro_torch.configs import registry
from repro_torch.core.tree import flatten_with_path, leaves
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.models import attention, model_zoo
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.optim.optimizer import OptConfig, init_opt_state
from repro_torch.train import train_step
from repro_torch.train.train_step import (cross_entropy, loss_fn,
                                          make_train_step, value_and_grad)
from torch_train_parity import GRAD_COS, GRAD_REL, LOSS_ATOL, NOISE

DENSE, KIMI, WHISPER = "h2o-danube-1.8b", "kimi-k2-1t-a32b", "whisper-tiny"


def _cfgs(arch, **parallel):
    jcfg, cfg = jax_registry.get(arch).reduced(), registry.get(arch).reduced()
    if parallel:
        jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel,
                                                         **parallel))
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                       **parallel))
    return jcfg, cfg


def _weights(jcfg, cfg):
    jp = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu", dtype=torch.float32)


def _tokens(cfg, B, T=16, seed=9):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T),
                                                dtype=np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            train_step.to_batch(b, "cpu"))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _close_grads(mine, ref):
    """``tests/torch_train_parity.py``'s rule, leaf by leaf."""
    total = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in leaves(ref))))
    for (path, a), b in zip(flatten_with_path(mine), leaves(ref)):
        a, b = a.double().flatten(), b.double().flatten()
        nb, err = float(b.norm()), float((a - b).norm())
        if nb < NOISE * total:
            assert err <= NOISE * total, path
            continue
        cos = float(a @ b) / max(float(a.norm()) * nb, 1e-30)
        assert err / nb <= GRAD_REL and cos >= GRAD_COS, (path, err / nb,
                                                          cos)


# ------------------------------------------------------- cross entropy
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    ref = jax_train.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    mine = cross_entropy(torch.from_numpy(logits),
                         torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(float(mine), float(ref), rtol=1e-6,
                               atol=1e-6)


def test_cross_entropy_of_bf16_logits_is_f32():
    logits = torch.randn(2, 4, 9, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    a = cross_entropy(logits.bfloat16(), labels)
    b = cross_entropy(logits.bfloat16().float(), labels)
    assert a.dtype == torch.float32 and torch.equal(a, b)


# --------------------------------------------------------- train step
def _capture(monkeypatch, module, store):
    """Record the gradients ``module``'s train step hands the optimizer."""
    orig = module.apply_updates

    def rec(cfg, params, grads, state, step):
        store.append(grads)
        return orig(cfg, params, grads, state, step)

    monkeypatch.setattr(module, "apply_updates", rec)


def test_make_train_step_accum_matches_reference(monkeypatch):
    jcfg, cfg = _cfgs(DENSE)
    jp, params = _weights(jcfg, cfg)
    jb, tb = _tokens(cfg, 8)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jgot, got = [], []
    _capture(monkeypatch, jax_train, jgot)
    _capture(monkeypatch, train_step, got)
    with jax.disable_jit():
        jocfg = jax_opt.OptConfig(**okw)
        # the reference's own default, "bf16", is no name jnp.dtype
        # knows: its accum > 1 step raises unless the type is spelled out
        _, _, jm = jax_train.make_train_step(
            jcfg, jocfg, accum=4, grad_reduce_dtype="bfloat16")(
            jp, jax_opt.init_opt_state(jocfg, jp), jb, jnp.int32(0))
    ocfg = OptConfig(**okw)
    _, _, m = make_train_step(cfg, ocfg, accum=4)(
        params, init_opt_state(ocfg, params), tb, 0)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert abs(float(m["ce"]) - float(jm["ce"])) <= LOSS_ATOL
    assert float(m["aux"]) == 0.0
    (g,), (jg,) = got, jgot
    assert all(x.dtype == torch.bfloat16 for x in leaves(g))
    ref = params_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                            device="cpu", dtype=torch.float32)
    _close_grads(g, ref)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GRAD_REL)


@pytest.mark.parametrize("reduce_dtype,tol", [("f32", 2.0 ** -8),
                                              ("bf16", 2.0 ** -7)])
def test_accumulation_equals_one_batch(monkeypatch, reduce_dtype, tol):
    _, cfg = _cfgs(DENSE)
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    _, tb = _tokens(cfg, 8)
    got = []
    _capture(monkeypatch, train_step, got)
    ocfg = OptConfig(lr=0.0, warmup_steps=1, total_steps=10)
    for accum in (1, 4):
        make_train_step(cfg, ocfg, accum=accum,
                        grad_reduce_dtype=reduce_dtype)(
            params, init_opt_state(ocfg, params), tb, 0)
    one, four = got
    for a, b in zip(leaves(four), leaves(one)):
        assert _rel(a.float(), b) <= tol


# -------------------------------------------------------------- remat
class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", [DENSE, KIMI])
def test_remat_policies_give_the_same_gradients(arch):
    _, base = _cfgs(arch)
    params = model_zoo.init(base, 0, device="cpu", dtype=torch.float32)
    _, tb = _tokens(base, 2)
    grads, mms = {}, {}
    for remat in ("none", "dots", "full"):
        cfg = base.replace(parallel=dataclasses.replace(base.parallel,
                                                        remat=remat))
        with _CountMM() as count:
            _, _, grads[remat] = value_and_grad(params, tb, cfg)
        mms[remat] = count.n
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(grads[remat]), leaves(grads["none"]))), remat
    # "dots" keeps every product; "full" recomputes the groups' forward
    assert mms["dots"] == mms["none"] < mms["full"]


@pytest.mark.parametrize("remat", ["dots_names", "full_names",
                                   "boundaries"])
def test_named_remat_policies_raise(remat):
    """The named policies no longer raise (they came with the mesh): on
    the dense config without a mesh each gives ``remat="none"``'s loss
    and gradients bitwise; ``dots_names`` keeps every product as
    ``dots`` does (no named tensor here), the other two recompute.
    ``tests/test_torch_moe_smap.py`` holds them under a mesh."""
    _, cfg = _cfgs(DENSE, remat=remat)
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    _, tb = _tokens(cfg, 2)
    none = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                    remat="none"))
    got = {}
    for c in (none, cfg):
        with _CountMM() as count:
            loss, _, grads = value_and_grad(params, tb, c)
        got[c.parallel.remat] = (loss, grads, count.n)
    (l0, g0, n0), (l1, g1, n1) = got["none"], got[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert n1 == n0 if remat == "dots_names" else n1 > n0
    with torch.no_grad():                 # no remat without autograd
        logits, _ = model_zoo.forward(cfg, params, tb)
    assert torch.isfinite(logits.float()).all()


# -------------------------------------------------------------- route
def _spy(monkeypatch):
    calls = {"sdpa": 0, "gmm": []}
    sdpa, gmm_cfg = attention._sdpa, gmm_ops._gmm_cfg

    def spy_sdpa(*a, **k):
        calls["sdpa"] += 1
        return sdpa(*a, **k)

    def spy_gmm(x, w, cfg):
        calls["gmm"].append(cfg["impl"])
        return gmm_cfg(x, w, cfg)

    monkeypatch.setattr(attention, "_sdpa", spy_sdpa)
    monkeypatch.setattr(gmm_ops, "_gmm_cfg", spy_gmm)
    return calls


@pytest.mark.parametrize("arch", [KIMI, WHISPER])
def test_route_under_autograd_is_the_references(arch, monkeypatch):
    _, cfg = _cfgs(arch)
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(2)
        b = {"frames": rng.standard_normal((2, 16, cfg.d_model))
             .astype(np.float32),
             "dec_tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))}
        tb = train_step.to_batch(b, "cpu")
        tb["frames"] = tb["frames"].bfloat16()
        # encoder self-attention, decoder self- and cross-attention
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    else:
        _, tb = _tokens(cfg, 2)
        n_attn = cfg.n_layers
    calls = _spy(monkeypatch)
    value_and_grad(params, tb, cfg)
    assert calls["sdpa"] == n_attn
    n_gmm = len(calls["gmm"])
    assert set(calls["gmm"]) <= {"torch_einsum"}
    assert (n_gmm > 0) == (cfg.moe is not None)

    calls["sdpa"], calls["gmm"] = 0, []
    with torch.no_grad():
        loss_fn(params, tb, cfg)
    assert calls["sdpa"] == 0
    assert calls["gmm"] == ["torch_plain"] * n_gmm
    # grad mode on, but nothing requires grad: the device's default too
    loss_fn(params, tb, cfg)
    assert calls["sdpa"] == 0
    assert calls["gmm"] == ["torch_plain"] * 2 * n_gmm
