"""The port's optimizer (``repro_torch.optim.optimizer``) against the
reference's, on the CPU.

The reference's ``tests/test_optimizer.py`` ported, then parity: the
same numpy parameter and gradient trees (matrix and vector leaves, a
list of layers, as the port's trees hold them) through both packages'
``apply_updates`` for three steps.  The reference runs op by op
(``jax.disable_jit()``): compiled, XLA contracts ``a * b + c`` into a
fused multiply-add, which rounds once where the port rounds twice.

Tolerances: 1e-6 relative on ``grad_norm`` and ``lr``, and on every
element of the new parameters and moments relative to its leaf's
largest: the reductions (the norm's sums of squares, Adafactor's means)
sum in another order, so the clip scale can differ by an ulp or two,
and an element that ``p - lr * step`` cancels to near 0 keeps the
ulp of ``p``, not its own.  A bf16 first moment equal bit for bit
where the reference's is.  The schedule at steps 0-120 at 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jopt
from repro_torch.core.tree import leaves
from repro_torch.optim.optimizer import (OptConfig, apply_updates,
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, schedule)

RTOL = 1e-6


# ------------------------------------------- the reference's unit tests
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(kind):
    cfg = OptConfig(kind=kind, lr=0.1, warmup_steps=1, total_steps=200,
                    weight_decay=0.0)
    params = {"w": torch.tensor([[3.0, -2.0], [1.5, 4.0]])}
    state = init_opt_state(cfg, params)
    for step in range(100):
        g = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(cfg, params, g, state, step)
    assert float(torch.sum(params["w"] ** 2)) < 0.1


def test_clip_by_global_norm():
    g = {"a": torch.ones((10,)) * 10}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000), rel=1e-5)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_schedule_warmup_and_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert float(schedule(cfg, 0)) == pytest.approx(0.1)
    assert float(schedule(cfg, 9)) == pytest.approx(1.0)
    assert float(schedule(cfg, 99)) == pytest.approx(0.1, abs=0.02)


def test_adafactor_memory_factored():
    cfg = OptConfig(kind="adafactor")
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((64,))}
    st = init_opt_state(cfg, params)
    assert st["vr"]["w"].shape == (64,)
    assert st["vc"]["w"].shape == (32,)
    assert st["vr"]["b"].shape == (64,)


# ------------------------------------------------------------- parity
def _trees(seed):
    """numpy params and three steps of gradients: matrices, a (1, n)
    and an (n, 1) leaf (not factored), vectors, a list of layers."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        def a(*shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"w": a(24, 16), "b": a(16),
                "layers": [{"k": a(8, 12), "s": a(12)},
                           {"k": a(8, 12), "s": a(12)}],
                "row": a(1, 9), "col": a(9, 1), "t3": a(2, 5, 6)}

    return tree(0.5), [tree(s) for s in (0.3, 1e-3, 4.0)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(mine, ref, what):
    ref = _np(ref)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(_np(mine), ref, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(kind, m_dtype):
    params_np, grads_np = _trees(7)
    kw = dict(kind=kind, lr=0.05, warmup_steps=2, total_steps=20,
              m_dtype=m_dtype, clip_norm=1.0)
    jcfg, cfg = jopt.OptConfig(**kw), OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params_np)
    p = _to_torch(params_np)
    with jax.disable_jit():
        js = jopt.init_opt_state(jcfg, jp)
    s = init_opt_state(cfg, p)
    for step, g_np in enumerate(grads_np):
        with jax.disable_jit():
            jp, js, jm = jopt.apply_updates(
                jcfg, jp, jax.tree.map(jnp.asarray, g_np), js,
                jnp.int32(step))
        p, s, m = apply_updates(cfg, p, _to_torch(g_np), s, step)
        _close(m["grad_norm"], jm["grad_norm"], f"grad_norm step {step}")
        _close(m["lr"], jm["lr"], f"lr step {step}")
        for a, b in zip(leaves(p), jax.tree.leaves(jp)):
            _close(a, b, f"params step {step}")
        for key in js:
            if key == "count":
                assert int(s["count"]) == int(js["count"]) == step + 1
                continue
            for a, b in zip(leaves(s[key]), jax.tree.leaves(js[key])):
                _close(a, b, f"{key} step {step}")
        if m_dtype == "bfloat16":
            # the moments' f32 values agree to RTOL; rounded to bf16
            # they must be the same bits (an f32 value within RTOL of
            # a bf16 rounding boundary would flip: none does here)
            for a, b in zip(leaves(s["m"]), jax.tree.leaves(js["m"])):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy(),
                    np.asarray(b).view(np.int16))


def test_schedule_matches_reference():
    for kw in (dict(lr=3e-4, warmup_steps=5, total_steps=50),
               dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1),
               dict(lr=3e-3, warmup_steps=2, total_steps=100)):
        cfg, jcfg = OptConfig(**kw), jopt.OptConfig(**kw)
        mine = np.array([float(schedule(cfg, s)) for s in range(121)],
                        np.float32)
        with jax.disable_jit():
            ref = np.array([np.asarray(jopt.schedule(jcfg, s))
                            for s in range(121)], np.float32)
        np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=0)


def test_global_norm_sums_in_the_references_leaf_order():
    """Dict keys sorted, as the reference's pytrees flatten them."""
    _, grads = _trees(3)
    g = grads[0]
    with jax.disable_jit():
        ref = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    _close(global_norm(_to_torch(g)), ref, "global_norm")
    shuffled = {k: g[k] for k in reversed(list(g))}
    assert float(global_norm(_to_torch(shuffled))) == float(
        global_norm(_to_torch(g)))
