"""Training at ``tp=`` against the JAX reference, on the CPU.

h2o-danube-1.8b ``reduced()`` at tp = 4 (4 query and 2 KV heads:
kv_repeat 2): the loss and the gradients of
``train_step.value_and_grad(tp=4)`` against the reference's
``jax.value_and_grad(loss_fn, tp=4)`` run op by op, at the tolerances of
``tests/torch_train_parity.py`` (the port's tp = 1 training tests');
then ``make_train_step(tp=4)``'s step is that loss and those gradients
through the optimizer, bitwise; and tp = 4's loss is tp = 1's within f32
2e-5, its gradients within the same parity tolerances (the repeat moves
them by bf16 roundings of the activations' gradients only).  Under autograd the attention takes the
grouped einsum, whose groups the repeat shrinks from 2 query heads a
K/V head to 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.train import train_step as jax_train
from repro_torch.configs import registry
from repro_torch.core.tree import flatten_with_path, leaves, tree_map
from repro_torch.models import attention, model_zoo
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.optim.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train import train_step
from torch_train_parity import (GRAD_COS, GRAD_REL, LOSS_ATOL, NOISE,
                                _inputs, batch_np, reference_tree)

H2O, TP = "h2o-danube-1.8b", 4


def _hold_gradients(grads, ref):
    """Each leaf of ``grads`` against ``ref``'s: a leaf whose norm is at
    least ``NOISE`` of the whole gradient's within ``GRAD_REL`` relative
    L2 error and a cosine of ``GRAD_COS``; a smaller one within
    ``NOISE`` of the whole norm, absolutely (torch_train_parity's
    rule)."""
    total = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in leaves(ref))))
    for (path, a), b in zip(flatten_with_path(grads), leaves(ref)):
        a, b = a.double().flatten(), b.double().flatten()
        nb, err = float(b.norm()), float((a - b).norm())
        name = "/".join(map(str, path))
        if nb < NOISE * total:
            assert err <= NOISE * total, (name, err, total)
            continue
        cos = float(a @ b) / max(float(a.norm()) * nb, 1e-30)
        assert err / nb <= GRAD_REL and cos >= GRAD_COS, (name, err / nb,
                                                          cos)


def test_train_step_at_tp4_matches_reference():
    """h2o-danube ``reduced()`` at tp = 4 (kv_repeat 2): the loss and
    every gradient leaf against the reference's ``jax.value_and_grad``
    (op by op), then ``make_train_step(tp=4)``'s step: its loss that
    loss and its update ``apply_updates`` of those gradients."""
    jcfg = jax_registry.get(H2O).reduced()
    cfg = registry.get(H2O).reduced()
    assert attention.kv_repeat_for(cfg, TP) == 2
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, reference_tree(params, cfg))
    jb, tb = _inputs(batch_np(cfg))
    with jax.disable_jit():
        (jloss, _), jgrads = jax.value_and_grad(
            jax_train.loss_fn, has_aux=True)(jp, jb, jcfg, tp=TP)
    loss, _, grads = train_step.value_and_grad(params, tb, cfg, tp=TP)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL, (
        float(loss), float(jloss))
    ref = params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                            device="cpu", dtype=torch.float32)
    _hold_gradients(grads, ref)

    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    expect = tree_map(torch.clone, params)
    apply_updates(ocfg, expect, grads, init_opt_state(ocfg, expect), 0)
    step = train_step.make_train_step(cfg, ocfg, tp=TP)
    _, _, m = step(params, init_opt_state(ocfg, params), tb, 0)
    assert torch.equal(m["loss"], loss)
    for a, b in zip(leaves(params), leaves(expect)):
        assert torch.equal(a, b)


def test_tp4_loss_and_gradients_are_tp1s():
    """In the port the repeat moves the training values only by bf16
    roundings of the activations' gradients: tp = 4's loss is tp = 1's
    within f32 2e-5, its gradients within the parity tolerances above."""
    cfg = registry.get(H2O).reduced()
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    _, tb = _inputs(batch_np(cfg))
    loss1, _, g1 = train_step.value_and_grad(params, tb, cfg)
    loss4, _, g4 = train_step.value_and_grad(params, tb, cfg, tp=TP)
    torch.testing.assert_close(loss4, loss1, atol=2e-5, rtol=2e-5)
    _hold_gradients(g4, g1)
