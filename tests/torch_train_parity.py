"""Shared check of ``tests/test_torch_train_*.py``: one arch's
``reduced()`` training loss and gradients through the port against the
reference's ``jax.value_and_grad``, on the CPU.

The reference's ``test_arch_smoke_forward_and_train_step`` (a finite
forward, loss and gradient, one optimizer update that moves the
parameters), then parity on the same f32 weights (the port's ``init``,
handed to the reference as its stacked tree, ``reference_tree``) and
batch (numpy, seed 9; the stub inputs rounded to bf16 in both).  The reference runs op by op
(``jax.disable_jit()``): its compiled and op-by-op bf16 forwards
disagree.  Under autograd both take their differentiable formulations
(the grouped-einsum attention, the einsum grouped matmul).

Every MoE layer of the port takes the reference's top-k experts, call
by call; the port's own choices may differ only at a near-tie of the
reference's router (the 2nd and 3rd probabilities within
``ROUTER_TIE``), where a bf16 rounding flips the route.

Tolerances (measured at these configs with the experts pinned: the
loss within 1.8e-3, every leaf held relatively within 0.028 with a
cosine above 0.9996, the small leaves within 2.6e-5 of the whole
gradient's norm):

* the loss within ``LOSS_ATOL``;
* each gradient leaf whose reference norm is at least ``NOISE`` of the
  whole gradient's: a relative L2 error within ``GRAD_REL`` and a cosine
  of at least ``GRAD_COS``;
* a smaller leaf within ``NOISE`` of the whole gradient's norm,
  absolutely: its gradient is rounding noise on a value that is 0 or
  nearly (attention's key biases, whose shift every softmax ignores;
  the mLSTM's input-gate bias, which its normaliser cancels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.train import train_step as jax_train
from repro_torch.configs import registry
from repro_torch.core.tree import flatten_with_path, leaves
from repro_torch.models import model_zoo, moe
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.optim.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.train_step import value_and_grad

B, T = 2, 16
LOSS_ATOL = 0.01
GRAD_REL, GRAD_COS, NOISE = 0.1, 0.99, 1e-4
ROUTER_TIE = 0.01


def batch_np(cfg):
    rng = np.random.default_rng(9)
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((B, T, cfg.d_model))
                .astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (B, T),
                                           dtype=np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (B, T),
                                       dtype=np.int32)}
    if cfg.frontend != "none":
        return {"embeds": rng.standard_normal((B, T, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, T),
                                       dtype=np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def reference_tree(tree, cfg):
    """The port's parameter tree as the reference's: numpy leaves, the
    per-layer lists (the stack's groups; an encoder-decoder's encoder
    and decoder layers) stacked on a leading axis, the inverse of
    ``params_from_numpy``.  The weights are the port's ``init``'s: the
    reference's own ``init`` compiles for seconds."""
    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_np(v) for v in t]
        return t.detach().float().numpy()

    def stacked(trees):
        return jax.tree.map(lambda *xs: np.stack(xs), *trees)

    out = to_np(tree)
    if cfg.is_encoder_decoder:
        for key in ("enc_layers", "dec_layers"):
            out[key] = stacked(out[key])
    else:
        out["stack"]["groups"] = stacked(out["stack"]["groups"])
    return out


def _concrete(x):
    """The value under the reference's (eager) autodiff tracers."""
    while isinstance(x, jax.core.Tracer):
        x = x.primal if hasattr(x, "primal") else x.val
    return np.asarray(x)


def pin_routing(monkeypatch):
    """The port's MoE layers take the reference's top-k experts, call by
    call; returns the record of both sides' own choices and the
    reference's probabilities."""
    seen = {"ref": [], "port": [], "probs": []}
    jax_top_k, port_top_k = jax.lax.top_k, moe._top_k

    def jax_rec(probs, k):
        vals, idx = jax_top_k(probs, k)
        seen["ref"].append(_concrete(idx))
        seen["probs"].append(_concrete(probs).astype(np.float32))
        return vals, idx

    def port_rec(probs, k):
        _, own = port_top_k(probs, k)
        seen["port"].append(own.numpy())
        idx = torch.tensor(seen["ref"][len(seen["port"]) - 1],
                           dtype=torch.int64)
        return torch.gather(probs, -1, idx), idx

    monkeypatch.setattr(jax.lax, "top_k", jax_rec)
    monkeypatch.setattr(moe, "_top_k", port_rec)
    return seen


def check_choices(seen, k):
    assert len(seen["ref"]) == len(seen["port"])
    for i, (r, p, probs) in enumerate(zip(seen["ref"], seen["port"],
                                          seen["probs"])):
        for at in np.argwhere((np.sort(r, -1) != np.sort(p, -1)).any(-1)):
            srt = np.sort(probs[tuple(at)])[::-1]
            assert srt[k - 1] - srt[k] < ROUTER_TIE, (i, at, srt[:k + 1])


def _inputs(b):
    jb, tb = {}, {}
    for k, v in b.items():
        if v.dtype == np.float32:
            jb[k] = jnp.asarray(v, jnp.bfloat16)
            tb[k] = torch.from_numpy(v).bfloat16()
        else:
            jb[k] = jnp.asarray(v)
            tb[k] = torch.from_numpy(v).long()
    return jb, tb


def check_arch(arch, monkeypatch):
    """The smoke train step and the parity above for ``arch``."""
    jcfg = jax_registry.get(arch).reduced()
    cfg = registry.get(arch).reduced()
    params = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, reference_tree(params, cfg))
    jb, tb = _inputs(batch_np(cfg))

    # the reference's smoke test, on the port: a finite forward
    with torch.no_grad():
        logits, aux = model_zoo.forward(cfg, params, tb)
    assert logits.shape == (B, T, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)

    # the loss and the gradients against the reference's
    seen = pin_routing(monkeypatch)
    with jax.disable_jit():
        (jloss, _), jgrads = jax.value_and_grad(
            jax_train.loss_fn, has_aux=True)(jp, jb, jcfg)
    loss, _, grads = value_and_grad(params, tb, cfg)
    if cfg.moe is not None:
        check_choices(seen, cfg.moe.top_k)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL, (
        float(loss), float(jloss))
    ref = params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                            device="cpu", dtype=torch.float32)
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

    # ... and one update that moves the parameters
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in leaves(grads))
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    before = [p.clone() for p in leaves(params)]
    _, _, m = apply_updates(ocfg, params, grads,
                            init_opt_state(ocfg, params), 0)
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(before, leaves(params)))
    assert torch.isfinite(m["grad_norm"])
