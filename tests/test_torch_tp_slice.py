"""The kimi-k2 slice at ``tp=4`` against the JAX reference, on the CPU.

kimi-k2 ``reduced()`` (4 query and 2 KV heads) at tp = 4 repeats each
K/V head twice (kv_repeat 2) in both packages.  In bf16: ``prefill``
(the logits and the repeated caches; ``forward``'s logits are its own,
bitwise) and 4 teacher-forced decode steps against the reference's at
the same tp, at the reference's bf16 model tolerance (atol 0.25, rtol
0.1) with every MoE layer on the same experts; ``generate(tp=4)``'s
greedy tokens equal the reference's but where its top-1/top-2 gap is
under 0.25, as in ``test_torch_models.py``.  The reference runs op by
op with its attention pinned to its unblocked oracle, around its own
calls only (``torch_ref_pin.ref_op_by_op``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.models import model_zoo as jax_zoo
from repro.serve import serve_step as jax_serve
from repro_torch.configs import registry
from repro_torch.models import attention, model_zoo
from repro_torch.serve import serve_step
from test_torch_models import _assert_same_choices, _np, _record_top_k, _t
from torch_ref_pin import ref_op_by_op
from torch_train_parity import reference_tree

KIMI = "kimi-k2-1t-a32b"
BF16_ATOL, BF16_RTOL = 0.25, 0.1
TP = 4


def _kimi_pair():
    """kimi-k2 ``reduced()``: the port's bf16 weights (its ``init``) and
    the reference's stacked tree of the same values
    (``torch_train_parity.reference_tree``; the reference's own ``init``
    compiles for seconds)."""
    jcfg = jax_registry.get(KIMI).reduced()
    cfg = registry.get(KIMI).reduced()
    tree = model_zoo.init(cfg, 0, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, reference_tree(tree, cfg)), \
        cfg, tree



def test_kimi_forward_prefill_decode_at_tp4_match_reference(monkeypatch):
    jcfg, jtree, cfg, tree = _kimi_pair()
    assert attention.kv_repeat_for(cfg, TP) == 2
    seen = _record_top_k(monkeypatch)
    B, P, N = 2, 8, 4
    toks = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B, P + N)).astype(np.int32)
    with ref_op_by_op():
        jlog, jc = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(
            toks[:, :P])}, cache_len=P + N, tp=TP)
        jpre = jax.tree.map(np.asarray, jc)
        jsteps = []
        for t in range(P, P + N):
            lg, jc = jax_zoo.decode_step(jcfg, jtree,
                                         jnp.asarray(toks[:, t:t + 1]), jc,
                                         jnp.int32(t), tp=TP)
            jsteps.append(lg)
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, tree, {"tokens": _t(toks[:, :P])},
                                    tp=TP)
        log, c = model_zoo.prefill(cfg, tree, {"tokens": _t(toks[:, :P])},
                                   cache_len=P + N, tp=TP)
        assert torch.equal(full, log)
        pre = {"prefix": [{k: v.clone() for k, v in c["prefix"][0].items()}],
               "groups": [{k: v.clone() for k, v in c["groups"][0]["l0"]
                           .items()}]}
        steps = []
        for t in range(P, P + N):
            lg, c = model_zoo.decode_step(cfg, tree, _t(toks[:, t:t + 1]),
                                          c, t, tp=TP)
            steps.append(lg)
    # forward's logits are prefill's, bitwise (above): one against the
    # reference's prefill holds both
    np.testing.assert_allclose(_np(log), _np(jlog), atol=BF16_ATOL,
                               rtol=BF16_RTOL, err_msg="prefill")
    heads = 2 * cfg.n_kv_heads
    for key in ("k", "v"):
        port_k = pre["prefix"][0][key]
        assert port_k.shape == (B, P + N, heads, cfg.head_dim)
        np.testing.assert_allclose(_np(port_k), jpre["prefix"][0][key]
                                   .astype(np.float32), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=key)
        np.testing.assert_allclose(_np(pre["groups"][0][key]),
                                   jpre["groups"]["l0"][key][0]
                                   .astype(np.float32), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=key)
        # head h of the repeat is head h // 2 of the weights'
        assert torch.equal(port_k[:, :, 0::2], port_k[:, :, 1::2])
    for t, (lg, jlg) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=BF16_ATOL,
                                   rtol=BF16_RTOL, err_msg=f"step {t}")
    assert len(seen["ref"]) == (cfg.n_layers - 1) * (1 + N)
    seen["port"] = seen["port"][cfg.n_layers - 1:]     # forward's own
    _assert_same_choices(seen)


def test_generate_at_tp4_matches_reference():
    """Greedy tokens at tp = 4 equal the reference's ``generate(tp=4)``;
    a token may differ only where the reference's top-1/top-2 gap
    (teacher-forced along its own tokens) is under 0.25, and the row is
    compared no further."""
    jcfg, jtree, cfg, tree = _kimi_pair()
    B, P, N = 2, 8, 4
    prompt = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    with ref_op_by_op():
        ref = np.asarray(jax_serve.generate(jcfg, jtree, jnp.asarray(prompt),
                                            N, tp=TP))
    out = serve_step.generate(cfg, tree, _t(prompt), N, tp=TP).numpy()
    assert out.shape == (B, N + 1)
    if np.array_equal(out, ref):
        return
    with ref_op_by_op():
        lg, c = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(prompt)},
                                cache_len=P + N, tp=TP)
        logits = [np.asarray(lg[:, -1], np.float32)]
        for t in range(N):
            lg, c = jax_zoo.decode_step(jcfg, jtree,
                                        jnp.asarray(ref[:, t:t + 1]), c,
                                        jnp.int32(P + t), tp=TP)
            logits.append(np.asarray(lg[:, 0], np.float32))
    top2 = np.sort(np.stack(logits, axis=1), axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    for b in range(B):
        diff = np.flatnonzero(out[b] != ref[b])
        if len(diff):
            assert gaps[b, diff[0]] < BF16_ATOL, (b, diff[0], gaps[b])
