"""The reference's parameter tree (as numpy arrays) -> the port's.

The reference stacks its layer groups (and an encoder-decoder's
encoder and decoder layers) on a leading axis for its ``lax.scan``; the
port keeps a list of per-group (per-layer) trees.  Everything else maps
one to one.  Norm parameters and the tensors the reference casts to f32
at use (mamba's ``A_log``, sLSTM's ``r``, xLSTM's ``gn_scale``) stay
f32; every other tensor is stored in ``dtype`` (the model casts it to
the activations' type at use, so bf16 storage equals the reference's
f32 weights cast at use).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path
from repro_torch.kernels.common import resolve_device
from repro_torch.models.blocks import group_layout

_F32_KEYS = ("norm1", "norm2", "norm3", "final_norm", "enc_norm",
             "dec_norm", "q_norm", "k_norm", "kv_norm", "A_log", "r",
             "gn_scale")


def _convert(tree, dev, dtype, keep_f32: bool = False):
    if isinstance(tree, dict):
        return {k: _convert(v, dev, dtype, keep_f32 or k in _F32_KEYS)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev, dtype, keep_f32) for v in tree]
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    return t.to(device=dev, dtype=torch.float32 if keep_f32 else dtype)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _unstack(tree, cfg):
    """The reference's stacked layer axis -> a list of per-layer trees."""
    out = dict(tree)
    if cfg.is_encoder_decoder:
        for key, n in (("enc_layers", cfg.n_enc_layers),
                       ("dec_layers", cfg.n_layers)):
            out[key] = [_index(tree[key], i) for i in range(n)]
    else:
        _, _, n_groups = group_layout(cfg)
        stack = dict(tree["stack"])
        stack["groups"] = [_index(stack["groups"], i)
                           for i in range(n_groups)]
        out["stack"] = stack
    return out


def params_from_numpy(tree, cfg, *, device=None, dtype=torch.float32):
    """``tree``: the reference's ``param.values(model_zoo.init(cfg, key))``
    with every leaf converted to numpy.  Returns the port's tree on
    ``device`` (default: the first GPU)."""
    return _convert(_unstack(tree, cfg), resolve_device(device), dtype)


def _as_tensor(arr, dev):
    """A numpy leaf in its own type (a bf16 leaf, numpy's
    ``bfloat16`` extension type, exactly)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def opt_state_from_numpy(state, cfg, *, device=None):
    """``state``: the reference's ``init_opt_state`` / ``apply_updates``
    state (``m``, ``v``, ``count``; or ``m``, ``vr``, ``vc``, ``count``)
    with every leaf converted to numpy.  Returns the port's
    (``optim.optimizer``'s) state on ``device``, each leaf in its own
    type (``m`` in ``m_dtype``).

    AdamW's moments are elementwise and cross over exactly.  Adafactor's
    factored moments cross over where the reference's stacked leaf
    factors as the port's per-layer leaf does (a matrix); the reference
    factors a stacked vector (a norm scale, ``(layers, d)``) over its
    layer axis, where the port's ``(d,)`` leaf is not factored: such a
    state raises."""
    dev = resolve_device(device)
    out = {}
    for key, tree in state.items():
        if key == "count":
            out[key] = torch.tensor(int(np.asarray(tree)),
                                    dtype=torch.int32, device=dev)
            continue
        out[key] = _map(_unstack(tree, cfg), lambda a: _as_tensor(a, dev))
    if "vc" in state:
        _check_factored(out, cfg)
    return out


def _check_factored(state, cfg):
    for (path, m), (_, vc) in zip(flatten_with_path(state["m"]),
                                  flatten_with_path(state["vc"])):
        matrix = m.dim() >= 2 and m.shape[-1] > 1 and m.shape[-2] > 1
        want = (tuple(m.shape[:-2]) + tuple(m.shape[-1:]) if matrix
                else (1,) * m.dim())
        if tuple(vc.shape) != want:
            raise ValueError(
                f"{cfg.name}: Adafactor state at {'/'.join(map(str, path))} "
                f"is factored over the reference's stacked layer axis "
                f"(vc {tuple(vc.shape)}, the port's per-layer leaf wants "
                f"{want})")
