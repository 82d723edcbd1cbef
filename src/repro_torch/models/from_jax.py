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


def params_from_numpy(tree, cfg, *, device=None, dtype=torch.float32):
    """``tree``: the reference's ``param.values(model_zoo.init(cfg, key))``
    with every leaf converted to numpy.  Returns the port's tree on
    ``device`` (default: the first GPU)."""
    dev = resolve_device(device)
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
    return _convert(out, dev, dtype)
