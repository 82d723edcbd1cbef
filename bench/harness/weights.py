"""The benchmark's weights: drawn from the seed on the device, in the
type they are served in, and handed to both sides.

Every matrix of the program's parameter tree is a view into one flat
bfloat16 buffer filled by a ``torch.Generator`` on the device in a few
large calls, then scaled in place: a matrix by 1/sqrt(its input width),
the embedding table by 0.02; every norm scale is a view into one flat
float32 buffer, 1 + 0.1 N(0, 1), so that a reference that forgot a
scale would not agree.  The program gets the tree it would build itself
(the layout of ``model_zoo.param_specs``); the reference gets the same
tensors under the published model's names (``reference.model``).  A
leaf of the tree that this mapping does not place is an error: the
benchmark never hands the program a weight the reference does not read.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

_CHUNK = 1 << 30                 # elements drawn per generator call


def _leaves(tree, path=()) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values[path]


def _fill(n: int, dtype, gen: torch.Generator, device) -> torch.Tensor:
    flat = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    return flat


def _std(path: tuple, shape) -> float:
    if path[-1] == "table":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make(cfg, seed: int, device) -> Tuple[dict, dict]:
    """(the program's parameter tree, the reference's weights) from
    ``seed`` on ``device``; both hold the same tensors."""
    from repro_torch.models import model_zoo

    specs, _ = model_zoo.param_specs(cfg)
    leaves = _leaves(specs)
    gen = torch.Generator(device=device).manual_seed(
        int(seed) & (2 ** 64 - 1))
    values = {}
    for dtype, is_norm in ((torch.bfloat16, False), (torch.float32, True)):
        group = [(p, t) for p, t in leaves if (t.dtype == torch.float32)
                 == is_norm]
        n = sum(t.numel() for _, t in group)
        flat = _fill(n, dtype, gen, device)
        if is_norm:
            flat.mul_(0.1).add_(1.0)
        lo = 0
        for path, t in group:
            v = flat[lo:lo + t.numel()].view(t.shape)
            lo += t.numel()
            if not is_norm:
                v.mul_(_std(path, t.shape))
            values[path] = v
    params = _rebuild(specs, values)
    ref = reference_view(params)
    placed = {id(t) for t in _ref_tensors(ref)}
    missing = [p for p, t in _leaves(params) if id(t) not in placed]
    if missing:
        raise KeyError(f"{cfg.name}: the program's parameters hold leaves "
                       f"the reference does not read: {missing[:5]}")
    return params, ref


def _ref_tensors(tree):
    return [t for _, t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _layer(p: dict) -> dict:
    mix, out = p["mix"], {"attn_norm": p["norm1"]["scale"]}
    if "wq" in mix:
        out["wq"] = mix["wq"]["w"]
    else:
        out.update(wq_a=mix["wq_a"]["w"], q_norm=mix["q_norm"],
                   wq_b=mix["wq_b"]["w"])
    out.update(wkv_a=mix["wkv_a"]["w"], kv_norm=mix["kv_norm"],
               wkv_b=mix["wkv_b"]["w"], wo=mix["wo"]["w"],
               ffn_norm=p["norm2"]["scale"])
    ffn = p["ffn"]
    if "router" in ffn:
        moe = {"router": ffn["router"]["w"], "w_up": ffn["w_up"],
               "w_gate": ffn["w_gate"], "w_down": ffn["w_down"]}
        if "shared" in ffn:
            sh = ffn["shared"]
            moe.update(s_up=sh["up"]["w"], s_gate=sh["gate"]["w"],
                       s_down=sh["down"]["w"])
        out["moe"] = moe
    else:
        out["mlp"] = {k: ffn[k]["w"] for k in ("up", "gate", "down")}
    return out


def reference_view(params: dict) -> dict:
    """The reference's names for the program's tree: the dense prefix's
    layers, then each group's (one layer a group in these models)."""
    stack = params["stack"]
    layers = [_layer(p) for p in stack.get("prefix", [])]
    for g in stack["groups"]:
        layers += [_layer(g[k]) for k in sorted(g, key=lambda s: int(s[1:]))]
    return {"embed": params["embed"]["table"],
            "unembed": params.get("unembed", {}).get("w"),
            "final_norm": params["final_norm"]["scale"],
            "layers": layers}
