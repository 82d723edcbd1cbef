"""Logical-axis -> mesh-axis sharding rules (DP/TP/EP/SP + pod).

Models annotate parameters and activations with *logical* axis names;
this module resolves them against the active
``torch.distributed.DeviceMesh`` to a ``PartitionSpec`` (names) and to
DTensor placements (``Shard(i)`` / ``Replicate()`` per mesh dim).
Outside a mesh context every call is a no-op, so the same model code
runs on one device without a process group.

Under a mesh a plain tensor is this rank's value: ``shard_act`` passes
it through unchanged, so a one-device mesh changes no result.  A
``DTensor`` is redistributed to the spec's placements.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Rules: logical axis -> mesh axis (or tuple of mesh axes)
# ---------------------------------------------------------------------------
# "batch" spans the pure-data axes; "model" carries TP/EP/vocab; "fsdp"
# additionally spreads giant parameters over the data axes (ZeRO-3 style).
def default_rules(mesh_axes: Sequence[str], fsdp: bool = False) -> Dict:
    data_axes = tuple(a for a in mesh_axes if a in ("pod", "data"))
    rules = {
        "batch": data_axes,
        "embed": data_axes if fsdp else None,
        "vocab": "model",
        "mlp": "model",
        "q_hidden": "model",
        "kv_hidden": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "kv_lora": None,
        "q_lora": None,
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "seq": None,
        "seq_kv": None,          # flipped to "model" under seq_shard_kv
        None: None,
    }
    return rules


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names.  A one-name tuple is stored as the name, so
    ``PartitionSpec(("data",))`` equals ``PartitionSpec("data")``, as in
    the reference; trailing ``None``s are kept as given (``spec_for``
    trims them)."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = e[0] if len(e) == 1 else tuple(e)
            out.append(e)
        return super().__new__(cls, out)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return {a: mesh.size(i) for i, a in enumerate(mesh_axis_names(mesh))}


class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict] = None, fsdp: bool = False,
             overrides: Optional[Dict] = None):
    """Activate (mesh, rules) for shard_act / make_sharding calls on the
    calling thread."""
    r = dict(rules or default_rules(mesh_axis_names(mesh), fsdp=fsdp))
    if overrides:
        r.update(overrides)
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, r
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh():
    return _CTX.mesh


def _axis_size(sizes: Dict[str, int], mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    return math.prod(sizes[a] for a in mesh_axes)


def spec_for(logical_axes: Sequence, shape: Optional[Tuple[int, ...]] = None,
             mesh=None, rules: Optional[Dict] = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec.

    If ``shape`` is given, any mapping whose mesh-axis size does not
    divide the dim is dropped (replicated) — this is how e.g. 8 KV heads
    on a 16-way model axis degrade gracefully.  A mesh axis may appear
    only once in a spec: a later logical axis that maps to a used mesh
    axis is dropped.
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or {}
    sizes = mesh_shape(mesh) if mesh is not None else None
    used = set()
    out = []
    for i, ax in enumerate(logical_axes):
        m = rules.get(ax, None)
        if m is None:
            out.append(None)
            continue
        key = tuple(m) if isinstance(m, (tuple, list)) else (m,)
        if any(k in used for k in key):
            m = None  # a mesh axis may appear only once in a spec
        elif shape is not None and sizes is not None:
            if shape[i] % _axis_size(sizes, m) != 0:
                m = None
        if m is not None:
            used.update(key)
            out.append(tuple(m) if isinstance(m, (tuple, list)) else m)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements(spec: PartitionSpec, mesh) -> Tuple:
    """DTensor placements of ``spec`` over ``mesh``: per mesh dim,
    ``Shard(i)`` if tensor dim ``i``'s entry names that mesh axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for a in names:
            where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axis_names(mesh))


@dataclass(frozen=True)
class NamedSharding:
    """A (mesh, spec) pair and its DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)


def shard_act(x, logical_axes: Sequence):
    """Constrain an activation to the active rules: no-op without a mesh
    (``x`` itself) and for a plain tensor (this rank's value); a DTensor
    is redistributed to the spec's placements."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(logical_axes, shape=tuple(x.shape))
    return x.redistribute(mesh, placements(spec, mesh))


def make_sharding(logical_axes: Sequence, shape: Optional[Tuple[int, ...]] = None,
                  mesh=None) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    return NamedSharding(mesh, spec_for(logical_axes, shape=shape, mesh=mesh))


def is_axes(x) -> bool:
    """A leaf axes-tuple: tuple of str/None (not a tuple of tuples)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over an axes tree (dicts, lists and tuples
    with ``is_axes`` leaves) and the matching leaves of ``rest`` (trees
    of the same structure)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"map_axes: {type(axes_tree).__name__} is no axes "
                    f"tree node")


def param_shardings(axes_tree, shapes_tree, mesh,
                    rules: Optional[Dict] = None):
    """NamedSharding tree for a parameter tree.

    axes_tree: tree of logical-axes tuples (``model_zoo.param_specs``).
    shapes_tree: matching tree of tensors (or shapes).
    """
    rules = rules or _CTX.rules or default_rules(mesh_axis_names(mesh))

    def one(axes, shaped):
        shape = tuple(getattr(shaped, "shape", shaped))
        return NamedSharding(mesh, spec_for(axes, shape=shape, mesh=mesh,
                                            rules=rules))

    return map_axes(one, axes_tree, shapes_tree)
