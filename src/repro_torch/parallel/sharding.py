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

``split_heads`` / ``merge_heads``, ``row_local``, ``local_blocks``,
``grouped_blocks`` and ``vocab_parallel_embed`` / ``_lse`` state for
DTensors (the dry-run's) the layouts GSPMD picks itself: a view into
heads that a hidden dim's split does not divide, the regions each rank
computes on its own rows, heads and experts, and the vocabulary's split.
Each is the plain computation for a plain tensor, and without a mesh
returns before any DTensor check.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


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


def is_dtensor(x) -> bool:
    """A DTensor under an active mesh (the dry-run's); False without a
    mesh, where no DTensor is traced."""
    if _CTX.mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_dim(p, ndim: int):
    """The tensor dim a DTensor placement shards (negative dims counted
    from the end), or None for a placement that shards none."""
    if not p.is_shard():
        return None
    return p.dim % ndim


def split_heads(x, n_heads: int, head_dim: int):
    """``x`` (..., n_heads * head_dim) viewed as (..., n_heads, head_dim).

    A DTensor whose last dim is sharded over mesh axes whose size does
    not divide ``n_heads`` (640 = 8 heads x 80 split 16 ways) is first
    replicated on those axes, the all-gather GSPMD inserts before such
    a view; DTensor cannot view it unevenly.  A plain tensor is viewed
    as it is."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.dim() - 1
        pl = list(x.placements)
        split = [i for i, p in enumerate(pl)
                 if shard_dim(p, x.dim()) == last]
        if n_heads % math.prod(x.device_mesh.size(i) for i in split):
            for i in split:
                pl[i] = Replicate()
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def merge_heads(x):
    """(..., n_heads, head_dim) ``x`` viewed as (..., n_heads * head_dim).
    A DTensor is viewed on its local block, its layout kept (heads split
    over a mesh axis become the hidden dim's blocks): the backward's
    view into heads then runs on local blocks too, where DTensor cannot
    split a hidden dim whose split does not divide the heads.  A plain
    tensor is viewed as it is."""
    if _CTX.mesh is None:
        return x.reshape(*x.shape[:-2], -1)
    return local_blocks(lambda t: t.reshape(*t.shape[:-2], -1), (x,),
                        ((0, x.dim() - 2),), (0, x.dim() - 2))


def row_local(fn, x):
    """``fn(x)`` for an ``fn`` that maps each row (the last dim) on its
    own and keeps the other dims, as a norm's mean does.  A DTensor runs
    ``fn`` on its local block, its last dim first gathered (or summed)
    where it is split (or partial); a plain tensor is ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    last = x.dim() - 1
    pl = [Replicate() if p.is_partial() or shard_dim(p, x.dim()) == last
          else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def local_blocks(fn, args, dims, out_dims):
    """``fn(*args)`` on rank-local blocks, the counterpart of a region that
    GSPMD keeps local: attention over its batch rows and heads, the MoE's
    routing over its batch rows.

    ``dims[i]`` is ``args[i]``'s (batch dim, head dim), either None;
    ``out_dims`` the result's (or a tuple of them for a tuple of
    results).  Without a DTensor among ``args`` this is ``fn(*args)``.
    Otherwise each mesh dim keeps its sharding where the first DTensor
    is sharded on its batch (or head) dim and every arg's batch (head)
    dim splits evenly over it; every other mesh dim is replicated.  Each
    arg is redistributed to that layout (a plain tensor counts as
    replicated: its block is a slice), ``fn`` runs on the local blocks
    and its results are DTensors of the same layout.  An arg whole on a
    mesh dim the computation splits gets a partial sum there as its
    gradient (each rank's blocks add their part)."""
    lead = (None if _CTX.mesh is None else
            next((i for i, a in enumerate(args) if is_dtensor(a)), None))
    if lead is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = args[lead].device_mesh
    roles, split = [], {0: 1, 1: 1}
    for i, p in enumerate(args[lead].placements):
        role, sd = None, shard_dim(p, args[lead].dim())
        for r in (0, 1):
            if sd is not None and sd == dims[lead][r]:
                n = split[r] * mesh.size(i)
                if all(d[r] is None or a is None or a.shape[d[r]] % n == 0
                       for a, d in zip(args, dims)):
                    role, split[r] = r, n
        roles.append(role)

    def layout(d):
        return [Replicate() if r is None or d[r] is None else Shard(d[r])
                for r in roles]

    def grads(d):
        return [Replicate() if r is None else
                Partial() if d[r] is None else Shard(d[r]) for r in roles]

    local = []
    for a, d in zip(args, dims):
        if a is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            if all(r is None or d[r] is None for r in roles):
                local.append(a)
                continue
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(a.redistribute(mesh, layout(d)).to_local(
            grad_placements=grads(d)))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(o if o is None else
                     DTensor.from_local(o, mesh, layout(d), run_check=False)
                     for o, d in zip(out, out_dims))
    return DTensor.from_local(out, mesh, layout(out_dims), run_check=False)


def grouped_blocks(fn, x, w):
    """``fn(x, w)`` for a grouped matmul, x (E, C, D) @ w (E, D, F) ->
    (E, C, F), on rank-local blocks: each rank runs ``fn`` (the MoE's
    ``gmm_model``, so K8 on a card) on its own experts, rows, columns
    and contraction slice.  Without a DTensor this is ``fn(x, w)``.

    Per mesh dim, the first that applies:
      - ``w`` splits its experts: ``x`` is brought to the same split
        (the expert-parallel dispatch; an all-to-all where ``x`` split
        its rows);
      - ``x`` splits its rows and ``w`` splits D or F (ZeRO-3's split
        of the embedding dim): ``w`` is gathered there, or, where that
        moves more bytes than moving ``x`` and the result (a decode
        step's few rows), ``x`` is moved to the same split of D (the
        result a partial sum) or gathered (the result split over F);
      - ``x`` splits D and ``w`` splits D: both keep it, and the result
        is a partial sum (the row-parallel product of tensor
        parallelism);
      - ``w`` splits F: ``x`` is replicated there (the column-parallel
        product);
      - ``x`` splits its rows: ``w`` is gathered there;
      - ``x`` splits its experts: ``w`` takes the same experts;
      - else both are replicated.
    A split that does not divide its dim evenly is gathered instead.
    An operand whole on a mesh dim the product splits gets a partial
    sum there as its gradient."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return fn(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    whole = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, whole, run_check=False)
    sizes = {"E": x.shape[0], "C": x.shape[1], "D": x.shape[2],
             "F": w.shape[2]}
    # the placements of x, w, the result and x's and w's gradients for
    # each way of splitting
    ways = {"E": (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0)),
            "D": (Shard(2), Shard(1), Partial(), Shard(2), Shard(1)),
            "F": (Replicate(), Shard(2), Shard(2), Partial(), Shard(2)),
            "C": (Shard(1), Replicate(), Shard(1), Shard(1), Partial()),
            None: (Replicate(),) * 5}
    parts = dict.fromkeys(sizes, 1)
    # bytes moved by gathering w against moving x and the result, for
    # ZeRO-3's choice
    x_bytes = x.to_local().numel() * x.element_size()
    w_bytes = w.to_local().numel() * w.element_size()
    out_bytes = x_bytes * sizes["F"] / sizes["D"]
    xp, wp, op, xg, wg = [], [], [], [], []
    for i in range(mesh.ndim):
        sx = shard_dim(x.placements[i], 3)
        sw = shard_dim(w.placements[i], 3)
        if sw == 0:
            way = "E"
        elif sx == 1 and sw in (1, 2):
            moved = x_bytes * (mesh.size(i) if sw == 2 else 1) + out_bytes
            way = ("C" if w_bytes * mesh.size(i) <= moved else
                   "D" if sw == 1 else "F")
        elif sw == 1 and sx == 2:
            way = "D"
        else:
            way = ("F" if sw == 2 else "C" if sx == 1 else
                   "E" if sx == 0 else None)
        if way is not None:
            if sizes[way] % (parts[way] * mesh.size(i)):
                way = None
            else:
                parts[way] *= mesh.size(i)
        for lst, p in zip((xp, wp, op, xg, wg), ways[way]):
            lst.append(p)
    out = fn(x.redistribute(mesh, xp).to_local(grad_placements=xg),
             w.redistribute(mesh, wp).to_local(grad_placements=wg))
    return DTensor.from_local(out, mesh, op, run_check=False)


def vocab_parallel_embed(table, ids):
    """``table[ids]``: the embedding gather.  A DTensor table whose
    vocabulary may be split over ranks: each rank gathers the rows it
    holds (zeros for the others'), and the rows are partial sums over
    the vocabulary's mesh dims (the next constraint sums them).  The
    table's embedding dim is gathered first where it is split (ZeRO-3's
    gather before use); the ids keep their batch split, so the table's
    gradient is a partial sum over it."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [shard_dim(p, 2) == 0 for p in table.placements]
    rows = ([shard_dim(p, ids.dim()) == 0 and not v
             for p, v in zip(ids.placements, vocab)]
            if isinstance(ids, DTensor) else [False] * mesh.ndim)
    table = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                      for v in vocab])
    if isinstance(ids, DTensor):
        ids = ids.redistribute(mesh, [Shard(0) if r else Replicate()
                                      for r in rows]).to_local()
    local = table.to_local(grad_placements=[
        Shard(0) if v else Partial() if r else Replicate()
        for v, r in zip(vocab, rows)])
    V_loc, off = local.shape[0], 0
    for i, v in enumerate(vocab):
        if v:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    off *= V_loc
    held = (ids >= off) & (ids < off + V_loc)
    out = local[(ids - off).clamp(0, V_loc - 1)] * held[..., None].to(
        local.dtype)
    return DTensor.from_local(
        out, mesh, [Partial() if v else Shard(0) if r else Replicate()
                    for v, r in zip(vocab, rows)], run_check=False)


def vocab_parallel_lse(logits, labels):
    """(logsumexp over the last dim, the label's logit) of (B, T, V)
    ``logits``.  DTensor logits whose vocabulary may be split over ranks
    reduce each rank's block, and the (B, T) results are summed (or
    maxed) across ranks, as a vocab-parallel cross entropy does: no rank
    gathers a whole row."""
    if not is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels.long()[..., None])[..., 0])
    V = logits.shape[-1]
    m = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    hit = labels.long()[..., None] == torch.arange(V, device=labels.device)
    ll = torch.where(hit, logits, 0.0).sum(-1)
    return lse, ll


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
