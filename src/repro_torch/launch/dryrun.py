"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh, without allocating.

For each cell the port builds the train step (train shapes), the
prefill step or the one-token serve step (decode shapes), with the
parameters, optimizer state, batch and caches as DTensors over fake
CPU tensors (a shape, a type and no storage) on the fake 16x16 or
2x16x16 mesh of ``launch.mesh.make_production_mesh``, and runs it once
under ``Account``, a dispatch mode that records, for rank 0:

  - ``flops``: the FLOPs of rank 0's local ops (matmuls, convolutions,
    attention: ``torch.utils.flop_counter``'s formulas), per device;
  - ``collective_bytes``: the result bytes of every collective rank 0
    takes part in, by the reference's op names (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``).  A DTensor Shard->Shard transition counts
    as one ``all-to-all`` of its result bytes, also where DTensor runs
    it on the CPU mesh as an all-gather and a chunk;
  - ``argument_size_bytes`` (the step's inputs' local bytes),
    ``output_size_bytes`` (its outputs') and ``temp_size_bytes`` (the
    peak of live local bytes the step allocated beyond its arguments).

Nothing touches a GPU: on fake CPU tensors K7 and K8 take their plain
routes, which compute the same products.  The reference lowers and
compiles with XLA instead; its ``lower_s`` / ``compile_s`` become
``trace_s`` here, and it has ``bytes_accessed`` and
``generated_code_size``, which a trace has no counterpart of.

Usage:
  python -m repro_torch.launch.dryrun --arch command-r-35b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCell,
                                      shape_applicable)
from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.models import model_zoo
from repro_torch.optim.optimizer import OptConfig, init_opt_state
from repro_torch.parallel import sharding as shard_rules
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_train_step

BF16 = torch.bfloat16

# ---------------------------------------------------------------------------
# Accounting: per-device FLOPs, collective bytes and live bytes of a trace
# ---------------------------------------------------------------------------
# functional-collective op name -> the reference's HLO op name (another
# collective is counted under its own name)
_COLL_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def local_tensors(tree):
    """The local tensors of a tree's leaves (a DTensor's ``_local_tensor``,
    a plain tensor itself)."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def local_bytes(tree) -> int:
    """Bytes of a tree's local tensors, each storage once."""
    seen, n = set(), 0
    for t in local_tensors(tree):
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


class Account(TorchDispatchMode):
    """Counts rank 0's local work while a step runs on DTensors over the
    fake tensors of ``fake_mode``.

    A DTensor-level op is passed to DTensor (``NotImplemented``), whose
    local ops come back here: only those are counted, so no product is
    counted at both levels.  Ops on tensors of any other fake mode (the
    shape computations of DTensor's sharding propagation) are not
    counted either."""

    def __init__(self, fake_mode):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.fake_mode = fake_mode
        self.registry = flop_registry
        self.flops = 0
        self.coll: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, Any] = {}   # id(storage) -> weakref
        self._quiet = 0

    # -- memory --------------------------------------------------------
    def note_arguments(self, tree) -> None:
        """Mark the storages of ``tree`` as arguments (never counted)."""
        for t in local_tensors(tree):
            st = t.untyped_storage()
            self._seen[id(st)] = None

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._seen[key] = weakref.ref(st, self._freed(key, n))

    def _freed(self, key, n):
        def cb(_):
            self._seen.pop(key, None)
            self.live -= n
        return cb

    # -- collectives ---------------------------------------------------
    def add_collective(self, name: str, nbytes: float) -> None:
        self.coll[name] = self.coll.get(name, 0) + nbytes

    @contextlib.contextmanager
    def quiet(self):
        """Collectives made inside the block are not counted (a
        caller counts their sum as what the program means)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _ours(self, args, kwargs) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        ts = _tensors(list(args) + list(kwargs.values()))
        return bool(ts) and all(isinstance(t, FakeTensor)
                                and t.fake_mode is self.fake_mode
                                for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.prim.device.default:
            return func(*args, **kwargs)
        if func.namespace in _COLL_NAMESPACES:
            out = func(*args, **kwargs)
            name = func._overloadpacket.__name__
            if name != "wait_tensor" and not self._quiet:
                self.add_collective(_COLL_NAMES.get(name, name),
                                    sum(_nbytes(t) for t in _tensors(out)))
            return out
        ours = self._ours(args, kwargs)
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        if ours:
            if packet in self.registry:
                self.flops += self.registry[packet](*args, **kwargs,
                                                    out_val=out)
            self._track(out)
        return out


def _counted_alltoall(orig, acct):
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        with acct.quiet():
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        acct.add_collective("all-to-all", _nbytes(out))
        return out
    return shard_dim_alltoall


@contextlib.contextmanager
def _swapped(pairs):
    """Set ``(module, name, value)`` attributes for the block."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


@contextlib.contextmanager
def accounting(fake_mode):
    """An ``Account`` over ``fake_mode``'s tensors for the block.

    Two hooks into DTensor keep its work out of rank 0's count and
    count what it means: its sharding propagation, which runs each op
    once more at the global shapes to learn the output's, runs in a
    fake mode of its own; and a Shard->Shard transition counts as one
    all-to-all of its result bytes (on a CPU mesh DTensor runs it as an
    all-gather and a chunk)."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor._sharding_prop as sp
    from torch._subclasses.fake_tensor import FakeTensorMode
    acct = Account(fake_mode)
    orig = cu.shard_dim_alltoall
    wrapper = _counted_alltoall(orig, acct)
    pairs = [(mod, "shard_dim_alltoall", wrapper)
             for name, mod in list(sys.modules.items())
             if name.startswith("torch.distributed.tensor")
             and getattr(mod, "shard_dim_alltoall", None) is orig]
    if hasattr(sp, "detect_fake_mode"):
        shapes_mode = FakeTensorMode()
        pairs.append((sp, "detect_fake_mode", lambda *a, **k: shapes_mode))
    with _swapped(pairs), acct:
        yield acct


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------
def _to_dtype(tree, dtype):
    return tree_map(lambda t: (torch.empty(t.shape, dtype=dtype)
                               if t.is_floating_point() else t), tree)


def _distribute(axes_tree, shapes_tree, mesh, rules):
    """DTensors of ``shapes_tree``'s leaves (fake tensors) laid out by
    ``spec_for`` over their logical axes: each a fake local shard."""
    from torch.distributed.tensor import DTensor
    sizes = [mesh.size(i) for i in range(mesh.ndim)]

    def one(axes, t):
        spec = shard_rules.spec_for(axes, shape=tuple(t.shape), mesh=mesh,
                                    rules=rules)
        pl = shard_rules.placements(spec, mesh)
        local = list(t.shape)
        for p, n in zip(pl, sizes):
            if p.is_shard():
                local[p.dim] //= n
        return DTensor.from_local(torch.empty(local, dtype=t.dtype), mesh,
                                  pl, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return shard_rules.map_axes(one, axes_tree, shapes_tree)


def cell_rules(cfg: ArchConfig, mesh) -> Dict:
    """The reference's rule overrides for ``cfg`` on ``mesh``
    (``launch/dryrun.py``'s ``build_cell``)."""
    names = shard_rules.mesh_axis_names(mesh)
    rules = shard_rules.default_rules(names, fsdp=cfg.parallel.fsdp)
    if cfg.parallel.seq_shard_kv:
        rules["seq_kv"] = "model"
        rules["kv_heads"] = None
    if cfg.parallel.seq_parallel:
        rules["seq"] = "model"
    if cfg.parallel.layout == "fsdp":
        all_axes = tuple(names)
        for k in ("mlp", "q_hidden", "kv_hidden", "heads", "kv_heads",
                  "vocab", "inner", "expert"):
            rules[k] = None
        rules["batch"] = all_axes
        rules["embed"] = all_axes
    if cfg.moe is not None and cfg.moe.shard_mode == "tp":
        rules["expert"] = (tuple(a for a in names if a in ("pod", "data"))
                           if cfg.parallel.fsdp else None)
    elif cfg.moe is not None and cfg.moe.shard_mode == "smap":
        rules["expert"] = "data"
    return rules


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               opt_kind: Optional[str] = None):
    """(step fn, argument tuple, rules) for one cell: the arguments are
    DTensors over fake tensors of the active fake mode."""
    tp = shard_rules.mesh_shape(mesh)["model"]
    rules = cell_rules(cfg, mesh)
    pvals, paxes = model_zoo.param_specs(cfg)
    pvals = _to_dtype(pvals, BF16)
    params = _distribute(paxes, pvals, mesh, rules)
    ispecs = model_zoo.input_specs(cfg, cell, tp=tp)

    if cell.kind == "train":
        opt_cfg = OptConfig(
            kind=opt_kind or ("adafactor" if cfg.parallel.fsdp else "adamw"),
            m_dtype="bfloat16" if cfg.parallel.fsdp else "float32")
        ostate = init_opt_state(opt_cfg, pvals)
        oaxes = sh.opt_state_axes(paxes, pvals, opt_cfg.kind)
        ostate = _distribute(oaxes, ostate, mesh, rules)
        batch = _distribute(sh.batch_axes(ispecs), ispecs, mesh, rules)
        fn = make_train_step(cfg, opt_cfg, tp=tp)
        return fn, (params, ostate, batch, 0), rules

    if cell.kind == "prefill":
        bspec = {k: v for k, v in ispecs.items() if k != "labels"}
        batch = _distribute(sh.batch_axes(bspec), bspec, mesh, rules)
        fn = make_prefill_step(cfg, tp=tp, cache_len=cell.seq_len)
        return fn, (params, batch), rules

    caches = _distribute(sh.cache_axes(cfg), ispecs["caches"], mesh, rules)
    token = _distribute(("batch", None), ispecs["token"], mesh, rules)
    fn = make_serve_step(cfg, tp=tp)
    return fn, (params, token, caches, cell.seq_len - 1), rules


def trace_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               opt_kind: Optional[str] = None) -> Dict[str, Any]:
    """Build and run one cell's step under ``Account``; returns the
    per-device numbers of the record."""
    from torch.distributed.tensor.experimental import implicit_replication
    with model_zoo.fake_mode() as fm:
        fn, args, rules = build_cell(cfg, cell, mesh, opt_kind)
        arg_bytes = local_bytes(args)
        with shard_rules.use_mesh(mesh, rules=rules), \
                implicit_replication(), torch.no_grad(), \
                accounting(fm) as acct:
            acct.note_arguments(args)
            out = fn(*args)
            out_bytes = local_bytes(out)
            del out
    return {"flops": float(acct.flops), "collective_bytes": dict(acct.coll),
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": acct.peak}


def check_accounting(mesh) -> None:
    """Raise unless ``Account`` counts, on ``mesh``, a split product's
    local FLOPs once, a Shard->Shard transition as one all-to-all of its
    result bytes and a Partial->Replicate one as one all-reduce: the
    hooks of ``accounting`` reach into DTensor's internals, which differ
    between torch versions."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    n_d, n_m = sizes[-2], sizes[-1]
    rest = [Replicate()] * (mesh.ndim - 2)
    with model_zoo.fake_mode() as fm:
        a = DTensor.from_local(torch.empty(64 // n_d, 128), mesh,
                               rest + [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(128, 256 // n_m), mesh,
                               rest + [Replicate(), Shard(1)],
                               run_check=False)
        c = DTensor.from_local(torch.empty(64, 32), mesh,
                               rest + [Replicate(), Partial()],
                               run_check=False)
        with accounting(fm) as acct:
            ab = a @ b
            moved = ab.redistribute(mesh, rest + [Shard(0), Shard(0)])
            summed = c.redistribute(mesh, rest + [Replicate(), Replicate()])
    want_flops = 2 * (64 // n_d) * 128 * (256 // n_m)
    want = {"all-to-all": _nbytes(moved.to_local()),
            "all-reduce": _nbytes(summed.to_local())}
    if acct.flops != want_flops or acct.coll != want:
        raise RuntimeError(
            f"dry-run accounting is off on torch {torch.__version__}: "
            f"flops {acct.flops} (want {want_flops}), collectives "
            f"{acct.coll} (want {want})")


def run_cell(arch_id: str, cell: ShapeCell, multi_pod: bool,
             opt_kind: Optional[str] = None,
             cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """One cell's record: ``OK`` with the per-device numbers, ``SKIP``
    where the shape does not apply, ``FAIL`` with the error.  Makes the
    production mesh (a fake default process group) and destroys it
    before returning."""
    cfg = cfg or registry.get(arch_id)
    ok, why = shape_applicable(cfg, cell)
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": cell.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": cell.kind,
    }
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        check_accounting(mesh)
        r = trace_cell(cfg, cell, mesh, opt_kind)
        coll = r["collective_bytes"]
        rec.update(status="OK", trace_s=round(time.time() - t0, 1),
                   flops=r["flops"], collective_bytes=coll,
                   collective_total=float(sum(coll.values())),
                   argument_size_bytes=r["argument_size_bytes"],
                   output_size_bytes=r["output_size_bytes"],
                   temp_size_bytes=r["temp_size_bytes"],
                   n_devices=mesh.size())
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        mesh_mod.release()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default=None)
    ap.add_argument("--out", default=None, help="write JSONL here")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if (args.all or not args.arch) \
        else [args.arch]
    cells = SHAPES if (args.all or not args.shape) \
        else [c for c in SHAPES if c.name == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    fh = open(args.out, "a") if args.out else None
    for aid in archs:
        for cell in cells:
            for mp in meshes:
                rec = run_cell(aid, cell, mp, args.opt)
                results.append(rec)
                print(f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} "
                      f"{rec['mesh']:8s} {rec['status']}"
                      + (f" ({rec.get('reason', rec.get('error', ''))})"
                         if rec["status"] != "OK" else
                         f" flops={rec['flops']:.3e} "
                         f"coll={rec['collective_total']:.3e}B "
                         f"trace={rec['trace_s']}s"),
                      flush=True)
                if fh:
                    fh.write(json.dumps(rec) + "\n")
                    fh.flush()
    if fh:
        fh.close()
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"[dryrun] done: {len(results)} cells, {n_fail} failures; "
          f"cuda initialized: {torch.cuda.is_initialized()}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
