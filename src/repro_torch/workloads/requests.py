"""Request adapters: workloads as serving requests.

The serving scheduler (``repro_torch.serve.scheduler``) is
workload-agnostic; this registry is where the paper's workloads become
*requests*.  Each adapter turns a payload into a ``RequestSpec``:

* ``run_one()`` — the whole request on the *current lane's* device
  (``kernels.common.current_device()``: the scheduler's lane sets it;
  must return a ready value, like ``run_share``),
* ``run_share(group, start, n)`` / ``combine(outs)`` — the work-shared
  form (the paper's §5.4.3 split, used when placement projects a
  makespan win over the split overhead); each share runs on the device
  of the executor's group worker that calls it, ``combine`` gathers on
  the calling thread's lane device,
* ``total_units`` / ``unit_cost`` — what placement scores against the
  cost model before any probe has run (per-group dicts for
  suitability-split workloads whose groups run different algorithms),
* ``bucket`` — the shape bucket batching coalesces on: two requests
  merge only when a single batched execution can serve both,
* ``merge`` (optional) — array-level batching: stack same-shape
  payloads into ONE kernel call (a ``MergedBatch`` whose ``demux``
  recovers each member's exact result).  Without it, or where it
  declines, the scheduler falls back to request-granularity coalescing
  (members run whole, one per work unit).

Every entry of ``repro_torch.workloads.ALL_WORKLOADS`` — the paper's 13
Table-1 workloads — is registered here (plus ``attention`` and the
per-arch serve-LM adapters), each with a ``unit_cost`` prior, so a
fresh process can place ANY Table-1 request with zero probe runs.

Payloads are dicts of shape parameters (sizes, seeds) or raw numpy
arrays.  Inputs are made once on the host (the workload modules'
memoized generators: the reference's values from the same seed) and
copied once per device on first use, so repeated requests reuse them
the way real repeated traffic would.  The attention and LM adapters
draw their seeded inputs with a CPU ``torch.Generator``, which is not
the reference's ``jax.random`` stream: pass the arrays to compare.

Adapters whose spec carries a ``stepper`` ride the continuous-batching
engine (``serve/continuous.py``): ``continuous=True`` payloads of
listrank, lbm and dither, and every request of a
``make_continuous_lm_adapter`` workload.
"""
from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.cost_model import CostTerms
from repro_torch.kernels.autotune import bucket as pow2_bucket
from repro_torch.kernels.common import current_device, lane_device, sync

UnitCost = Union[CostTerms, Dict[str, CostTerms], None]

# lane class of the device-backed adapters (the reference's "jax"):
# torch ops on the GPU or the CPU; "host" adapters are single-threaded
# numpy that releases the interpreter lock (sort)
TORCH = "torch"
HOST = "host"

# devices on which ``conv2d_batched`` is bitwise equal to the solo
# ``torch_conv`` row by row (``tests/test_torch_cuda.py``; on the CPU
# the grouped conv differs at K = 3, ``tests/test_torch_serving.py``);
# the conv merge declines elsewhere
CONV_MERGE_DEVICES = ("cuda",)


@dataclass(frozen=True)
class RequestSpec:
    """Everything the scheduler needs to place and execute one request.
    ``workload`` keys the calibration cache (and therefore placement's
    learned per-group affinity); it must identify the computation AND
    the shape bucket.

    ``arrays`` holds the request's inputs (``Inputs``: host arrays with
    their per-device copies) when the adapter supports array-level
    batching; ``merge`` builds a ``MergedBatch`` from a list of
    same-bucket specs (returning ``None`` when this particular batch
    cannot stack, e.g. mismatched shapes inside one pow2 bucket — the
    scheduler then falls back to per-request coalescing).

    ``stepper`` opts a request into the continuous-batching engine
    (``serve/continuous.py``): requests sharing one stepper instance
    stack into one slot state.

    ``lane_class`` is the contention pricing class: ``"torch"`` ops are
    internally multithreaded on the CPU and share the card's launch
    path, so two such lanes contend; ``"host"`` ops (single-core numpy
    that releases the interpreter lock, e.g. sort) overlap a torch lane
    near-perfectly.  The scheduler prices shared/contended spans with
    the factor probed for THIS class."""
    workload: str
    total_units: int
    run_one: Callable[[], object]
    run_share: Callable[[str, int, int], object]
    combine: Callable[[List[object]], object]
    unit_cost: UnitCost = None
    comm_cost: float = 0.0
    whole_shares: bool = False
    bucket: str = ""
    arrays: tuple = ()
    merge: Optional[Callable[[List["RequestSpec"]],
                             Optional["MergedBatch"]]] = None
    stepper: Optional[object] = None
    lane_class: str = TORCH


@dataclass(frozen=True)
class MergedBatch:
    """One array-level batched execution serving several requests:
    ``spec`` runs the stacked inputs as one kernel call (dedicated
    path); ``demux(value, i)`` slices member ``i``'s exact result back
    out — batched execution must be bit-identical to per-request
    execution, so demux is pure indexing, never recomputation."""
    spec: RequestSpec
    demux: Callable[[object, int], object]


class Inputs:
    """A request's host (numpy) inputs with one copy per device, made on
    first use on that device and kept (set-up: the first request on a
    device pays the copy, every later one reuses it).  ``memo`` keeps
    other per-device set-up (a tuned config, a packed matrix) the same
    way."""

    def __init__(self, *arrays):
        self.host = tuple(arrays)
        self._memo: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    @property
    def shapes(self) -> tuple:
        return tuple(tuple(a.shape) for a in self.host)

    def memo(self, tag, dev: torch.device, build: Callable[[], object]):
        key = (tag, str(dev))
        with self._lock:
            if key in self._memo:
                return self._memo[key]
        val = build()
        with self._lock:
            return self._memo.setdefault(key, val)

    def on(self, dev: Optional[torch.device] = None) -> tuple:
        """The inputs on ``dev`` (default: the lane's device)."""
        dev = dev or current_device()

        def place():
            out = tuple(torch.as_tensor(a).to(dev) for a in self.host)
            return sync(out)
        return self.memo("inputs", dev, place)


_REGISTRY: Dict[str, Callable[[Optional[dict]], RequestSpec]] = {}


def register(name: str,
             factory: Callable[[Optional[dict]], RequestSpec]) -> None:
    _REGISTRY[name] = factory


def unregister(name: str) -> None:
    """Drop an adapter (and what its factory holds: an LM adapter keeps
    its weights alive)."""
    _REGISTRY.pop(name, None)


def available() -> List[str]:
    _ensure_defaults()
    return sorted(_REGISTRY)


def make_request(workload: str, payload: Optional[dict] = None
                 ) -> RequestSpec:
    """Resolve a (workload-name, payload) submission to a spec."""
    _ensure_defaults()
    if workload not in _REGISTRY:
        raise KeyError(f"unknown workload {workload!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[workload](payload)


def _gather(outs) -> torch.Tensor:
    """Concatenate share outputs (on either group's device) on the
    calling thread's lane device."""
    dev = current_device()
    return sync(torch.cat([o.to(dev) for o in outs], dim=0))


def _ceil_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _pad_pow2_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis to ``rows`` (a pow2): merged batches of
    3, 5, 6... members would each run a fresh shape; padding bounds the
    shape set to the pow2 sizes."""
    b = int(x.shape[0])
    if b == rows:
        return x
    pad = torch.zeros((rows - b,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def _stack_inputs(specs: List[RequestSpec], n_arrays: int):
    """The members' ``Inputs`` when every member has them with the same
    shapes, else None (a pow2 bucket holding unequal shapes)."""
    ins = [s.arrays[0] for s in specs
           if len(s.arrays) == 1 and isinstance(s.arrays[0], Inputs)
           and len(s.arrays[0].host) == n_arrays]
    if len(ins) != len(specs) or len({i.shapes for i in ins}) != 1:
        return None
    return ins


# ---------------------------------------------------------------------------
# conv — regular, compute-bound; units are output rows
# ---------------------------------------------------------------------------
def _conv_merge(specs: List[RequestSpec]) -> Optional[MergedBatch]:
    """Stack same-shape conv requests into ONE grouped-conv call
    (``conv2d_batched``); demux returns row i.  Engages only when the
    members' solo path resolves to the ``torch_conv`` impl, on a device
    where the batched call is bitwise equal to it per row
    (``CONV_MERGE_DEVICES``): the shift-add and the CUDA kernel are not
    that call, so a bucket tuned to them declines and falls back to
    per-request coalescing (batching is an optimization, never a
    correctness risk)."""
    from repro_torch.kernels.conv2d.ops import conv2d_batched

    ins = _stack_inputs(specs, 2)
    dev = current_device()
    if ins is None or dev.type not in CONV_MERGE_DEVICES:
        return None
    if dict(_conv_cfg(ins[0], dev)).get("impl") != "torch_conv":
        return None
    n_real = len(ins)
    rows = _ceil_pow2(n_real)
    imgs = _pad_pow2_rows(torch.stack([i.on(dev)[0] for i in ins]), rows)
    ws = _pad_pow2_rows(torch.stack([i.on(dev)[1] for i in ins]), rows)
    H, W = ins[0].host[0].shape
    K = ins[0].host[1].shape[0]

    def run_one():
        return sync(conv2d_batched(imgs, ws))

    def run_share(group, start, k):
        return sync(conv2d_batched(imgs[start:start + k],
                                   ws[start:start + k]))

    base = specs[0]
    spec = RequestSpec(
        # row units are whole member convs — a different per-unit cost
        # than the base spec's output rows, so a distinct calibration key
        workload=f"{base.workload}@stack", total_units=n_real,
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=CostTerms(flops=2.0 * H * W * K * K,
                            bytes=4.0 * (2 * H * W + K * K)),
        bucket=base.bucket)
    return MergedBatch(spec, lambda value, i: value[i])


def _conv_cfg(inputs: Inputs, dev: torch.device):
    from repro_torch.kernels.conv2d.ops import tuned_config

    def resolve():
        img, w = inputs.on(dev)
        return tuned_config(img, w)
    return inputs.memo("cfg", dev, resolve)


@functools.lru_cache(maxsize=16)
def _conv_inputs(size: int, ksize: int, seed: int) -> Inputs:
    from repro_torch.workloads import conv
    return Inputs(*conv.make_inputs(size, ksize, seed))


def _conv_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.workloads import conv

    p = dict(payload or {})
    if "image" in p:
        ins = Inputs(np.asarray(p["image"], np.float32),
                     np.asarray(p["weights"], np.float32))
    else:
        ins = _conv_inputs(int(p.get("size", 512)), int(p.get("ksize", 15)),
                           int(p.get("seed", 0)))
    H, W = ins.host[0].shape
    K = ins.host[1].shape[0]

    def run_one():
        dev = current_device()
        img, w = ins.on(dev)
        return sync(conv2d(img, w, config=_conv_cfg(ins, dev)))

    def run_share(group, start, n):
        dev = current_device()
        img, w = ins.on(dev)
        return sync(conv.conv_rows(img, w, start, n,
                                   config=_conv_cfg(ins, dev)))

    return RequestSpec(
        workload=f"serve-conv/{H}x{K}", total_units=H,
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=CostTerms(flops=2.0 * W * K * K, bytes=4.0 * 2 * W),
        comm_cost=(K - 1) * W * 4 / 6e9,
        bucket=f"H{pow2_bucket(H)}_K{K}",
        arrays=(ins,), merge=_conv_merge)


# ---------------------------------------------------------------------------
# hist — memory-bound; units are element blocks
# ---------------------------------------------------------------------------
def _hist_merge(specs: List[RequestSpec]) -> Optional[MergedBatch]:
    """Stack same-length histogram payloads into a (R, n) matrix
    counted row-wise in ONE bincount call (``histogram_rows``); demux
    returns row i.  Counts are exact integer sums, so each row is
    bit-identical to the solo ``histogram`` of that payload whichever
    impl the solo path runs, on either device.  Zero-pad rows land
    every count in bin 0 of a padded row nobody reads."""
    from repro_torch.kernels.hist.ops import histogram_rows

    ins = _stack_inputs(specs, 1)
    if ins is None:
        return None
    dev = current_device()
    n_bins = int(specs[0].workload.rsplit("x", 1)[1])
    n_real = len(ins)
    stack = _pad_pow2_rows(torch.stack([i.on(dev)[0] for i in ins]),
                           _ceil_pow2(n_real))
    n = int(ins[0].host[0].shape[0])

    def run_one():
        return sync(histogram_rows(stack, n_bins))

    def run_share(group, start, k):
        return sync(histogram_rows(stack[start:start + k], n_bins))

    base = specs[0]
    spec = RequestSpec(
        # row units are whole member histograms, not element blocks —
        # distinct calibration key
        workload=f"{base.workload}@stack", total_units=n_real,
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=CostTerms(flops=2.0 * n, bytes=4.0 * (n + n_bins)),
        bucket=base.bucket)
    return MergedBatch(spec, lambda value, i: value[i])


@functools.lru_cache(maxsize=16)
def _hist_inputs(n: int, n_bins: int, seed: int) -> Inputs:
    from repro_torch.workloads import hist
    return Inputs(hist.make_inputs(n, n_bins, seed))


def _hist_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.kernels.hist.ops import histogram, tuned_config

    p = dict(payload or {})
    n_bins = int(p.get("n_bins", 256))
    if "data" in p:
        ins = Inputs(np.asarray(p["data"], np.int32))
    else:
        ins = _hist_inputs(int(p.get("n", 1 << 20)), n_bins,
                           int(p.get("seed", 0)))
    n = ins.host[0].shape[0]
    unit = max(n // 64, 1)
    units = max(n // unit, 1)

    def cfg(dev):
        return ins.memo("cfg", dev, lambda: tuned_config(
            ins.on(dev)[0][:max(n // 2, 1)], n_bins))

    def run_one():
        dev = current_device()
        return sync(histogram(ins.on(dev)[0], n_bins, config=cfg(dev)))

    def run_share(group, start, k):
        dev = current_device()
        if k <= 0:
            return torch.zeros(n_bins, dtype=torch.int32, device=dev)
        x = ins.on(dev)[0]
        return sync(histogram(x[start * unit:(start + k) * unit], n_bins,
                              config=cfg(dev)))

    def combine(outs):
        dev = current_device()
        value = torch.zeros(n_bins, dtype=torch.int32, device=dev)
        for o in outs:
            value += o.to(dev)
        return sync(value)

    return RequestSpec(
        workload=f"serve-hist/{n}x{n_bins}", total_units=units,
        run_one=run_one, run_share=run_share, combine=combine,
        unit_cost=CostTerms(flops=2.0 * unit, bytes=4.0 * unit),
        comm_cost=n_bins * 4 / 6e9,
        bucket=f"N{pow2_bucket(n)}_B{n_bins}",
        arrays=(ins,), merge=_hist_merge)


# ---------------------------------------------------------------------------
# spmv — the suitability split; units are nonzero blocks
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _spmv_problem(n: int, density: float, seed: int):
    """The matrix on the host, x, the nonzero unit and the unit count;
    per device (``Inputs.memo``): the single-device packing (ELL head +
    COO tail) and the suitability split's spec, each built once
    (packing is set-up, kept out of requests; so is the O(n^2) nonzero
    count)."""
    from repro_torch.workloads import spmv as spmv_wl

    A = spmv_wl.make_matrix(n, density, seed)
    nnz = int((A != 0).sum())
    unit = max(nnz // 256, 1)
    return A, Inputs(spmv_wl.make_vector(n, seed)), unit, nnz // unit


def _spmv_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.workloads import spmv as spmv_wl

    p = dict(payload or {})
    n = int(p.get("n", 1024))
    density = float(p.get("density", 0.01))
    seed = int(p.get("seed", 0))
    A, prob, unit, total_units = _spmv_problem(n, density, seed)

    def prepared(dev):
        return prob.memo("prepared", dev, lambda: spmv_ops.prepare(
            A, k_threshold=32, device=dev))

    def shared(dev):
        # both groups' paths on one device: each group's share runs on
        # its own worker's device, the merge on the caller's
        return prob.memo("share", dev, lambda: spmv_wl.make_share_spec(
            {"accel": dev, "host": dev}, dev, n, density, seed))

    def run_one():
        # the single-device algorithm: ELL head + COO tail, both here
        dev = current_device()
        return sync(spmv_ops.spmv(prepared(dev), prob.on(dev)[0]))

    def run_share(group, start, k):
        return shared(current_device()).run_share(group, start, k)

    def combine(outs):
        return shared(current_device()).combine(outs)

    return RequestSpec(
        workload=f"serve-spmv/{n}x{density:g}", total_units=total_units,
        run_one=run_one, run_share=run_share, combine=combine,
        unit_cost=spmv_wl._per_path_unit_cost(unit),
        comm_cost=n * 4 / 6e9, whole_shares=True,
        bucket=f"N{pow2_bucket(n)}_d{density:g}")


# ---------------------------------------------------------------------------
# sort — host-native compute (paper §4.1's CPU leaf-sort path); units
# are key segments.  np.sort releases the interpreter lock and runs
# single-core, so a sort request co-scheduled on one lane leaves the
# other lane's torch work unimpeded — the affinity spread the scheduler
# exploits.  It runs numpy on whichever lane it is placed, as the
# reference's does.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _sort_inputs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n).astype(np.float32)


def _sort_merge(specs: List[RequestSpec]) -> Optional[MergedBatch]:
    """Stack equal-length sort payloads into a (R, n) matrix sorted
    row-wise in ONE numpy call; demux returns row i.  Row-wise
    ``np.sort`` of the stack is bit-identical to sorting each payload
    alone (same algorithm over the same values)."""
    xs = [s.arrays[0] for s in specs if s.arrays]
    if len(xs) != len(specs) or len({x.shape for x in xs}) != 1:
        return None                     # pow2 bucket, unequal lengths
    stack = np.stack(xs)
    n = stack.shape[1]

    def run_one():
        return np.sort(stack, axis=-1, kind="stable")

    def run_share(group, start, k):
        return np.sort(stack[start:start + k], axis=-1, kind="stable")

    base = specs[0]
    lg = max(np.log2(max(n, 2)), 1.0)
    spec = RequestSpec(
        # row units are whole member sorts — a different per-unit cost
        # than the base spec's segments, so a distinct calibration key
        workload=f"{base.workload}@stack", total_units=len(xs),
        run_one=run_one, run_share=run_share,
        combine=lambda outs: np.concatenate(outs, axis=0),
        unit_cost=CostTerms(flops=2.0 * n * lg, bytes=8.0 * n * lg),
        bucket=base.bucket, lane_class=HOST)
    return MergedBatch(spec, lambda value, i: value[i])


def _sort_spec(payload: Optional[dict]) -> RequestSpec:
    p = dict(payload or {})
    if "data" in p:
        x = np.asarray(p["data"], dtype=np.float32)
    else:
        x = _sort_inputs(int(p.get("n", 1 << 16)), int(p.get("seed", 0)))
    n = x.shape[0]
    units = 16
    seg = -(-n // units)

    def run_one():
        return np.sort(x, kind="stable")

    def run_share(group, start, k):
        lo, hi = start * seg, min((start + k) * seg, n)
        return np.sort(x[lo:hi], kind="stable")

    def combine(outs):
        out = np.concatenate(outs)
        out.sort(kind="stable")                 # final merge pass
        return out

    lg = max(np.log2(max(n, 2)), 1.0)
    return RequestSpec(
        workload=f"serve-sort/{n}", total_units=units,
        run_one=run_one, run_share=run_share, combine=combine,
        unit_cost=CostTerms(flops=2.0 * seg * lg, bytes=8.0 * seg * lg),
        comm_cost=0.0,
        bucket=f"N{pow2_bucket(n)}",
        arrays=(x,), merge=_sort_merge, lane_class=HOST)


# ---------------------------------------------------------------------------
# attention — serve-LM's hot kernel; units are batch rows
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _attn_inputs(B: int, T: int, H: int, d: int, Kv: int, seed: int
                 ) -> Inputs:
    """Deterministic q/k/v from a CPU generator, memoized: regenerating
    them on every submit puts RNG work on the cores the lanes serve
    from."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, T, H, d), generator=gen).numpy()
    k = torch.randn((B, T, Kv, d), generator=gen).numpy()
    v = torch.randn((B, T, Kv, d), generator=gen).numpy()
    return Inputs(q, k, v)


def _attn_merge(specs: List[RequestSpec]) -> Optional[MergedBatch]:
    """Concatenate same-shape attention requests along the batch axis
    into ONE sdpa call, the batch zero-padded to a pow2; demux slices
    each member's rows back out.  Every (batch-row, head) is an
    independent program of the kernel (K7's grid on the card), so the
    stacked call is bit-identical per row (pad rows compute garbage
    nobody reads) on either device."""
    from repro_torch.kernels.flash_attention import ops as attn_ops

    ins = [s.arrays[0] for s in specs
           if len(s.arrays) == 1 and isinstance(s.arrays[0], Inputs)
           and len(s.arrays[0].host) == 3]
    if (len(ins) != len(specs)
            or len({i.shapes[0][1:] for i in ins}) != 1
            or len({i.shapes[1][1:] for i in ins}) != 1):
        return None                     # pow2 bucket, unequal shapes
    dev = current_device()
    offs = np.cumsum([0] + [int(i.host[0].shape[0]) for i in ins])
    rows = _ceil_pow2(int(offs[-1]))
    q, k, v = (_pad_pow2_rows(torch.cat([i.on(dev)[j] for i in ins]), rows)
               for j in range(3))
    cfg = ins[0].memo("cfg", dev, lambda: attn_ops.tuned_config(
        *ins[0].on(dev), causal=True))

    def run_one():
        return sync(attn_ops.sdpa(q, k, v, causal=True, config=cfg))

    def run_share(group, start, n):
        return sync(attn_ops.sdpa(q[start:start + n], k[start:start + n],
                                  v[start:start + n], causal=True,
                                  config=cfg))

    base = specs[0]
    spec = RequestSpec(
        # distinct calibration key: run_one computes PADDED rows while
        # total_units counts real ones, so elapsed/real-rows would
        # overestimate the base workload's per-row time by up to 2x
        workload=f"{base.workload}@stack", total_units=int(offs[-1]),
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=base.unit_cost, comm_cost=base.comm_cost,
        bucket=base.bucket)
    return MergedBatch(spec,
                       lambda value, i: value[offs[i]:offs[i + 1]])


def _attention_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.kernels.flash_attention import ops as attn_ops

    p = dict(payload or {})
    if "q" in p:
        ins = Inputs(*(np.asarray(p[x], np.float32) for x in "qkv"))
    else:
        ins = _attn_inputs(
            int(p.get("batch", 4)), int(p.get("seq", 256)),
            int(p.get("heads", 8)), int(p.get("dim", 64)),
            int(p.get("kv_heads", p.get("heads", 8))),
            int(p.get("seed", 0)))
    B, T, H, d = ins.host[0].shape
    S = ins.host[1].shape[1]

    def cfg(dev):
        return ins.memo("cfg", dev, lambda: attn_ops.tuned_config(
            *ins.on(dev), causal=True))

    def run_one():
        dev = current_device()
        return sync(attn_ops.sdpa(*ins.on(dev), causal=True,
                                  config=cfg(dev)))

    def run_share(group, start, n):
        dev = current_device()
        q, k, v = ins.on(dev)
        return sync(attn_ops.sdpa(q[start:start + n], k[start:start + n],
                                  v[start:start + n], causal=True,
                                  config=cfg(dev)))

    # per-batch-row analytic terms of the kernel (BH = heads of ONE
    # row): the card's route, which placement prices for every group
    unit = attn_ops.cost_terms({"impl": "cuda"}, H, T, S, d, True)

    return RequestSpec(
        workload=f"serve-attn/{T}x{H}x{d}", total_units=B,
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=unit,
        comm_cost=T * H * d * 4 / 6e9,
        bucket=f"T{pow2_bucket(T)}_H{H}_d{d}",
        arrays=(ins,), merge=_attn_merge)


# ---------------------------------------------------------------------------
# spgemm — row-row product (paper §4.4); units are output rows.  The
# padded-ELL pack of A is input prep, made once per problem, so every
# request (and every row share) is a pure gather+einsum call —
# run_share slices the SAME packed arrays run_one uses, so shares are
# bit-identical to the dedicated path, uniform in shape, stealable.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _spgemm_prepared(n: int, density: float, seed: int) -> Inputs:
    from repro_torch.workloads import spgemm as spgemm_wl

    A, B = spgemm_wl.make_matrices(n, density, seed)
    vals, idx = spgemm_wl.pack_rows(A)
    return Inputs(vals, idx, B)


def _spgemm_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import spgemm as spgemm_wl

    p = dict(payload or {})
    n = int(p.get("n", 512))
    density = float(p.get("density", 0.02))
    seed = int(p.get("seed", 0))
    ins = _spgemm_prepared(n, density, seed)

    def rowrow(lo, hi):
        vals, idx, B = ins.on(current_device())
        return sync(torch.einsum("rk,rkc->rc", vals[lo:hi], B[idx[lo:hi]]))

    return RequestSpec(
        workload=f"serve-spgemm/{n}x{density:g}", total_units=n,
        run_one=lambda: rowrow(0, n),
        run_share=lambda group, start, k: rowrow(start, start + k),
        combine=_gather,
        unit_cost=spgemm_wl.unit_cost_terms(n, density),
        comm_cost=n * n * density * 8 / 6e9,
        bucket=f"N{pow2_bucket(n)}_d{density:g}")


# ---------------------------------------------------------------------------
# raycast — two-phase volume render (paper §4.5); units are ray blocks.
# Per-ray independence lets one request's phases fuse per share AND
# lets same-volume requests stack (array-level batching).
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _raycast_volume(d: int, seed: int) -> Inputs:
    from repro_torch.workloads import raycast as rc
    return Inputs(rc.make_volume(d, seed))


@functools.lru_cache(maxsize=4)
def _raycast_rays(n_rays: int, seed: int) -> Inputs:
    from repro_torch.workloads import raycast as rc
    return Inputs(*rc.make_rays(n_rays, seed))


def _raycast_run(vol, ro, rd):
    from repro_torch.workloads import raycast as rc

    t_in = rc.entry(ro, rd)
    return sync(rc.march(vol, ro, rd, t_in))


def _raycast_unit_cost() -> CostTerms:
    """Per-ray prior for a full entry+march request."""
    from repro_torch.workloads import raycast as rc

    e, m = rc.entry_cost_terms(), rc.march_cost_terms()
    return CostTerms(flops=e.flops + m.flops, bytes=e.bytes + m.bytes)


def _raycast_merge(specs: List[RequestSpec]) -> Optional[MergedBatch]:
    """Concatenate same-volume, same-count ray sets into ONE
    entry+march call; demux slices each member's rays back out (every
    ray is independent, so the stacked call is bit-identical)."""
    arrs = [s.arrays for s in specs if len(s.arrays) == 2]
    if len(arrs) != len(specs):
        return None
    vol = arrs[0][0]
    if (any(a[0] is not vol for a in arrs)      # memoized volume: identity
            or len({a[1].shapes for a in arrs}) != 1):
        return None
    dev = current_device()
    n_each = int(arrs[0][1].host[0].shape[0])
    n_real = len(arrs) * n_each
    rows = _ceil_pow2(n_real)
    ro = _pad_pow2_rows(torch.cat([a[1].on(dev)[0] for a in arrs]), rows)
    rd = _pad_pow2_rows(torch.cat([a[1].on(dev)[1] for a in arrs]), rows)
    vol_t = vol.on(dev)[0]
    base = specs[0]
    unit = max(n_each // max(int(base.total_units), 1), 1)
    total = len(arrs) * int(base.total_units)

    def run_share(group, start, k):
        lo = start * unit
        hi = n_real if start + k >= total else (start + k) * unit
        return _raycast_run(vol_t, ro[lo:hi], rd[lo:hi])

    spec = RequestSpec(
        # distinct calibration key: run_one computes the pow2-padded
        # ray count, so timing it against the real unit count would
        # inflate the base workload's per-unit estimate
        workload=f"{base.workload}@stack", total_units=total,
        run_one=lambda: _raycast_run(vol_t, ro, rd),
        run_share=run_share, combine=_gather,
        unit_cost=base.unit_cost, comm_cost=base.comm_cost,
        bucket=base.bucket)
    return MergedBatch(
        spec, lambda value, i: value[i * n_each:(i + 1) * n_each])


def _raycast_spec(payload: Optional[dict]) -> RequestSpec:
    p = dict(payload or {})
    n_rays = int(p.get("n_rays", 1 << 14))
    d = int(p.get("d", 32))
    seed = int(p.get("seed", 0))
    vol, rays = _raycast_volume(d, seed), _raycast_rays(n_rays, seed + 1)
    unit = max(n_rays // 64, 1)
    units = max(n_rays // unit, 1)

    def run(lo, hi):
        dev = current_device()
        ro, rd = rays.on(dev)
        return _raycast_run(vol.on(dev)[0], ro[lo:hi], rd[lo:hi])

    def run_share(group, start, k):
        lo = start * unit
        hi = n_rays if start + k >= units else (start + k) * unit
        return run(lo, hi)

    per_ray = _raycast_unit_cost()
    return RequestSpec(
        workload=f"serve-raycast/{n_rays}x{d}", total_units=units,
        run_one=lambda: run(0, n_rays),
        run_share=run_share, combine=_gather,
        unit_cost=CostTerms(flops=per_ray.flops * unit,
                            bytes=per_ray.bytes * unit),
        comm_cost=n_rays * 4 / 6e9,
        bucket=f"R{pow2_bucket(n_rays)}_D{d}",
        arrays=(vol, rays), merge=_raycast_merge)


# ---------------------------------------------------------------------------
# montecarlo — photon-migration estimator (paper §4.7); units are
# photon blocks, the request's value is the mean absorbed weight.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _mc_inputs(n_photons: int, seed: int) -> Inputs:
    from repro_torch.workloads import montecarlo as mc
    return Inputs(mc.make_stream(n_photons, seed))


def _montecarlo_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import montecarlo as mc

    p = dict(payload or {})
    n_photons = int(p.get("n_photons", 1 << 16))
    unit = max(min(int(p.get("unit", 1 << 12)), n_photons), 1)
    seed = int(p.get("seed", 42))
    units = max(n_photons // unit, 1)
    ins = _mc_inputs(n_photons, seed)

    def run_one():
        return float(mc.simulate_photons(ins.on(current_device())[0]))

    def run_share(group, start, k):
        lo = start * unit
        hi = n_photons if start + k >= units else (start + k) * unit
        u = ins.on(current_device())[0]
        return float(mc.simulate_photons(u[lo:hi])) * (hi - lo)

    return RequestSpec(
        workload=f"serve-mc/{n_photons}x{unit}", total_units=units,
        run_one=run_one, run_share=run_share,
        combine=lambda outs: float(sum(outs)) / n_photons,
        unit_cost=mc.unit_cost_terms(unit),
        comm_cost=n_photons * mc.N_STEPS * 4 / 6e9,
        bucket=f"P{pow2_bucket(n_photons)}_u{unit}")


# ---------------------------------------------------------------------------
# Iteration steppers — the sequential single-unit adapters (listrank /
# lbm / dither) as continuous-batching citizens: one pointer-jump
# round / BGK step / dither wavefront step is the engine's scheduling
# quantum, so a request becomes preemptible at every iteration boundary
# and same-shape requests stack into one batched call.  Opt-in via the
# ``continuous: True`` payload key: monolithic ``run_one`` is faster for
# a solo request, so solo-latency traffic keeps the old path; the
# engine wins when several same-shape requests are live or lane time
# must be shared at fine grain.  Steppers are memoized per shape — the
# engine is keyed by stepper instance, so every same-shape request
# stacks into one slot state.  Each row's state is built on the prefill
# lane's device; the engine's insert moves it to the decode lane's.
# ---------------------------------------------------------------------------
def _engine_slots(default: int = 4) -> int:
    try:
        return max(int(os.environ.get("REPRO_SERVE_SLOTS", default)), 1)
    except ValueError:
        return default


@functools.lru_cache(maxsize=4)
def _listrank_stepper(n: int):
    from repro_torch.serve.continuous import IterStepper
    from repro_torch.workloads import listrank as lr

    uc = lr.unit_cost_terms(n)
    steps = max(int(uc.steps), 1)

    def make_rows(spec):
        succ = spec.arrays[0].on(current_device())[0]
        rank0 = (succ != torch.arange(n, device=succ.device)).to(
            torch.int32)
        return [((succ, rank0), steps)]

    return IterStepper(
        workload=f"serve-listrank/{n}", n_slots=_engine_slots(),
        template_row=lambda dev: (
            torch.zeros((n,), dtype=torch.int64, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev)),
        # exactly ceil(log2 n) rounds equal pointer_jump_rank's loop
        # (extra rounds are idempotent: the tail self-loop fixes succ);
        # integer gathers, so any batching is exact
        iter_fn=torch.func.vmap(lambda sr: lr._one_round(sr[0], sr[1])),
        make_rows=make_rows,
        finalize=lambda row: row[1].cpu().numpy(),
        prefill_cost=CostTerms(flops=2.0 * n, bytes=8.0 * n),
        decode_cost=CostTerms(flops=uc.flops / steps,
                              bytes=uc.bytes / steps))


@functools.lru_cache(maxsize=4)
def _lbm_stepper(d: int, n_steps: int):
    from repro_torch.serve.continuous import IterStepper
    from repro_torch.workloads import lbm

    uc = lbm.unit_cost_terms(d, n_steps)

    return IterStepper(
        workload=f"serve-lbm/{d}x{n_steps}", n_slots=_engine_slots(),
        template_row=lambda dev: torch.zeros((19, d, d, d),
                                             dtype=torch.float32,
                                             device=dev),
        iter_fn=torch.func.vmap(lbm.step_all),
        make_rows=lambda spec: [
            (spec.arrays[0].on(current_device())[0], n_steps)],
        finalize=lambda row: row.clone(),
        prefill_cost=CostTerms(bytes=19.0 * 4.0 * d ** 3),
        decode_cost=CostTerms(flops=uc.flops / n_steps,
                              bytes=uc.bytes / n_steps))


@functools.lru_cache(maxsize=4)
def _dither_stepper(h: int, w: int):
    from repro_torch.serve.continuous import IterStepper
    from repro_torch.workloads import dither

    n_steps = dither.n_wavefront_steps(h, w)

    def make_rows(spec):
        img = spec.arrays[0].on(current_device())[0]
        return [(dither.wavefront_row(img), n_steps)]

    uc = dither.unit_cost_terms(h, w)
    return IterStepper(
        workload=f"serve-dither/{h}x{w}", n_slots=_engine_slots(),
        template_row=lambda dev: dither.wavefront_row(
            torch.zeros((h, w), dtype=torch.float32, device=dev)),
        # written batched: the slots sit at different wavefront steps,
        # whose pixel sets differ in size (padded to one width)
        iter_fn=lambda rows: dither.wavefront_step(rows, h, w),
        make_rows=make_rows,
        finalize=lambda row: dither.wavefront_out(row, h, w),
        prefill_cost=CostTerms(bytes=4.0 * h * w),
        decode_cost=CostTerms(flops=uc.flops / n_steps,
                              bytes=uc.bytes / n_steps))


# ---------------------------------------------------------------------------
# listrank — Wyllie pointer jumping (paper §4.8).  The rounds are
# sequential, so a request is ONE indivisible unit: placement
# co-schedules whole rankings across lanes.  ``continuous: True``
# payloads ride the step-quantum engine instead.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _listrank_inputs(n: int, seed: int) -> Inputs:
    from repro_torch.workloads import listrank as lr
    return Inputs(lr.make_list(n, seed)[0])


def _listrank_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import listrank as lr

    p = dict(payload or {})
    n = int(p.get("n", 1 << 14))
    ins = _listrank_inputs(n, int(p.get("seed", 0)))

    def run_one():
        out = lr.pointer_jump_rank(ins.on(current_device())[0])
        return out.cpu().numpy()

    return RequestSpec(
        workload=f"serve-listrank/{n}", total_units=1,
        run_one=run_one,
        run_share=lambda group, start, k: run_one(),
        combine=lambda outs: outs[0],
        unit_cost=lr.unit_cost_terms(n),
        bucket=f"N{pow2_bucket(n)}",
        arrays=(ins,),
        stepper=_listrank_stepper(n) if p.get("continuous") else None)


# ---------------------------------------------------------------------------
# concomp — the per-subgraph suitability split (paper §4.8): host BFS
# vs accel label-prop run DIFFERENT algorithms, so the prior is a
# per-group dict; subgraph shapes are data-dependent -> whole shares.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _concomp_problem(n: int, avg_deg: float, seed: int) -> Inputs:
    from repro_torch.workloads import concomp as cc
    return Inputs(*cc.make_graph(n, avg_deg, seed)[1:])


def _concomp_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import concomp as cc

    p = dict(payload or {})
    n = int(p.get("n", 1 << 12))
    avg_deg = float(p.get("avg_deg", 4.0))
    seed = int(p.get("seed", 0))
    prob = _concomp_problem(n, avg_deg, seed)

    def shared(dev):
        return prob.memo("share", dev, lambda: cc.make_share_spec(
            {"accel": dev, "host": dev}, n, avg_deg, seed))

    def run_share(group, start, k):
        return shared(current_device()).run_share(group, start, k)

    return RequestSpec(
        workload=f"serve-concomp/{n}x{avg_deg:g}", total_units=n,
        # dedicated path: the accel algorithm labels the whole graph
        run_one=lambda: run_share("accel", 0, n),
        run_share=run_share,
        combine=lambda outs: shared(current_device()).combine(outs),
        unit_cost=cc.unit_cost_terms(n, avg_deg),
        comm_cost=len(prob.host[0]) * 8 / 6e9,
        whole_shares=True,
        bucket=f"N{pow2_bucket(n)}_g{avg_deg:g}")


# ---------------------------------------------------------------------------
# lbm — D3Q19 lattice Boltzmann (paper §4.9).  Steps are sequential
# (each streams the previous state), so a request is one unit; the
# plane-split task parallelism lives inside run_hybrid.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _lbm_state(d: int, seed: int) -> Inputs:
    from repro_torch.workloads import lbm
    return Inputs(lbm.init_state(d, seed))


def _lbm_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import lbm

    p = dict(payload or {})
    d = int(p.get("d", 16))
    n_steps = max(int(p.get("n_steps", 2)), 1)
    ins = _lbm_state(d, int(p.get("seed", 0)))

    def run_one():
        cur = ins.on(current_device())[0]
        for _ in range(n_steps):
            cur = lbm.step_all(cur)
        return sync(cur)

    return RequestSpec(
        workload=f"serve-lbm/{d}x{n_steps}", total_units=1,
        run_one=run_one,
        run_share=lambda group, start, k: run_one(),
        combine=lambda outs: outs[0],
        unit_cost=lbm.unit_cost_terms(d, n_steps),
        bucket=f"D{d}_s{n_steps}",
        arrays=(ins,),
        stepper=_lbm_stepper(d, n_steps) if p.get("continuous") else None)


# ---------------------------------------------------------------------------
# dither — Floyd-Steinberg error diffusion (paper §4.10): inherently
# sequential (the paper's point), one indivisible unit per request.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _dither_inputs(h: int, w: int, seed: int) -> Inputs:
    from repro_torch.workloads import dither
    return Inputs(dither.make_image(h, w, seed))


def _dither_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import dither

    p = dict(payload or {})
    h = int(p.get("h", 128))
    w = int(p.get("w", 128))
    ins = _dither_inputs(h, w, int(p.get("seed", 0)))

    def run_one():
        return sync(dither.fsd_dither(ins.on(current_device())[0]))

    return RequestSpec(
        workload=f"serve-dither/{h}x{w}", total_units=1,
        run_one=run_one,
        run_share=lambda group, start, k: run_one(),
        combine=lambda outs: outs[0],
        unit_cost=dither.unit_cost_terms(h, w),
        bucket=f"H{pow2_bucket(h)}_W{pow2_bucket(w)}",
        arrays=(ins,),
        stepper=_dither_stepper(h, w) if p.get("continuous") else None)


# ---------------------------------------------------------------------------
# bundle — Levenberg-Marquardt task pipeline (paper §4.10): damped
# iterations are sequential, one unit per request; the value is the
# final squared residual.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _bundle_problem(n_cams: int, n_pts: int, seed: int) -> Inputs:
    from repro_torch.workloads import bundle
    return Inputs(*bundle.make_problem(n_cams, n_pts, seed))


def _bundle_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.workloads import bundle

    p = dict(payload or {})
    n_cams = int(p.get("n_cams", 4))
    n_pts = int(p.get("n_pts", 256))
    n_iters = max(int(p.get("n_iters", 3)), 1)
    ins = _bundle_problem(n_cams, n_pts, int(p.get("seed", 0)))

    def run_one():
        cams, pts, obs = ins.on(current_device())
        cur, err = cams, float("inf")
        for _ in range(n_iters):
            cur, err = bundle.lm_step(cur, pts, obs, 1e-3)
        return float(err)

    return RequestSpec(
        workload=f"serve-bundle/{n_cams}x{n_pts}", total_units=1,
        run_one=run_one,
        run_share=lambda group, start, k: run_one(),
        combine=lambda outs: outs[0],
        unit_cost=bundle.unit_cost_terms(n_cams, n_pts, n_iters),
        bucket=f"C{n_cams}_P{pow2_bucket(n_pts)}_i{n_iters}")


# ---------------------------------------------------------------------------
# bilateral — LUT bilateral filter (paper §4.6); units are output
# rows, shares carry the radius halo exactly like run_hybrid's.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _bilateral_prepared(size: int, sigma_s: float, sigma_r: float,
                        radius: int, seed: int) -> Inputs:
    from repro_torch.core.host_offload import bilateral_luts
    from repro_torch.workloads import bilateral as bl

    return Inputs(bl.make_inputs(size, seed),
                  *bilateral_luts(sigma_s, sigma_r, radius))


def _bilateral_spec(payload: Optional[dict]) -> RequestSpec:
    from repro_torch.kernels.bilateral.ops import (bilateral_filter,
                                                   tuned_config)

    p = dict(payload or {})
    size = int(p.get("size", 256))
    radius = int(p.get("radius", 7))
    ins = _bilateral_prepared(size, float(p.get("sigma_s", 3.0)),
                              float(p.get("sigma_r", 30.0)), radius,
                              int(p.get("seed", 0)))
    img_np, sp_np, rl_np = ins.host
    H, W = img_np.shape
    K = 2 * radius + 1

    def cfg(dev):
        return ins.memo("cfg", dev, lambda: tuned_config(*ins.on(dev)))

    def run_one():
        dev = current_device()
        return sync(bilateral_filter(*ins.on(dev), config=cfg(dev)))

    def run_share(group, start, n):
        dev = current_device()
        img, sp, rl = ins.on(dev)
        lo = max(0, start - radius)
        hi = min(H, start + n + radius)
        out = bilateral_filter(img[lo:hi], sp, rl, config=cfg(dev))
        return sync(out[start - lo:start - lo + n])

    return RequestSpec(
        workload=f"serve-bilat/{size}x{radius}", total_units=H,
        run_one=run_one, run_share=run_share, combine=_gather,
        unit_cost=CostTerms(flops=6.0 * W * K * K, bytes=8.0 * W * K * K),
        comm_cost=(sp_np.size + rl_np.size) * 4 / 6e9,
        bucket=f"S{pow2_bucket(size)}_r{radius}")


# ---------------------------------------------------------------------------
# serve-LM — full generate() requests (registered per arch on demand)
# ---------------------------------------------------------------------------
def params_to(params, device: torch.device):
    """A copy of a parameter tree on ``device`` (``.to``: the same
    weights, never drawn again — a CPU and a CUDA generator give
    different streams)."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params


class WeightCopies:
    """A parameter tree and one copy of it on each other device of
    ``devices``, made here, once, outside any request: each lane runs
    on its own device from that device's copy.  ``on(dev)`` raises for
    a device with no copy."""

    def __init__(self, params, devices=(), owner: str = ""):
        from repro_torch.models.param import leaves

        self.params = params
        self.owner = owner
        self._by_dev = {str(next(leaves(params)).device): params}
        for dev in devices:
            dev = torch.device(dev)
            if str(dev) not in self._by_dev:
                self._by_dev[str(dev)] = params_to(params, dev)

    @property
    def devices(self) -> List[str]:
        return list(self._by_dev)

    def on(self, dev):
        try:
            return self._by_dev[str(dev)]
        except KeyError:
            raise RuntimeError(f"{self.owner}: no copy of the weights on "
                               f"{dev} (devices=...)") from None


def make_lm_adapter(cfg, params, prompt_len: int = 16,
                    new_tokens: int = 16, name: Optional[str] = None,
                    devices=()) -> str:
    """Register a serve-LM adapter for an initialized arch and return
    its workload name.  Units are batch rows; ``run_share`` decodes a
    row slice (the §5.4.3 split ``launch/serve.py --hybrid`` uses),
    ``run_one`` decodes the whole batch.  The cost prior is the decode
    roofline: ~2 FLOPs per parameter per generated token per row.

    Each lane decodes on its own device from that device's copy of the
    weights: ``params`` serves its own device, and a copy is made here,
    once, for every other device in ``devices`` (outside any request).
    A lane whose device has no copy raises."""
    from repro_torch.models.param import count_params
    from repro_torch.serve.serve_step import generate

    wl_name = name or f"serve-lm/{cfg.name}"
    cache_len = prompt_len + new_tokens + 1
    n_params = count_params(params)
    weights = WeightCopies(params, devices, owner=wl_name).on
    unit = CostTerms(flops=2.0 * n_params * (new_tokens + 1),
                     bytes=4.0 * n_params, compute="matmul")

    def factory(payload: Optional[dict]) -> RequestSpec:
        p = dict(payload or {})
        if "prompt" in p:
            prompt = torch.as_tensor(np.asarray(p["prompt"])).long()
        else:
            gen = torch.Generator().manual_seed(int(p.get("seed", 1)))
            prompt = torch.randint(0, cfg.vocab_size,
                                   (int(p.get("batch", 2)), prompt_len),
                                   generator=gen)
        ins = Inputs(prompt)
        B = prompt.shape[0]

        def decode(lo, hi):
            dev = current_device()
            return sync(generate(cfg, weights(dev), ins.on(dev)[0][lo:hi],
                                 new_tokens, cache_len=cache_len))

        return RequestSpec(
            workload=wl_name, total_units=B,
            run_one=lambda: decode(0, B),
            run_share=lambda group, start, k: decode(start, start + k),
            combine=_gather,
            unit_cost=unit,
            bucket=f"B{pow2_bucket(B)}_P{prompt_len}_N{new_tokens}")

    register(wl_name, factory)
    return wl_name


def make_continuous_lm_adapter(cfg, params, prompt_len: int = 16,
                               new_tokens: int = 16,
                               name: Optional[str] = None,
                               n_slots: Optional[int] = None,
                               warm_background: bool = True,
                               devices=()) -> str:
    """Register a continuous-batching serve-LM adapter and return its
    workload name (default ``serve-lm-cb/{arch}``).

    Requests carry a shared :class:`repro_torch.serve.continuous.LMStepper`:
    the scheduler routes them to ONE iteration-level engine whose
    scheduling quantum is the decode step — live requests stack into a
    single slot-batched call per step, new arrivals join at step
    boundaries, finished rows demux exactly.  ``run_one`` keeps the
    monolithic solo ``generate`` as the fallback when the engine is
    disabled (``REPRO_SERVE_CONTINUOUS=0`` or fifo policy), so the
    workload stays servable either way.  ``devices`` are the other
    devices that get a copy of the weights (as ``make_lm_adapter``'s),
    made here, once.  Registration starts a background warm-up of the
    stepper's fixed slot shapes (prefill + slot step) on every device
    that holds the weights, so the first request never pays it."""
    from repro_torch.serve.continuous import LMStepper
    from repro_torch.serve.serve_step import generate

    wl_name = name or f"serve-lm-cb/{cfg.name}"
    cache_len = prompt_len + new_tokens + 1
    stepper = LMStepper(cfg, params, prompt_len=prompt_len,
                        new_tokens=new_tokens, cache_len=cache_len,
                        n_slots=n_slots or _engine_slots(),
                        workload=wl_name, devices=devices)
    unit = CostTerms(flops=2.0 * stepper.n_params * (new_tokens + 1),
                     bytes=4.0 * stepper.n_params, compute="matmul")

    def factory(payload: Optional[dict]) -> RequestSpec:
        p = dict(payload or {})
        if "prompt" in p:
            prompt = torch.as_tensor(np.asarray(p["prompt"])).long()
        else:
            gen = torch.Generator().manual_seed(int(p.get("seed", 1)))
            prompt = torch.randint(0, cfg.vocab_size,
                                   (int(p.get("batch", 1)), prompt_len),
                                   generator=gen)
        ins = Inputs(prompt)
        B = prompt.shape[0]

        def run_one():
            dev = current_device()
            return sync(generate(cfg, stepper.weights(dev), ins.on(dev)[0],
                                 new_tokens, cache_len=cache_len))

        return RequestSpec(
            workload=wl_name, total_units=B,
            run_one=run_one,
            run_share=lambda group, start, k: run_one(),
            combine=lambda outs: outs[0],
            unit_cost=unit,
            bucket=f"B{pow2_bucket(B)}_P{prompt_len}_N{new_tokens}",
            arrays=(ins,), stepper=stepper)

    register(wl_name, factory)
    if warm_background:
        _spawn_precompile(stepper.warm, tag=wl_name)
    return wl_name


# ---------------------------------------------------------------------------
# Registry-level precompile: merged-stack pow2 shapes + stepper
# programs, run once ahead of traffic (optionally in the background at
# adapter-registration time).  Merged executions run pow2-padded
# stacks, and each padded shape pays its first use (kernel builds, the
# caching allocator's growth) once per (shape, device) — enough to
# cascade an open-loop backlog when it lands mid-trace.
# ---------------------------------------------------------------------------
_PRECOMPILE_THREADS: List[threading.Thread] = []
_PRECOMPILE_LOCK = threading.Lock()


def _spawn_precompile(fn: Callable[[], None], tag: str = "") -> None:
    """Run ``fn`` on a daemon thread named ``precompile-*`` (NEVER
    ``serve-*``: test teardown asserts those are all joined) and track
    it so ``wait_precompiled`` can rendezvous."""
    def work():
        try:
            fn()
        except Exception:
            pass  # precompile is best-effort; traffic just pays it later

    t = threading.Thread(target=work, daemon=True,
                         name=f"precompile-{tag or len(_PRECOMPILE_THREADS)}")
    with _PRECOMPILE_LOCK:
        _PRECOMPILE_THREADS.append(t)
    t.start()


def wait_precompiled(timeout: Optional[float] = None) -> bool:
    """Join all background precompile threads; True if all finished."""
    import time

    deadline = None if timeout is None else time.monotonic() + timeout
    with _PRECOMPILE_LOCK:
        threads = list(_PRECOMPILE_THREADS)
    for t in threads:
        left = (None if deadline is None
                else max(deadline - time.monotonic(), 0.0))
        t.join(timeout=left)
        if t.is_alive():
            return False
    return True


def precompile_merged(mix, max_batch: int = 8, background: bool = False,
                      devices=None) -> None:
    """Run the merged-stack pow2 shapes (k in 2, 4, ``max_batch``) and
    any continuous-engine stepper programs once for every workload in
    ``mix`` (a list of ``(workload, payload)`` pairs), on every device
    (default: the detected pair's, or the CPU without a GPU) —
    scheduler-driven warm bursts can't guarantee lane coverage because
    placement keeps picking the same idle lane.  First-use cost is a
    property of the process, not of the policy under test.  With
    ``background=True`` this returns immediately; rendezvous via
    ``wait_precompiled``."""
    def work():
        if devices is not None:
            devs = [torch.device(d) for d in devices]
        elif torch.cuda.is_available():
            devs = [torch.device("cuda", 0), torch.device("cpu")]
        else:
            devs = [torch.device("cpu")]
        warmed = set()
        for wl, payload in mix:
            try:
                probe = make_request(wl, payload)
            except Exception:
                continue
            stepper = getattr(probe, "stepper", None)
            if stepper is not None and id(stepper) not in warmed:
                warmed.add(id(stepper))
                for dev in devs:
                    try:
                        with lane_device(dev):
                            stepper.warm()
                    except Exception:
                        pass
            if getattr(probe, "merge", None) is None:
                continue
            for k in (2, 4, max_batch):
                try:
                    merged = probe.merge(
                        [make_request(wl, payload) for _ in range(k)])
                except Exception:
                    continue
                if merged is None:
                    continue
                for dev in devs:
                    with lane_device(dev):
                        merged.spec.run_one()

    if background:
        _spawn_precompile(work, tag="merged")
    else:
        work()


def _ensure_defaults() -> None:
    if "conv" in _REGISTRY:
        return
    # every ALL_WORKLOADS entry (the paper's 13 Table-1 workloads) ...
    register("conv", _conv_spec)
    register("hist", _hist_spec)
    register("spmv", _spmv_spec)
    register("sort", _sort_spec)
    register("spgemm", _spgemm_spec)
    register("raycast", _raycast_spec)
    register("bilateral", _bilateral_spec)
    register("montecarlo", _montecarlo_spec)
    register("listrank", _listrank_spec)
    register("concomp", _concomp_spec)
    register("lbm", _lbm_spec)
    register("dither", _dither_spec)
    register("bundle", _bundle_spec)
    # ... plus the serving-only kernels
    register("attention", _attention_spec)
