"""Kernel autotuning: measured search over per-kernel config spaces.

The paper's methodological core (vs Lee et al., ISCA 2010) is that a
platform comparison is only meaningful when each kernel is *tuned to
its platform*.  This module is the port's measured-search layer
beneath the scheduler: every kernel package exposes a small config
space (the hand-written CUDA kernel's C entries and launch parameters,
and the reference's native candidates as PyTorch calls) and
``autotune`` picks the best-measured candidate per (kernel, backend,
shape bucket).

A copy of the reference's ``kernels/autotune.py`` adapted to PyTorch:

* the backend is the input tensor's device kind (``torch:cuda`` or
  ``torch:cpu``: ``core.cost_model.backend_key``), never a JAX
  backend, so one tune file can serve both packages and neither reads
  the other's entries;
* ``default_config`` picks from the device: the hand-written kernel's
  config on a CUDA tensor (turning the *search* off never swaps the
  platform's implementation), the op's CPU peer on a CPU tensor;
* the cost-model ranking prices a candidate on the device it runs on
  (``cost_model.get_profile(device)``);
* on a CUDA device a hand-written kernel's candidate (``impl: "cuda"``)
  that raises stops the search with its error: only native candidates
  are skipped when they fail, so a kernel that does not build or launch
  is never tuned away in favour of a plain PyTorch call.

The store is ``core.persist.JsonStore`` with the reference's layout,
``{backend: {kernel: {bucket: {"config", "us", "via"?}}}}``.

Escape hatches (the reference's knobs, ``docs/KNOBS.md``):

* ``REPRO_AUTOTUNE=0``        — disable search, use each kernel's default
* ``REPRO_TUNE_CACHE=<path>`` — cache file location
  (default ``~/.cache/repro/autotune.json``)
* ``REPRO_TUNE_PIN_<KERNEL>='{"impl": ..., ...}'`` — pin one kernel's
  config (merged over its default; no search, no cache)
* ``REPRO_TUNE_TOPK=<n>``     — measured candidates per search (default
  2, every impl family's best always included; 0 = measure everything)
* ``REPRO_TUNE_TRANSFER=0``   — disable cross-shape transfer seeding
* ``REPRO_COST_MODEL=0``      — disable the model entirely (full
  search, no ranking; see core/cost_model.py)

Timing uses ``core.calibration.measure`` (it synchronises the device of
every tensor the candidate returns; min of 2 after a warmup); tests
inject a deterministic timer via ``set_timer``.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import backend_key
from repro_torch.core.persist import JsonStore

Config = Dict[str, Any]
Timer = Callable[[Callable[[], Any]], float]
CostFn = Callable[[Config], Any]          # -> core.cost_model.CostTerms

ENV_DISABLE = "REPRO_AUTOTUNE"
ENV_CACHE = "REPRO_TUNE_CACHE"
ENV_PIN_PREFIX = "REPRO_TUNE_PIN_"
ENV_TOPK = "REPRO_TUNE_TOPK"
ENV_TRANSFER = "REPRO_TUNE_TRANSFER"
# family coverage is the floor, not the slot count: every impl
# family's best-predicted member is always measured (see
# _select_top_k), so K=2 means "family bests, plus a spare slot when
# there are fewer than 2 families"
DEFAULT_TOPK = 2


def default_cache_path() -> str:
    return os.environ.get(ENV_CACHE) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "autotune.json")


def bucket(n: int) -> int:
    """Shape bucket: next power of two (so nearby shapes share a tune)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def freeze(config: Config) -> Tuple[Tuple[str, Any], ...]:
    """Hashable view of a config."""
    return tuple(sorted(config.items()))


def thaw(frozen: Sequence[Tuple[str, Any]]) -> Config:
    return dict(frozen)


class TuneCache:
    """Persistent (kernel, backend, shape-bucket) -> config store.

    Layout mirrors the JSON file:
    ``{backend: {kernel: {bucket: {"config": {...}, "us": float}}}}``
    (transfer-seeded entries also carry ``"via": "transfer:<bucket>"``).
    Persistence (lazy load, merge-on-write, atomic replace,
    corrupt-file tolerance) comes from ``core.persist.JsonStore``."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._disk = JsonStore(self.path)

    def get(self, backend: str, kernel: str, shape_bucket: str
            ) -> Optional[dict]:
        with self._disk.lock:
            entry = (self._disk.data().get(backend, {}).get(kernel, {})
                     .get(shape_bucket))
            return dict(entry) if isinstance(entry, dict) else None

    def buckets(self, backend: str, kernel: str) -> Dict[str, dict]:
        """All tuned buckets for (backend, kernel) — transfer seeding."""
        with self._disk.lock:
            buckets = self._disk.data().get(backend, {}).get(kernel, {})
            return {b: dict(e) for b, e in buckets.items()
                    if isinstance(e, dict) and isinstance(
                        e.get("config"), dict)}

    def put(self, backend: str, kernel: str, shape_bucket: str,
            config: Config, us: float, via: Optional[str] = None) -> None:
        entry = {"config": dict(config), "us": round(float(us), 3)}
        if via:
            entry["via"] = via
        with self._disk.lock:
            self._disk.data().setdefault(backend, {}).setdefault(
                kernel, {})[shape_bucket] = entry
            self._disk.flush()

    def clear(self) -> None:
        self._disk.clear()


_GLOBAL: Optional[TuneCache] = None
_GLOBAL_PATH: Optional[str] = None
_CACHE_LOCK = threading.Lock()


def get_tune_cache() -> TuneCache:
    """Process-wide cache; re-resolved when REPRO_TUNE_CACHE changes
    (tests point it at tmp dirs)."""
    global _GLOBAL, _GLOBAL_PATH
    path = default_cache_path()
    with _CACHE_LOCK:
        if _GLOBAL is None or _GLOBAL_PATH != path:
            _GLOBAL = TuneCache(path)
            _GLOBAL_PATH = path
        return _GLOBAL


def reset_tune_cache() -> None:
    global _GLOBAL, _GLOBAL_PATH
    with _CACHE_LOCK:
        _GLOBAL = None
        _GLOBAL_PATH = None


_TIMER_OVERRIDE: Optional[Timer] = None


def set_timer(timer: Optional[Timer]) -> Optional[Timer]:
    """Install a timer (seconds per call) for the search; returns the
    previous override so tests can restore it."""
    global _TIMER_OVERRIDE
    prev = _TIMER_OVERRIDE
    _TIMER_OVERRIDE = timer
    return prev


def _default_timer(fn: Callable[[], Any]) -> float:
    from repro_torch.core.calibration import measure
    return measure(fn, warmup=1, iters=2, reduce="min")


def default_config(seed: Config, safe: Config, device=None) -> Config:
    """The no-search config (REPRO_AUTOTUNE=0 / all candidates failed):
    the hand-written CUDA kernel on a CUDA device — disabling *search*
    must not silently swap the platform implementation — and the CPU
    peer the op runs on a CPU tensor."""
    if torch.device(device or "cpu").type == "cuda":
        return dict(seed)
    return dict(safe)


def search_enabled() -> bool:
    return os.environ.get(ENV_DISABLE, "1").lower() not in (
        "0", "off", "false", "no")


def top_k() -> int:
    """Measured candidates per search; 0 = full (unranked) search."""
    try:
        return max(int(os.environ.get(ENV_TOPK, DEFAULT_TOPK)), 0)
    except ValueError:
        return DEFAULT_TOPK


def transfer_enabled() -> bool:
    return os.environ.get(ENV_TRANSFER, "1").lower() not in (
        "0", "off", "false", "no")


def pinned_config(kernel: str) -> Optional[Config]:
    raw = os.environ.get(ENV_PIN_PREFIX + kernel.upper().replace("-", "_"))
    if not raw:
        return None
    try:
        cfg = json.loads(raw)
        return cfg if isinstance(cfg, dict) else None
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# Cost-model ranking + cross-shape transfer
# ---------------------------------------------------------------------------
_BUCKET_SEG = re.compile(r"([A-Za-z]+)(\d+)")


def _bucket_dims(bucket: str) -> Dict[str, int]:
    return {m.group(1): int(m.group(2))
            for m in _BUCKET_SEG.finditer(bucket)}


def nearest_bucket(buckets: Dict[str, dict], target: str
                   ) -> Optional[Tuple[str, dict]]:
    """Closest tuned bucket to ``target`` by log-space shape distance
    (buckets are pow-2, so log2 deltas count bucket hops).  Only
    buckets with the same dimension names are comparable, and a
    0-vs-1 mismatch is a *boolean flag* (e.g. attention's causal bit),
    not a size hop: those variants have different candidate spaces and
    non-transferable winners, so they never seed each other."""
    tgt = _bucket_dims(target)
    if not tgt:
        return None
    best = None
    for b, entry in buckets.items():
        if b == target:
            continue
        dims = _bucket_dims(b)
        if set(dims) != set(tgt):
            continue
        if any(dims[k] != tgt[k] and dims[k] <= 1 and tgt[k] <= 1
               for k in tgt):
            continue
        d = sum(abs(math.log2(dims[k] + 1) - math.log2(tgt[k] + 1))
                for k in tgt)
        if best is None or d < best[0]:
            best = (d, b, entry)
    return (best[1], best[2]) if best else None


def _select_top_k(cands: List[Config], predict, k: int) -> List[Config]:
    """The model's K best candidates — but every implementation
    family's best-predicted member is always included (the model ranks
    *within* a family far better than across families; coverage is
    what keeps the true winner measurable), so the result can exceed
    ``k`` when there are more families than slots."""
    scored = []
    for i, c in enumerate(cands):
        try:
            s = float(predict(c))
        except Exception:
            s = math.inf
        scored.append((s, i, c))
    scored.sort(key=lambda x: (x[0], x[1]))
    chosen_idx: List[int] = []
    seen_fam = set()
    for s, i, c in scored:
        fam = c.get("impl", "?")
        if fam not in seen_fam:
            seen_fam.add(fam)
            chosen_idx.append(i)
    for s, i, c in scored:
        if len(chosen_idx) >= max(k, len(seen_fam)):
            break
        if i not in chosen_idx:
            chosen_idx.append(i)
    return [cands[i] for i in chosen_idx]


def _make_predict(cost_fn: Optional[CostFn], device=None):
    """Config -> predicted seconds on ``device``, or None when the
    model is off."""
    if cost_fn is None:
        return None
    from repro_torch.core import cost_model
    if not cost_model.enabled():
        return None
    try:
        profile = cost_model.get_profile(device or "cpu")
    except Exception:
        return None
    return lambda cfg: profile.predict(cost_fn(cfg))


def _is_kernel(cfg: Config, device) -> bool:
    """A hand-written kernel's candidate on a CUDA device: its failure
    is the kernel's fault, and the search must not hide it."""
    return cfg.get("impl") == "cuda" and \
        torch.device(device or "cpu").type == "cuda"


def autotune(kernel: str, shape_bucket: str, candidates: Sequence[Config],
             make_fn: Callable[[Config], Callable[[], Any]],
             default: Config, *, timer: Optional[Timer] = None,
             cost_fn: Optional[CostFn] = None, device=None) -> Config:
    """Best-measured config for (kernel, backend of ``device``,
    shape_bucket).

    Zero-search paths, in priority order: pinned via env, search
    disabled via env, cache hit (memory or disk).  A miss with a
    *sibling* tuned bucket present seeds by cross-shape transfer: the
    nearest bucket's winner is measured once and adopted (unless the
    cost model says it is a bad fit for this shape — >2x the best
    predicted candidate of its family — in which case the search runs).
    Otherwise candidates (merged over ``default``) are built with
    ``make_fn`` and timed — all of them, or only the model's top-K when
    a ``cost_fn`` is supplied (see ``_select_top_k``).  Failing native
    candidates are skipped; a failing kernel candidate on a CUDA device
    raises (``_is_kernel``).  The winner persists to the tune cache."""
    default = dict(default)
    pin = pinned_config(kernel)
    if pin is not None:
        return {**default, **pin}
    if not search_enabled():
        return default

    backend = backend_key(device or "cpu")
    cache = get_tune_cache()
    hit = cache.get(backend, kernel, shape_bucket)
    if hit is not None and isinstance(hit.get("config"), dict):
        return {**default, **hit["config"]}

    tmr = timer or _TIMER_OVERRIDE or _default_timer
    merged = [{**default, **c} for c in candidates]
    predict = _make_predict(cost_fn, device)

    if transfer_enabled():
        near = nearest_bucket(cache.buckets(backend, kernel), shape_bucket)
        if near is not None:
            near_bkt, near_entry = near
            t_cfg = {**default, **near_entry["config"]}
            fit = True
            if predict is not None and merged:
                # shape-fit guard, within the transferred config's own
                # impl family (cross-family predictions are where the
                # model is weakest)
                fam = t_cfg.get("impl")
                pool = [c for c in merged
                        if c.get("impl") == fam] or merged
                try:
                    best_pred = min(predict(c) for c in pool)
                    fit = predict(t_cfg) <= 2.0 * best_pred
                except Exception:
                    fit = True
            if fit:
                try:
                    t = tmr(make_fn(dict(t_cfg)))
                    cache.put(backend, kernel, shape_bucket, t_cfg,
                              t * 1e6, via=f"transfer:{near_bkt}")
                    return t_cfg
                except Exception:
                    if _is_kernel(t_cfg, device):
                        raise
                    # bad native seed: fall back to search

    k = top_k()
    if predict is not None and k > 0 and len(merged) > k:
        merged = _select_top_k(merged, predict, k)

    best_cfg: Config = default
    best_t = math.inf
    for cfg in merged:
        try:
            t = tmr(make_fn(cfg))
        except Exception:
            if _is_kernel(cfg, device):
                raise
            continue
        if t < best_t:
            best_t, best_cfg = t, cfg
    if not math.isfinite(best_t):
        # every candidate failed: fall back to the default, don't cache
        return default
    cache.put(backend, kernel, shape_bucket, best_cfg, best_t * 1e6)
    return best_cfg


def cached_or_default(kernel: str, shape_bucket: str, default: Config,
                      device=None) -> Config:
    """Zero-search config resolution: pin > search disabled (the
    default) > cache hit under ``device``'s backend key > default.

    Never times anything: the model layers (``models.attention``,
    ``models.moe``) resolve their configs this way on every call; the
    tune file is filled by the kernels' own entries, which search."""
    default = dict(default)
    pin = pinned_config(kernel)
    if pin is not None:
        return {**default, **pin}
    if not search_enabled():
        return default
    hit = get_tune_cache().get(backend_key(device or "cpu"), kernel,
                               shape_bucket)
    if hit is not None and isinstance(hit.get("config"), dict):
        return {**default, **hit["config"]}
    return default


def tuned_entry(kernel: str, shape_bucket: str, device=None
                ) -> Optional[dict]:
    """Cache entry (config + measured us) if present — benchmark
    reporting helper; never triggers a search."""
    return get_tune_cache().get(backend_key(device or "cpu"), kernel,
                               shape_bucket)
