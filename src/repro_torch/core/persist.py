"""Atomic, corrupt-tolerant JSON persistence shared by the calibration
cache and the hardware-profile store (and, once autotuning is ported,
the tune cache).

Every store follows the same contract:

* lazy load — the file is read once, on first access;
* merge-on-write — concurrent processes each own *different* leaf
  entries (different kernels, workloads, backends), so ``flush``
  re-reads the file and fills in any entries the in-memory view is
  missing before the atomic write; a blind write-back would drop a
  sibling process's entries (lost update).  In-memory values win.
* atomic replace — tmp file + ``os.replace``; a reader never sees a
  half-written file;
* graceful degradation — a corrupt or unwritable file means in-memory
  operation, never an exception (the next successful flush repairs it).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

ENV_CALIB_CACHE = "REPRO_CALIB_CACHE"


def default_calib_path() -> Optional[str]:
    """Calibration/hardware store location; ``REPRO_CALIB_CACHE``
    overrides, and the values 0/off/none disable persistence
    entirely (memory-only operation)."""
    raw = os.environ.get(ENV_CALIB_CACHE)
    if raw is not None and raw.strip().lower() in ("", "0", "off", "none"):
        return None
    return raw or os.path.join(os.path.expanduser("~"), ".cache", "repro",
                               "calibration.json")


def _is_leaf(d: dict) -> bool:
    """A leaf *entry* (tune-cache winner, calibration unit-time,
    hardware profile) holds at least one non-dict value; the levels
    above it (backend -> kernel -> bucket) hold only dicts."""
    return any(not isinstance(v, dict) for v in d.values())


def fill_missing(mine: dict, theirs: dict) -> None:
    """Copy entries from ``theirs`` that ``mine`` lacks, recursing only
    through the *grouping* levels.  A leaf entry present in ``mine``
    wins WHOLESALE — merging field-by-field would resurrect stale
    sub-keys (e.g. a "via" transfer tag, or a dropped profile field)
    from disk into a freshly rewritten entry."""
    for k, v in theirs.items():
        cur = mine.get(k)
        if k not in mine:
            mine[k] = v
        elif (isinstance(cur, dict) and isinstance(v, dict)
                and not _is_leaf(cur)):
            fill_missing(cur, v)


class JsonStore:
    """Nested-dict JSON file with the load/merge/atomic-write contract
    above.  ``path=None`` (or falsy) means memory-only."""

    def __init__(self, path: Optional[str]):
        self.path = path or None
        self._mem: dict = {}
        self._loaded = False
        self.lock = threading.RLock()

    def _read_disk(self) -> dict:
        if not self.path:
            return {}
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def data(self) -> dict:
        """The live in-memory view (file loaded on first call).
        Callers that mutate it across statements should hold ``lock``."""
        with self.lock:
            if not self._loaded:
                self._loaded = True
                self._mem = self._read_disk()
            return self._mem

    def flush(self) -> None:
        """Merge-on-write persist of the in-memory view."""
        with self.lock:
            self.data()
            if not self.path:
                return
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                fill_missing(self._mem, self._read_disk())
                tmp = f"{self.path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(self._mem, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass

    def clear(self, section: Optional[str] = None) -> None:
        """Drop everything (or one top-level section), memory and disk.
        A section clear first merges the current disk state in (other
        sections may have been written by a SIBLING JsonStore on the
        same file — e.g. the hardware profile next to the calibration
        unit times — and must survive), then pops the section and
        rewrites without re-merging it, so the cleared section cannot
        resurrect from disk on the next load."""
        with self.lock:
            if section is None:
                self._mem = {}
                self._loaded = True
                if self.path:
                    try:
                        os.remove(self.path)
                    except OSError:
                        pass
                return
            mem = self.data()
            fill_missing(mem, self._read_disk())
            mem.pop(section, None)
            if not self.path:
                return
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                tmp = f"{self.path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(mem, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass
