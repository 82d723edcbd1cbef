"""Sharded, async, atomic checkpointing with restart.

Layout:  <dir>/step_<n>/<leaf-path>.npy + manifest.json, committed by an
atomic rename of the temp directory (a crash mid-save can never corrupt
the latest checkpoint).  Saves run as a host task (paper-style task
parallelism: serialization overlaps the next training steps).

The reference's format: a leaf's path joins its dict keys and its list
indices (``[i]``) with ``/``, in the reference's leaf order
(``core.tree``).  So either package restores the other's checkpoint of
a tree of the same structure with f32 or int leaves.  Two things do not
cross over:

  * model state: the reference stacks its layer groups on a leading
    axis (``stack/groups/<leaf>``), the port keeps a list of per-group
    trees (``stack/groups/[i]/<leaf>``), so a reference checkpoint of
    parameters restored into the port's tree raises ``KeyError`` naming
    the first per-group leaf it lacks;
  * bf16 leaves: numpy has no bf16, so a bf16 leaf is stored as its
    ``uint16`` bits with ``"dtype": "bfloat16"`` in the manifest.  The
    port restores it bit for bit; the reference reads no manifest type
    and restores those ``uint16`` bits as numbers.

At 1000-node scale each host writes only the shards it owns; here the
single host writes everything, but the manifest already records per-leaf
shapes/dtypes so a resharded restore (elastic scaling) can validate.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path, unflatten

BF16 = "bfloat16"


def _path_str(p) -> str:
    return f"[{p}]" if isinstance(p, int) else str(p)


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [("/".join(_path_str(p) for p in path), leaf)
            for path, leaf in flatten_with_path(tree)]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16), BF16
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str,
                like: torch.Tensor) -> torch.Tensor:
    """The stored array on ``like``'s device, in its dtype."""
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending: Optional[Future] = None
        self.async_save = async_save

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> Optional[Future]:
        """state: a tree of dicts and lists of tensors (params,
        opt_state, step, ...)."""
        # snapshot to host memory synchronously (a copy that later
        # in-place updates cannot reach), write async
        flat = [(k, v.detach().to("cpu", copy=True))
                for k, v in _flatten(state)]

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for key, leaf in flat:
                arr, dtype = _to_numpy(leaf)
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic commit
            self._gc()
            return final

        if self.async_save:
            if self._pending is not None:
                self._pending.result()   # one in flight at a time
            self._pending = self._pool.submit(write)
            return self._pending
        write()
        return None

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):   # only committed ckpts
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, state_like: Dict[str, Any],
                step: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
        """Restore into the structure of ``state_like``: each leaf on the
        device and in the dtype of ``state_like``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for key, like in _flatten(state_like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(os.path.join(path, meta["file"]))
            want = tuple(like.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs {want} "
                    "(elastic reshape requires explicit reshard)")
            leaves.append(_from_numpy(arr, meta["dtype"], like))
        return unflatten(state_like, leaves), step

    def _gc(self):
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
