"""Device meshes: the host mesh over the real devices and the production
mesh over a fake process group.

FUNCTIONS (not module-level constants), so importing this module never
touches a process group.  A process has one default process group at a
time: each function here says what it initialises, and ``release()``
destroys a group this module made.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels.common import resolve_device

_MADE = {"group": False}


def _init_one_rank(device: torch.device) -> None:
    """The default group of a single-rank world in this process: nccl on
    a GPU, gloo on the CPU, over an in-memory store (no rendezvous)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    _MADE["group"] = True


def make_host_mesh(model: int = 1, device=None):
    """A ``(n // model, model)`` mesh, axes ``("data", "model")``, over
    the world's ranks, one device a rank: cuda:0 (default) or the CPU
    (``device="cpu"``).

    Without a default process group it initialises one of a single rank
    in this process (``n = 1``; ``release()`` destroys it).  Inside an
    initialised group (processes started with ``init_process_group``)
    ``n`` is its world size and each rank brings its own device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _init_one_rank(dev)
    n = dist.get_world_size()
    model = min(model, n)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh, ``(16, 16)`` as ``("data", "model")`` or
    ``(2, 16, 16)`` as ``("pod", "data", "model")``, over a fake process
    group of world size 256 or 512 in this one process: rank 0 of a
    world whose collectives do nothing (the counterpart of the
    reference's host platform forced to that many devices).  It
    initialises that group as the default one; ``release()`` destroys
    it.  Raises if a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized():
        raise RuntimeError("make_production_mesh: a default process group "
                           "exists; release it first")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    _MADE["group"] = True
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def release() -> None:
    """Destroy the default process group if this module initialised it."""
    if _MADE["group"] and dist.is_initialized():
        dist.destroy_process_group()
    _MADE["group"] = False
