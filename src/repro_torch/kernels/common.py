"""Shared kernel utilities: device resolution, synchronisation, and the
hand-written CUDA kernel library.

The reference resolves Pallas interpret mode here; the port resolves
*devices* instead.  Every entry point runs on the GPU unless the
caller asks for the CPU, and a kernel wrapper picks its implementation
from the device of the tensor it is given:

* a CUDA tensor launches the hand-written kernel from ``csrc/`` (or
  raises — there is no fallback);
* a CPU tensor runs the CPU peer the reference itself lists as a
  candidate (the paper's host lane).

``kernel_lib()`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) with
``nvcc`` into a plain-C shared library at first use — one ``nvcc`` per
source, started together, then one link — under ``build/`` beside this
package (keyed by a digest of the flags, the sources and the shared
``csrc/*.cuh`` headers, so an edited source or header rebuilds), and
loads it with ctypes.  The library links only the CUDA runtime: the
tensor-core kernels encode their TMA tensor maps with
``cuTensorMapEncodeTiled``, which they look up through the runtime.  Each launch goes through
``launch``, which passes PyTorch's current stream, raises on the
kernel's ``cudaGetLastError()`` code and adds one to the kernel's
launch count and to its C entry point's.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _ULL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_ulonglong, ctypes.c_float)
# C entry points of csrc/*.cu: argument types (the trailing stream is a
# pointer too); every one returns cudaGetLastError() as an int
_SIGNATURES = {
    "conv2d_f32": [_P, _P, _P, _I, _I, _I, _P],
    "conv2d_reg_f32": [_P, _P, _P, _I, _I, _I, _P],
    "hist_i32": [_P, _LL, _I, _I, _P, _P],
    "hist_priv_i32": [_P, _LL, _I, _I, _P, _P, _ULL, _P],
    "spmv_ell_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "spmv_ell_seg_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "probe_add_one_f32": [_P, _P, _I, _P],
    "probe_add_one_vec_f32": [_P, _P, _I, _P],
    "launch_floor_noop": [_P],
    "sort_rows_reg_f32": [_P, _P, _LL, _I, _P],
    "bilateral_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bilateral_reg_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bilateral_level_index_check": [_ULL, _ULL, _I, _P, _P],
    "flash_attention_fma_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                _P],
    "flash_attention_fma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _P],
    "flash_attention_wgmma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _I, _P],
    "gmm_fma_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gmm_fma_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gmm_wgmma_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_BUILD_LOG = ""

LAUNCHES: Dict[str, int] = {"conv2d": 0, "hist": 0, "spmv_ell": 0,
                            "probe_add_one": 0, "sort_bitonic": 0,
                            "bilateral": 0, "flash_attention": 0, "gmm": 0}
# the same launches by C entry point, which tells a kernel's routes apart
ENTRY_LAUNCHES: Dict[str, int] = {name: 0 for name in _SIGNATURES}
_COUNT_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------
def resolve_device(device=None) -> torch.device:
    """``None`` -> the first GPU; raises when there is none (ask for
    ``"cpu"`` explicitly to run on the host)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda", 0)


_LANE = threading.local()


@contextmanager
def lane_device(device):
    """Make ``device`` the calling thread's lane device for the block.

    A serving request's ``run_one()`` / ``run_share()`` take no device:
    they read ``current_device()``, which the thread that runs them set
    (a scheduler lane, an executor's group worker).  Torch tensors do
    not follow a default device the way uncommitted JAX arrays follow
    ``jax.default_device``, so the lane says where to compute."""
    prev = getattr(_LANE, "device", None)
    _LANE.device = torch.device(device)
    try:
        yield
    finally:
        _LANE.device = prev


def current_device() -> torch.device:
    """The calling thread's lane device; outside any lane, the first
    GPU (raises when there is none)."""
    dev = getattr(_LANE, "device", None)
    return dev if dev is not None else resolve_device(None)


def to_device(arrays, device=None):
    """Copy numpy input(s) onto ``device`` (default: the GPU) and wait
    for the copies — set-up, kept out of every timed path.  One array ->
    one tensor; a sequence -> a tuple."""
    dev = resolve_device(device)
    if isinstance(arrays, np.ndarray):
        out = torch.tensor(arrays, device=dev)
    else:
        out = tuple(torch.tensor(a, device=dev) for a in arrays)
    sync_device(dev)
    return out


def sync_device(device: torch.device) -> None:
    """Wait for the current stream of ``device`` (no-op on the CPU,
    whose operators return when done)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def sync(obj) -> object:
    """Wait for every CUDA tensor in ``obj`` (a tensor, or tuples/lists
    holding them) — PyTorch's counterpart of ``block_until_ready``."""
    devs = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                devs.add(o.device)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    walk(obj)
    for d in devs:
        sync_device(d)
    return obj


# ---------------------------------------------------------------------------
# the CUDA kernel library
# ---------------------------------------------------------------------------
def find_nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources() -> List[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(srcs: List[str]) -> str:
    """Key of a build: the flags, every source and every shared header
    under ``csrc/`` (an edited ``*.cuh`` rebuilds too)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for s in sorted(set(srcs) | set(headers)):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return h.hexdigest()[:16]


def _build(srcs: List[str], out_dir: str, so_path: str) -> str:
    """One ``nvcc -c`` per source, all started together, then one link;
    returns ptxas's register/shared-memory report."""
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    objs, procs = [], []
    for s in srcs:
        obj = os.path.join(out_dir,
                           os.path.basename(s).replace(".cu", ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", s, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        log.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{so_path}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    report = "".join(log)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(report)
    os.replace(tmp, so_path)
    return report


def kernel_lib() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library; raises when
    ``nvcc`` is missing or the build fails.

    Safe across processes: the check-and-build runs under an exclusive
    ``flock`` on ``<BUILD_DIR>/<digest>.lock``, so processes that start
    on one fresh checkout together (a fleet's workers) build once; the
    others wait, then find the finished ``.so`` and only load it."""
    global _LIB, _BUILD_LOG
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        digest = _digest(srcs)
        out_dir = os.path.join(BUILD_DIR, digest)
        so_path = os.path.join(out_dir, "libkernels.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f"{digest}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.isfile(so_path):
                log_path = os.path.join(out_dir, "ptxas.log")
                if os.path.isfile(log_path):
                    with open(log_path) as f:
                        _BUILD_LOG = f.read()
            else:
                _BUILD_LOG = _build(srcs, out_dir, so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def build_log() -> str:
    """ptxas's report from the build that produced the loaded library."""
    return _BUILD_LOG


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Launch C entry point ``entry`` on ``device``'s current stream,
    raise on its error code, and count one launch of ``kernel``."""
    lib = _LIB or kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
        ENTRY_LAUNCHES[entry] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, ENTRY_LAUNCHES):
            for k in counts:
                counts[k] = 0


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def entry_counts() -> Dict[str, int]:
    """Launches by C entry point since the last ``reset_launches``."""
    with _COUNT_LOCK:
        return dict(ENTRY_LAUNCHES)


def differentiated(*tensors) -> bool:
    """Autograd records an op on these tensors: grad mode is on and one
    of them requires grad.  K7 and K8 define no backward, so a call that
    autograd records takes a differentiable formulation."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes=None) -> torch.device:
    """Validate kernel inputs before their pointers leave Python: all
    on one CUDA device, contiguous, and of the expected dtypes."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: input {i} is on {t.device}, "
                             f"expected one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: input {i} has dtype {t.dtype}, "
                             f"expected {dtypes[i]}")
    return dev
