"""Analytic per-kernel cost model over a measured-per-device
``HardwareProfile``.

The paper derives CPU/GPU work shares "empirically by studying the time
taken by the CPU and the GPU individually" (§4.5).  This module supplies
the *model* side of a model-then-measure loop, so a first-ever hybrid
call plans without probe runs:

* ``HardwareProfile`` — contraction FLOP rate, streaming element-op
  rate, memory bandwidth, dispatch overhead and host-transfer
  bandwidth, measured once per device kind (``torch:cuda``,
  ``torch:cpu``) with ~100 ms of micro-probes and persisted in the
  calibration store (``REPRO_CALIB_CACHE``).
* ``CostTerms`` — per-unit analytic work terms (flops, bytes moved,
  launches, host traffic) that each workload derives from its shape.
* ``predict`` — roofline-style time estimate that seeds work-share
  plans before any probe has run (``HybridExecutor.calibrate(
  unit_cost=...)``), on the device of the group it prices.

The reference profiled one JAX backend; on a real CPU+GPU host the two
groups are different devices, so the port keeps one profile per device
kind.  Its dispatch probe launches the hand-written ``probe_add_one``
kernel (K4, ``csrc/probe.cu``) — the port of the reference's
interpret-step probe kernel.  Kernels are compiled here, never
interpreted, so ``interpret_step_s`` is 0 on both devices.

``REPRO_COST_MODEL=0`` disables everything model-driven: calibration
falls back to probe runs.  ``get_profile`` then returns the static
profile, which states nominal numbers and ``measured=False``.
"""
from __future__ import annotations

import os
import threading
from dataclasses import asdict, dataclass
from typing import Dict, Optional

import torch

from repro_torch.core.persist import JsonStore, default_calib_path
from repro_torch.kernels.common import kernel_lib, launch

ENV_DISABLE = "REPRO_COST_MODEL"
PROFILE_VERSION = 1
_SECTION = "hardware"


def enabled() -> bool:
    return os.environ.get(ENV_DISABLE, "1").lower() not in (
        "0", "off", "false", "no")


def backend_key(device) -> str:
    """Store key of a device: ``torch:cuda`` or ``torch:cpu``."""
    return f"torch:{torch.device(device).type}"


@dataclass(frozen=True)
class CostTerms:
    """Analytic work of one kernel call (or one work unit).

    ``steps`` is the number of kernel launches (per-launch overhead
    punishes tiny calls).  ``compute="matmul"`` rates the flops at the
    contraction rate, anything else at the streaming element-op rate.
    ``host_bytes`` is traffic between host and device memory.
    ``interpret_steps`` is kept for parity with the reference's terms;
    nothing in the port runs interpreted, so it prices at 0."""
    flops: float = 0.0
    bytes: float = 0.0
    steps: int = 1
    compute: str = "elementwise"
    host_bytes: float = 0.0
    interpret_steps: int = 0


@dataclass(frozen=True)
class HardwareProfile:
    """Per-device throughput terms (seconds come out of ``predict``).
    ``measured=False`` marks the static profile."""
    backend: str
    matmul_flops: float          # contraction rate, FLOP/s
    ew_flops: float              # streaming element-op rate, op/s
    mem_bw: float                # bytes/s, read+write
    dispatch_s: float            # per-call overhead of a trivial launch
    host_bw: float               # host<->device bytes/s
    link_bw: float = 50e9        # collective link (not probed on 1 device)
    interpret_step_s: float = 0.0
    measured: bool = True

    def predict(self, t: CostTerms) -> float:
        """Roofline-style execution-time estimate (seconds)."""
        rate = self.matmul_flops if t.compute == "matmul" else self.ew_flops
        roof = max(t.flops / max(rate, 1.0),
                   t.bytes / max(self.mem_bw, 1.0))
        host = t.host_bytes / max(self.host_bw, 1.0)
        interp = t.interpret_steps * self.interpret_step_s
        # per-step overhead is far below a full dispatch; 1/16 is a
        # ranking heuristic, not a measurement
        return (self.dispatch_s * (1.0 + t.steps / 16.0) + roof + host
                + interp)


def static_profile(device) -> HardwareProfile:
    """The profile used when the model is disabled (nothing may be
    measured then).  These are NOT measurements: the GPU row is the
    H100 SXM data sheet (f32 non-tensor 67 TFLOP/s, 3.35 TB/s, PCIe Gen5
    ~50 GB/s), the CPU row a nominal multicore host."""
    if torch.device(device).type == "cuda":
        return HardwareProfile(backend="torch:cuda", matmul_flops=67e12,
                               ew_flops=67e12 / 8, mem_bw=3.35e12,
                               dispatch_s=5e-6, host_bw=50e9,
                               measured=False)
    return HardwareProfile(backend="torch:cpu", matmul_flops=1e12,
                           ew_flops=50e9, mem_bw=50e9, dispatch_s=5e-6,
                           host_bw=20e9, measured=False)


def h100_sxm_profile() -> HardwareProfile:
    """The H100 SXM5's data-sheet constants for the roofline of the
    production mesh (``benchmarks.roofline``), the counterpart of the
    reference's ``tpu_v5e_profile()``.  None of these is a measurement:

      * ``matmul_flops`` 989.4e12 FLOP/s: dense BF16 tensor-core peak
        (H100 SXM5 data sheet; 1979 TFLOP/s is the 2:4-sparse figure);
      * ``ew_flops`` 67e12 op/s: FP32 on the CUDA cores (data sheet);
      * ``mem_bw`` 3.35e12 B/s: HBM3 (data sheet);
      * ``host_bw`` 64e9 B/s: PCIe Gen5 x16, one direction (the data
        sheet's 128 GB/s counts both);
      * ``link_bw`` 50e9 B/s per GPU: one 400 Gb/s NDR InfiniBand port a
        GPU.  A 16-way mesh axis over 8-GPU NVLink nodes crosses nodes,
        so its collectives run at the network's rate; NVLink 4's 450 GB/s
        per direction (900 GB/s both) inside a node is not used here;
      * ``dispatch_s`` 5e-6 s: a nominal launch cost, as in
        ``static_profile``."""
    return HardwareProfile(backend="torch:cuda", matmul_flops=989.4e12,
                           ew_flops=67e12, mem_bw=3.35e12, dispatch_s=5e-6,
                           host_bw=64e9, link_bw=50e9, measured=False)


# ---------------------------------------------------------------------------
# the dispatch probe kernel (K4)
# ---------------------------------------------------------------------------
PROBE_ENTRY = "probe_add_one_vec_f32"   # one block, float4 loads


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1``: on a GPU tensor the hand-written ``probe_add_one``
    kernel (one block), on a CPU tensor the plain tensor op."""
    if x.device.type == "cpu":
        return x + 1.0
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"probe_add_one: need a contiguous f32 CUDA or "
                         f"CPU tensor, got {x.dtype} on {x.device}")
    out = torch.empty_like(x)
    launch("probe_add_one", PROBE_ENTRY, x.device, x.data_ptr(),
           out.data_ptr(), x.numel())
    return out


def launch_floor(device: torch.device) -> None:
    """Launch the empty one-block kernel ``launch_floor_noop``: what a
    launch costs with no device work, the floor under ``dispatch_s``.
    For measurements only; not counted as a launch of any kernel."""
    lib = kernel_lib()
    err = lib.launch_floor_noop(torch.cuda.current_stream(device)
                                .cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_floor_noop: CUDA error {err}")


# ---------------------------------------------------------------------------
# Profile measurement + persistence
# ---------------------------------------------------------------------------
def _measure_profile(device: torch.device) -> HardwareProfile:
    """~100 ms of micro-probes on ``device``; paid once per device kind
    per store file."""
    from repro_torch.core.calibration import measure

    n = 512
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    b = torch.full((n, n), 0.5, dtype=torch.float32, device=device)
    t = measure(lambda: a @ b, warmup=2, iters=3, reduce="min")
    matmul_flops = 2.0 * n ** 3 / max(t, 1e-9)

    m = 1 << 22                                   # 16 MB f32: past cache
    x = torch.ones((m,), dtype=torch.float32, device=device)
    t = measure(lambda: x * 1.0000001 + 0.5, warmup=2, iters=3,
                reduce="min")
    ew_flops = 2.0 * m / max(t, 1e-9)
    mem_bw = 8.0 * m / max(t, 1e-9)               # read + write

    tile = torch.zeros((128, 128), dtype=torch.float32, device=device)
    dispatch_s = measure(lambda: probe_add_one(tile), warmup=3, iters=10,
                         reduce="min")

    h = 1 << 18                                   # 1 MB each way
    if device.type == "cuda":
        src = torch.ones((h,), dtype=torch.float32).pin_memory()
        dst = torch.empty((h,), dtype=torch.float32).pin_memory()

        def round_trip():
            dst.copy_(src.to(device, non_blocking=True), non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
            return dst
    else:                                         # a host-memory copy
        src = torch.ones((h,), dtype=torch.float32)

        def round_trip():
            return src.clone()
    t = measure(round_trip, warmup=1, iters=3, reduce="min")
    host_bw = 8.0 * h / max(t, 1e-9)
    return HardwareProfile(backend=backend_key(device),
                           matmul_flops=matmul_flops, ew_flops=ew_flops,
                           mem_bw=mem_bw, dispatch_s=max(dispatch_s, 1e-9),
                           host_bw=host_bw, interpret_step_s=0.0)


_STORE: Optional[JsonStore] = None
_STORE_PATH: Optional[str] = None
_PROFILES: Dict[str, HardwareProfile] = {}
_LOCK = threading.Lock()


def _store() -> JsonStore:
    """Hardware-section store; re-resolved when REPRO_CALIB_CACHE
    changes (tests point it at tmp dirs)."""
    global _STORE, _STORE_PATH
    path = default_calib_path()
    with _LOCK:
        if _STORE is None or _STORE_PATH != path:
            _STORE = JsonStore(path)
            _STORE_PATH = path
            _PROFILES.clear()
        return _STORE


def get_profile(device) -> HardwareProfile:
    """The profile of ``device``'s kind: memory -> store file ->
    measured (and persisted).  With the model disabled, the static
    profile — never a measurement."""
    device = torch.device(device)
    if not enabled():
        return static_profile(device)
    backend = backend_key(device)
    store = _store()
    with _LOCK:
        prof = _PROFILES.get(backend)
        if prof is not None:
            return prof
    with store.lock:
        entry = store.data().get(_SECTION, {}).get(backend)
        prof = None
        if isinstance(entry, dict) and entry.get("v") == PROFILE_VERSION:
            fields = {k: v for k, v in entry.items() if k != "v"}
            try:
                prof = HardwareProfile(**fields)
            except TypeError:
                prof = None
    if prof is None:
        prof = _measure_profile(device)
        with store.lock:
            store.data().setdefault(_SECTION, {})[backend] = {
                **asdict(prof), "v": PROFILE_VERSION}
            store.flush()
    with _LOCK:
        _PROFILES[backend] = prof
    return prof


def reset_profiles() -> None:
    """Forget memoized profiles and the store binding (tests)."""
    global _STORE, _STORE_PATH
    with _LOCK:
        _STORE = None
        _STORE_PATH = None
        _PROFILES.clear()


def predict(terms: CostTerms, device) -> float:
    """Convenience: ``device``'s profile time estimate."""
    return get_profile(device).predict(terms)


# ---------------------------------------------------------------------------
# LM serving priors (prefill/decode disaggregation)
# ---------------------------------------------------------------------------
def lm_prefill_terms(n_params: float, prompt_len: int) -> CostTerms:
    """Prior for one LM prefill of ``prompt_len`` tokens: ~2*params
    matmul FLOPs per token against one streaming read of the weights —
    compute-bound for any non-trivial prompt, which is why
    disaggregation wants prefill on the fastest-matmul lane."""
    return CostTerms(flops=2.0 * n_params * max(int(prompt_len), 1),
                     bytes=4.0 * n_params, compute="matmul")


def lm_decode_terms(n_params: float, n_steps: int = 1) -> CostTerms:
    """Prior for ``n_steps`` single-token decode steps: each step does
    ~2*params FLOPs but re-reads every weight, so flops ~= bytes/2 and
    the roofline lands on the bandwidth leg — the decode-roofline prior
    ``launch/serve.py`` uses for hybrid LM placement."""
    n = max(int(n_steps), 1)
    return CostTerms(flops=2.0 * n_params * n, bytes=4.0 * n_params * n,
                     steps=n, compute="matmul")
