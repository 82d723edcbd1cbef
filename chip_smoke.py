#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the hand-written CUDA kernels (``src/repro_torch/csrc/*.cu``)
   with ``nvcc`` for ``sm_90a`` into ``src/repro_torch/build/``, prints
   ptxas's registers and spills per kernel, and fails if a kernel of
   K1's, K2's, K3's, K5's or K6's redesigned routes spills to local
   memory.
3. Kernel phase: calls each kernel's wrapper on the card at the shapes
   the main path gives it and at ragged shapes, holds the result
   against its plain PyTorch version on the same inputs (K1 bitwise
   the shift-add and PR 11's kernel at every odd K 1-17, ragged and
   unaligned; K2 exactly at 1-4096 bins, all keys in one bin; K3 at
   every main-path tile, K on both sides of each threads-a-row
   threshold, offset views, indices -1 and C, padding rows, R = 1, two
   calls bitwise equal; K4 exact; K5 bitwise at every row length
   2-8192, K6 at every radius 1-7 and at 9; each case on the C entry
   its ``route`` names), and times kernel, plain version and (where one
   exists) the single PyTorch call that computes the same function,
   with CUDA events; the first versions of K1, K2 (at the main chunk
   and at sort's 2^24 keys, 64 bins), K3 (at the heavy tile 512x3451
   and the light tile 512x98), K4 and K6 are timed beside their new
   routes, K3's instantiations (threads a row) at 512 rows and several
   K, and an empty kernel as the launch floor (``kernel launch floor
   ms=``).
4. Hybrid phase: ``HybridExecutor()`` pairs the GPU (``accel``) with
   the CPU (``host``) in ``threads`` mode and runs conv (3600x3600,
   K=15), hist (2^26 keys, 256 bins), spmv (n=8192), bilateral
   (3600x3600, radius 7) and sort (2^24 keys, 64 bins) cold, warm,
   warm under ``torch.profiler`` (the GPU's busy share) and with a
   forced split that puts work on the CPU, then sort's leaf sorter
   (``sort leaf``: the bitonic kernel over the keys in 1024-wide rows);
   checks every value against a reference, and checks that every
   kernel on the path was launched, K1, K2, K3, K5 and K6 through
   their redesigned routes and K4 (the cold calls' profile
   measurement) through its one-block entry (``MAIN_ENTRY``).
5. LM phase: kimi-k2 at its full width, cut to depth 2 (the dense first
   layer and one MoE layer, ~20 B parameters, ~40 GB of bf16 weights
   from seed 0), serves a batch of 4 prompts of 1024 tokens through
   ``serve_step.generate`` (prefill + 16 greedy decode steps): weights'
   bytes, peak memory, K7/K8 launches per ``generate``, per prefill and
   per decode step (all of them through the tensor-core entries of K7
   and K8), prefill time, decode time per token, the GPU's idle share
   in one profiled decode step and the device time by kernel of one
   profiled prefill; then the same greedy run with K7
   and K8 swapped for their plain versions, whose tokens the kernel
   path must give under the margin rule (``serve/plain_check.py``);
   then K7 and K8 against their plain versions at the main path's
   shapes (and ragged ones), timed beside
   ``F.scaled_dot_product_attention`` and ``torch.bmm``.
6. Table 2 phase: the port's ``table2_hybrid.run()``, all 13 Table-1
   workloads at both of the paper's ratios (10 and 3.9) on the
   simulated pair on the GPU (``force_simulated``), a cold pass (its
   rows read the cost model's prior) and two warm passes (their rows
   read the unit times measured before), with K1, K2, K3 and K6 on
   their redesigned entries and K4 in the cold calibrations;
   then Fig. 4 (``fig4_overlap``), the split sweep and Fig. 3 at the
   reference's defaults, on the same pair.
7. The other eight Table-1 workloads on the real pair: spgemm (n=4096,
   density 0.02), raycast (2^20 rays, d=128), montecarlo (2^22
   photons), listrank (2^22 nodes), concomp (2^17 vertices), lbm
   (128^3, 4 steps), dither (1024x1024) and bundle (16 cameras, 4096
   points), a cold and a warm call each and a profiled warm call for
   the four that run through the executor's chunks; each value held
   to its check (spgemm against A @ B in f64, raycast, montecarlo,
   lbm and dither against the port's CPU values, listrank's ranks
   walking the list, concomp against scipy's components, bundle's
   error falling).
8. Prints the kernels' numbers as one JSON line, the card line again,
   and, last, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It also exits
non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  The calibration store is kept in memory
(``REPRO_CALIB_CACHE=0``): the run writes nothing outside the checkout
except the kernel build under ``src/repro_torch/build/``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks, the bound of every kernel time below
PEAK_F32_FLOPS = 67e12           # f32 on the CUDA cores (no tensor cores)
PEAK_BF16_FLOPS = 989e12         # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12             # HBM3 bytes/s

# attention and gmm in bf16: one rounding of the output to bf16 (relative
# 2^-8, a few ulp at |out| <= 1) and f32 sums in another order
TOL = {"conv2d": 2e-4, "hist": 0, "spmv_ell": 2e-5, "probe_add_one": 0,
       "sort_bitonic": 0, "bilateral": 1e-3, "flash_attention": 1e-2,
       "gmm": 1e-2}
SOURCE = {
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d/conv2d.py:41"),
    "hist": ("src/repro_torch/csrc/hist.cu",
             "src/repro/kernels/hist/hist.py:51"),
    "spmv_ell": ("src/repro_torch/csrc/spmv_ell.cu",
                 "src/repro/kernels/spmv/spmv.py:36"),
    "probe_add_one": ("src/repro_torch/csrc/probe.cu",
                      "src/repro/core/cost_model.py:154"),
    "sort_bitonic": ("src/repro_torch/csrc/sort_bitonic.cu",
                     "src/repro/kernels/sort_bitonic/sort_bitonic.py:58"),
    "bilateral": ("src/repro_torch/csrc/bilateral.cu",
                  "src/repro/kernels/bilateral/bilateral.py:66"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:75"),
    "gmm": ("src/repro_torch/csrc/gmm_wgmma.cu",
            "src/repro/kernels/gmm/gmm.py:40"),
}
# the C entry points the LM's main path must launch (bf16, aligned rows):
# the tensor-core routes of K7 and K8, never their CUDA-core routes
LM_ENTRY = {"flash_attention": ("flash_attention_wgmma_bf16",
                                "flash_attention_fma_bf16"),
            "gmm": ("gmm_wgmma_bf16", "gmm_fma_bf16")}
# the C entry points the work-shared path must launch for K1-K6 (K4 in
# the cold calls' profile measurement): the redesigned kernels, never the
# first versions of K1-K4 and K6
MAIN_ENTRY = {"conv2d": ("conv2d_reg_f32", "conv2d_f32"),
              "hist": ("hist_priv_i32", "hist_i32"),
              "spmv_ell": ("spmv_ell_seg_f32", "spmv_ell_f32"),
              "probe_add_one": ("probe_add_one_vec_f32",
                                "probe_add_one_f32"),
              "sort_bitonic": ("sort_rows_reg_f32", None),
              "bilateral": ("bilateral_reg_f32", "bilateral_f32")}
# the kernels whose ptxas report must show no spill to local memory
NO_SPILL = ("conv2d_reg_kernel", "hist_priv_kernel", "sort_rows_reg_kernel",
            "bilateral_reg_kernel", "spmv_ell_seg_kernel")

CONV_SIZE, CONV_K = 3600, 15
HIST_N, HIST_BINS = 1 << 26, 256
SPMV_N, SPMV_DENSITY = 8192, 0.01
SORT_N, SORT_BINS, SORT_TILE = 1 << 24, 64, 1024
BILAT_SIZE, BILAT_SIGMA_S, BILAT_SIGMA_R, BILAT_RADIUS = 3600, 3.0, 30.0, 7
BILAT_BAND = 64       # rows held against the direct (exp) filter, per edge
# the other eight Table-1 workloads on the real pair; concomp is kept
# small: its host BFS and union-find merge are Python loops
TABLE1_SIZES = {
    "spgemm": dict(n=4096, density=0.02),
    "raycast": dict(n_rays=1 << 20, d=128),
    "montecarlo": dict(n_photons=1 << 22, unit=1 << 14),
    "listrank": dict(n=1 << 22),
    "concomp": dict(n=1 << 17, avg_deg=4.0),
    "lbm": dict(d=128, n_steps=4),
    "dither": dict(h=1024, w=1024),
    "bundle": dict(n_cams=16, n_pts=4096),
}
# those that run through the executor's chunks (the rest time a task
# graph, or lbm's plane split, themselves)
CHUNKED = ("spgemm", "raycast", "montecarlo", "concomp")
LM_ARCH, LM_LAYERS = "kimi-k2-1t-a32b", 2
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 16


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def time_ms(torch, fn, flush, iters: int = 15, warm: int = 3) -> float:
    """Median CUDA-event time of one call, on the device.  Before each
    call a read of a buffer larger than the 50 MB L2 evicts the inputs
    (the main path reads every input cold; a read leaves no dirty lines
    to write back inside the timed call), then the GPU spins ~0.5 ms so
    that the host has enqueued the call before the start event fires:
    the wrapper's host-side cost stays outside the events, also on a
    busy host (a ~0.1 ms spin let one median take in the host's time)."""
    times = []
    for i in range(warm + iters):
        flush.max()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= warm:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


def check(torch, name, out, ref, what) -> float:
    tol = TOL[name]
    if tol == 0:
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} {what}: not exact, max diff "
                                 f"{(out - ref).abs().max().item()}")
        return 0.0
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol,
                               msg=lambda m: f"{name} {what}: {m}")
    return (out - ref).abs().max().item()


def check_entry(label, name, counts, entries) -> None:
    """Every launch of ``name`` in ``counts`` went through its
    MAIN_ENTRY route, and at least one happened."""
    want, other = MAIN_ENTRY[name]
    if counts[name] <= 0 or entries[want] != counts[name] \
            or (other and entries[other]):
        raise AssertionError(
            f"{label}: {name} launched {counts[name]} times, "
            f"{entries[want]} through {want}"
            + (f" and {entries[other]} through {other}" if other else ""))
    print(f"{label}: {name} launches by entry: {want}={entries[want]}"
          + (f" {other}={entries[other]}" if other else ""), flush=True)


def ptxas_report(log: str) -> None:
    """Print ptxas's registers and spills per kernel; fail where a
    kernel of NO_SPILL spills."""
    func = None
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(f"build: {line.strip()}")
        if "Function properties for" in line:
            func = line.split("for", 1)[1].strip()
        elif "spill" in line and func:
            print(f"build: {func[:90]}: {line.strip()}")
            if any(k in func for k in NO_SPILL) and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"{func} spills: {line.strip()}")
            func = None


def kernel_row(name, err, ms, plain_ms, flops, nbytes, library_ms, shape,
               peak_flops=PEAK_F32_FLOPS, entry=None):
    """The JSON row of one kernel at the main path's shape; the bound is
    the larger of its bytes over HBM's rate and its operations over
    ``peak_flops``.  ``entry``: the C entry point (route) that ran."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    src, rep = SOURCE[name]
    r = {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": None, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": library_ms}
    if entry is not None:
        r["entry"], r["shape"] = entry, shape
    print(f"kernel {name} {shape}: err={err:.3g} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}) library_ms={library_ms}"
          + (f" entry={entry}" if entry else ""), flush=True)
    return r


def spmv_probe_rows(torch, np, dev, flush, rng):
    """K3 and K4 on the card: every case on the C entry its route names,
    held against the plain version; both timed beside their first
    versions' entries, and the launch floor (an empty kernel) under the
    same timer."""
    from repro_torch.core.cost_model import (PROBE_ENTRY, launch_floor,
                                             probe_add_one)
    from repro_torch.kernels import common
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    from repro_torch.kernels.spmv.spmv import (SEG_ENTRY, TPRS, WARP_ENTRY,
                                               blocks, route, spmv_ell_cuda,
                                               vector_loads)
    from repro_torch.workloads import spmv as spmv_w

    rows = []

    # K3 spmv ELL.  An index outside [0, C) adds nothing: the plain
    # version then masks those slots' products (spmv_ell_ref as is when
    # every index is in range)
    def plain(vals, idx, xv):
        C = xv.shape[0]
        inside = (idx >= 0) & (idx < C)
        if bool(inside.all()):
            return spmv_ell_ref(vals, idx, xv)
        prod = vals * xv[idx.clamp(0, C - 1).long()]
        return torch.where(inside, prod, torch.zeros_like(prod)).sum(1)

    def exact(vals, idx, xv):
        """The float64 product (the error both kernels are given)."""
        C = xv.shape[0]
        inside = (idx >= 0) & (idx < C)
        prod = vals.double() * xv.double()[idx.clamp(0, C - 1).long()]
        return torch.where(inside, prod, torch.zeros_like(prod)).sum(1)

    def seg(vals, idx, xv, tpr):
        """The new entry at a chosen threads-a-row (the route's sweep)."""
        y = torch.empty(vals.shape[0], dtype=torch.float32, device=dev)
        common.launch("spmv_ell", SEG_ENTRY, dev, vals.data_ptr(),
                      idx.data_ptr(), xv.data_ptr(), y.data_ptr(),
                      vals.shape[0], vals.shape[1], xv.shape[0], tpr,
                      int(vector_loads(vals.data_ptr(), idx.data_ptr())))
        return y

    def first(vals, idx, xv):
        """The first version, a warp a row."""
        y = torch.empty(vals.shape[0], dtype=torch.float32, device=dev)
        common.launch("spmv_ell", WARP_ENTRY, dev, vals.data_ptr(),
                      idx.data_ptr(), xv.data_ptr(), y.data_ptr(),
                      vals.shape[0], vals.shape[1], xv.shape[0])
        return y

    def case(vals, idx, xv, what):
        R, K = vals.shape
        entry, tpr = route(K)
        vec = vector_loads(vals.data_ptr(), idx.data_ptr())
        common.reset_launches()
        out = spmv_ell_cuda(vals, idx, xv)
        if common.entry_counts()[entry] != 1:
            raise AssertionError(f"spmv_ell {what}: not launched through "
                                 f"{entry}")
        again = spmv_ell_cuda(vals, idx, xv)
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"spmv_ell {what}: two calls differ")
        err = check(torch, "spmv_ell", out, plain(vals, idx, xv), what)
        print(f"kernel spmv_ell {what}: entry={entry} tpr={tpr} "
              f"vector={vec} blocks={blocks(R, tpr)} max_abs_err={err!r}; "
              f"two calls bitwise equal", flush=True)
        return err

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev)

    def cols(R, K, C):
        return torch.tensor(rng.integers(0, C, (R, K), dtype=np.int32),
                            device=dev)

    # ragged shapes, K on both sides of every threads-a-row threshold
    for R, K, C in [(1000, 37, 777), (33, 4, 100), (100, 80, 80),
                    (1, 3451, SPMV_N), (1, 5, 10), (33, 98, SPMV_N),
                    (33, 3451, SPMV_N), (70, 512, 1000), (70, 513, 1000),
                    (70, 1024, 1000), (70, 1025, 1000), (70, 2048, 1000),
                    (70, 2049, 1000), (9, 1, 3), (5, 0, 4)]:
        case(randn(R, K), cols(R, K, C), randn(C), f"R={R} K={K} C={C}")
    # offset views: rows one row into their storage (the same phase),
    # vals one float off idx's phase (the scalar instantiation)
    for K in (98, 3451):
        v, i, xv = randn(65, K), cols(65, K, SPMV_N), randn(SPMV_N)
        case(v[1:], i[1:], xv, f"R=64 K={K} view [1:]")
        flat = randn(1 + 64 * K)
        vs = flat[1:].view(64, K)
        assert not vector_loads(vs.data_ptr(), i[1:].data_ptr())
        case(vs, i[1:], xv, f"R=64 K={K} vals off idx's 16-byte phase")
    # indices -1 and C (contribute nothing), zero padding rows, x[0] = inf
    v, i, xv = randn(100, 201), cols(100, 201, 500), randn(500)
    i[::3, ::7] = -1
    i[1::3, 3::5] = 500
    case(v, i, xv, "R=100 K=201 indices -1 and C")
    v[50:], i[50:] = 0.0, 0
    case(v, i, xv, "R=100 K=201 rows 50-99 all padding")
    xv[0] = float("inf")
    out = spmv_ell_cuda(v, i, xv)
    if not bool(torch.isnan(out[50:]).all()):
        raise AssertionError("spmv_ell: 0 * x[0] = 0 * inf is not NaN in "
                             "the padding rows, as in the reference")
    print("kernel spmv_ell x[0]=inf: padding rows NaN, as vals * x[idx] "
          "gives", flush=True)

    # the main path's ELL tiles (the nnz-sorted matrix in 512-row tiles;
    # the first holds the heavy rows)
    A = spmv_w.make_matrix(SPMV_N, SPMV_DENSITY)
    A_sorted = A[np.argsort(-(A != 0).sum(1))]
    xv = torch.tensor(spmv_w.make_vector(SPMV_N), device=dev)
    tiles = []
    for t0 in range(0, SPMV_N, 512):
        sub = A_sorted[t0:t0 + 512]
        tiles.append(spmv_ops.prepare(
            sub, k_threshold=int(max((sub != 0).sum(1).max(), 1)),
            device=dev))
    errs = [case(m.ell_vals, m.ell_idx, xv, f"main path tile {i} "
                 f"{tuple(m.ell_vals.shape)}") for i, m in enumerate(tiles)]

    # threads a row: each instantiation at the main path's K and around
    # the route's thresholds (512 rows), the data behind route()
    shapes = [(m.ell_vals, m.ell_idx, f"tile {i}")
              for i, m in ((0, tiles[0]), (1, tiles[1]), (15, tiles[15]))]
    for K in (256, 512, 1024, 2048):
        shapes.append((randn(512, K), cols(512, K, SPMV_N), "synthetic"))
    for vals, idx, label in shapes:
        K = vals.shape[1]
        ms = {}
        for tpr in TPRS + TPRS[::-1]:
            t = time_ms(torch, lambda: seg(vals, idx, xv, tpr), flush)
            ms[tpr] = min(ms.get(tpr, t), t)
        print(f"kernel spmv_ell tpr sweep ({label}) R=512 K={K}: "
              + " ".join(f"tpr{t}={ms[t]:.4f}" for t in TPRS)
              + f" route=tpr{route(K)[1]}", flush=True)

    # the JSON rows: tile 0 (heavy) and tile 1 (the largest light tile),
    # each against the float64 product beside the first version, and both
    # kernels timed in turns (new, first, first, new)
    for i in (0, 1):
        m = tiles[i]
        vals, idx = m.ell_vals, m.ell_idx
        R, K = vals.shape
        ref64 = exact(vals, idx, xv)
        e_new = (spmv_ell_cuda(vals, idx, xv).double() - ref64).abs().max()
        e_old = (first(vals, idx, xv).double() - ref64).abs().max()
        nbytes = 8.0 * R * K + 4.0 * R + 4.0 * SPMV_N
        t = [time_ms(torch, lambda: spmv_ell_cuda(vals, idx, xv), flush),
             time_ms(torch, lambda: first(vals, idx, xv), flush),
             time_ms(torch, lambda: first(vals, idx, xv), flush),
             time_ms(torch, lambda: spmv_ell_cuda(vals, idx, xv), flush)]
        new_ms, old_ms = min(t[0], t[3]), min(t[1], t[2])
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.arange(R, device=dev).repeat_interleave(K),
                         idx.reshape(-1).long()]),
            vals.reshape(-1), (R, SPMV_N), check_invariants=False).coalesce()
        x2 = xv[:, None]
        print(f"kernel spmv_ell tile {i} R={R} K={K}: {SEG_ENTRY} ms="
              f"{t[0]:.4f}/{t[3]:.4f} ({nbytes / new_ms / 1e9:.3f} TB/s) "
              f"{WARP_ENTRY} ms={t[1]:.4f}/{t[2]:.4f} "
              f"({nbytes / old_ms / 1e9:.3f} TB/s); max_abs_err against "
              f"the float64 product: {float(e_new)!r} (new), "
              f"{float(e_old)!r} ({WARP_ENTRY})", flush=True)
        r = kernel_row(
            "spmv_ell", errs[i], new_ms,
            time_ms(torch, lambda: spmv_ell_ref(vals, idx, xv), flush),
            2.0 * R * K, nbytes,
            time_ms(torch, lambda: torch.sparse.mm(coo, x2), flush),
            f"tile {i}: R={R} K={K} C={SPMV_N}", PEAK_F32_FLOPS,
            route(K)[0])
        r.update(first_ms=old_ms, tpr=route(K)[1])
        rows.append(r)

    # K4 probe_add_one at the cost model's (128, 128) probe tile, a numel
    # off a multiple of 4 and a view off 16-byte alignment: exact
    def probe_case(t, what):
        common.reset_launches()
        out = probe_add_one(t)
        if common.entry_counts()[PROBE_ENTRY] != 1:
            raise AssertionError(f"probe_add_one {what}: not launched "
                                 f"through {PROBE_ENTRY}")
        check(torch, "probe_add_one", out, t + 1.0, what)
        print(f"kernel probe_add_one {what}: entry={PROBE_ENTRY} exact",
              flush=True)

    def probe_first(t):
        out = torch.empty_like(t)
        common.launch("probe_add_one", "probe_add_one_f32", dev,
                      t.data_ptr(), out.data_ptr(), t.numel())
        return out

    probe_case(randn(127, 129), "127x129")
    probe_case(randn(1 + 4096)[1:], "4096 one float into its storage")
    probe_case(randn(3), "3")
    t = randn(128, 128)
    probe_case(t, "128x128")
    check(torch, "probe_add_one", probe_first(t), t + 1.0,
          "128x128, first version")
    floor = []
    new = [time_ms(torch, lambda: probe_add_one(t), flush)]
    old = [time_ms(torch, lambda: probe_first(t), flush)]
    floor.append(time_ms(torch, lambda: launch_floor(dev), flush))
    floor.append(time_ms(torch, lambda: launch_floor(dev), flush))
    old.append(time_ms(torch, lambda: probe_first(t), flush))
    new.append(time_ms(torch, lambda: probe_add_one(t), flush))
    print(f"kernel launch floor ms={min(floor):.4f} (launch_floor_noop, one "
          f"block of 32 threads, no work: {floor[0]:.4f}/{floor[1]:.4f})",
          flush=True)
    print(f"kernel probe_add_one 128x128: {PROBE_ENTRY} ms={new[0]:.4f}/"
          f"{new[1]:.4f} probe_add_one_f32 ms={old[0]:.4f}/{old[1]:.4f} "
          f"launch floor ms={min(floor):.4f}", flush=True)
    # a 16x smaller tile: what the one block's time owes to its bytes
    small = randn(32, 32)
    print(f"kernel probe_add_one 32x32: {PROBE_ENTRY} ms="
          f"{time_ms(torch, lambda: probe_add_one(small), flush):.4f} "
          f"probe_add_one_f32 ms="
          f"{time_ms(torch, lambda: probe_first(small), flush):.4f}",
          flush=True)
    r = kernel_row("probe_add_one", 0.0, min(new),
                   time_ms(torch, lambda: t + 1.0, flush),
                   1.0 * t.numel(), 8.0 * t.numel(),
                   time_ms(torch, lambda: torch.add(t, 1.0), flush),
                   "128x128", PEAK_F32_FLOPS, PROBE_ENTRY)
    r.update(first_ms=min(old), launch_floor_ms=min(floor))
    rows.append(r)
    return rows


def kernel_phase(torch, np, dev, flush):
    from repro_torch.core.host_offload import bilateral_luts
    from repro_torch.kernels import common
    from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                         bilateral_lut_torch)
    from repro_torch.kernels.bilateral.bilateral import (
        route as bilateral_route)
    from repro_torch.kernels.conv2d.conv2d import (conv2d_cuda,
                                                   conv2d_shift_add)
    from repro_torch.kernels.conv2d.conv2d import route as conv2d_route
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.hist.hist import hist_cuda
    from repro_torch.kernels.hist.hist import route as hist_route
    from repro_torch.kernels.hist.ref import hist_ref
    from repro_torch.kernels.sort_bitonic.sort_bitonic import (
        bitonic_rows_torch, sort_rows_cuda)
    from repro_torch.kernels.sort_bitonic.sort_bitonic import (
        ENTRY as SORT_ENTRY)
    from repro_torch.workloads import bilateral as bilateral_w
    from repro_torch.workloads import sort as sort_w

    rng = np.random.default_rng(7)
    rows = []

    def row(*args):
        rows.append(kernel_row(*args))

    # K1 conv2d: ragged shapes at every odd K 1-15 (the register route)
    # and at 17 (the first version), an unaligned row slice, then the
    # main path's chunk (225 rows + 14 halo rows of the 3600-wide image,
    # K=15).  Bitwise the plain shift-add and PR 11's kernel; F.conv2d
    # (TF32 off) within 2e-4.
    def conv_first(img, w):
        out = torch.empty_like(img)
        common.launch("conv2d", "conv2d_f32", dev, img.data_ptr(),
                      w.data_ptr(), out.data_ptr(), img.shape[0],
                      img.shape[1], w.shape[0])
        return out

    def conv_case(img, w, what):
        entry = conv2d_route(w.shape[0])
        common.reset_launches()
        out = conv2d_cuda(img, w)
        if common.entry_counts()[entry] != 1:
            raise AssertionError(f"conv2d {what}: not launched through "
                                 f"{entry}")
        for plain, label in ((conv2d_shift_add(img, w), "the shift-add"),
                             (conv_first(img, w), "conv2d_f32")):
            if not torch.equal(out, plain):
                raise AssertionError(
                    f"conv2d {what}: not bitwise {label}, max diff "
                    f"{(out - plain).abs().max().item()}")
        err = check(torch, "conv2d", out, conv2d_ref(img, w),
                    f"{what} against F.conv2d")
        print(f"kernel conv2d {what}: entry={entry} bitwise the shift-add "
              f"and conv2d_f32; F.conv2d max_abs_err={err!r}", flush=True)
        return out

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev)

    for K in range(1, 18, 2):
        for H, W in [(37, 101), (20, 130), (1, 5)]:
            conv_case(randn(H, W), randn(K, K), f"{H}x{W} K={K}")
    for H, W, K in [(50, 64, 15), (129, 77, 15)]:
        conv_case(randn(H, W), randn(K, K), f"{H}x{W} K={K}")
    # the whole image in one call: the register route's steady state
    img, w = randn(CONV_SIZE, CONV_SIZE), randn(CONV_K, CONV_K)
    conv_case(img, w, f"{CONV_SIZE}x{CONV_SIZE} K={CONV_K}")
    ms = time_ms(torch, lambda: conv2d_cuda(img, w), flush)
    rate = 2.0 * CONV_SIZE ** 2 * CONV_K ** 2 / (ms * 1e-3)
    print(f"kernel conv2d whole image {CONV_SIZE}x{CONV_SIZE} K={CONV_K}: "
          f"ms={ms:.4f} ({rate / 1e12:.1f} TFLOP/s, "
          f"{rate / PEAK_F32_FLOPS:.2f} of the f32 peak)", flush=True)
    big = randn(43, 101)
    sl = big[3:40]                       # 3 * 101 floats in: not aligned
    assert sl.data_ptr() % 16
    conv_case(sl, randn(CONV_K, CONV_K), "row slice [3:40] of 43x101 K=15")
    flat = randn(1 + 30 * 128)
    conv_case(flat[1:].view(30, 128), randn(7, 7),
              "30x128 K=7 one float into its storage")
    H = CONV_SIZE // 16 + CONV_K - 1
    img, w = randn(H, CONV_SIZE), randn(CONV_K, CONV_K)
    common.reset_launches()
    out = conv2d_cuda(img, w)
    check_entry("kernel conv2d main path chunk", "conv2d",
                common.launch_counts(), common.entry_counts())
    conv_case(img, w, "main path chunk")
    row("conv2d", 0.0, time_ms(torch, lambda: conv2d_cuda(img, w), flush),
        time_ms(torch, lambda: conv2d_shift_add(img, w), flush, iters=10),
        2.0 * H * CONV_SIZE * CONV_K ** 2,
        4.0 * (2 * H * CONV_SIZE + CONV_K ** 2),
        time_ms(torch, lambda: conv2d_ref(img, w), flush),
        f"{H}x{CONV_SIZE} K={CONV_K}", PEAK_F32_FLOPS,
        conv2d_route(CONV_K))
    # PR 11's kernel (still the route past K = 15) at the same chunk,
    # timed in the same run, in turns with the register route
    first_ms = time_ms(torch, lambda: conv_first(img, w), flush)
    again_ms = time_ms(torch, lambda: conv2d_cuda(img, w), flush)
    print(f"kernel conv2d first version (conv2d_f32) {H}x{CONV_SIZE} "
          f"K={CONV_K}: ms={first_ms:.4f} (register route again: "
          f"{again_ms:.4f})", flush=True)

    # K2 hist: ragged N, a slice off a 16-byte boundary, keys out of
    # range on both sides (ignored), all keys in one bin, 64 bins and the
    # route's boundary (1816 bins, then 1817 on the first version), then
    # the main path's chunk (4 of 64 units of 2^26) and sort's binning
    # shape (2^24 keys, 64 bins).  Exact against hist_ref.
    def hist_first(x, bins):
        out = torch.zeros(bins, dtype=torch.int32, device=dev)
        common.launch("hist", "hist_i32", dev, x.data_ptr(), x.numel(),
                      bins, 4 * torch.cuda.get_device_properties(
                          dev).multi_processor_count, out.data_ptr())
        return out

    def hist_case(x, bins, what):
        entry = hist_route(bins)
        common.reset_launches()
        out = hist_cuda(x, bins)
        if common.entry_counts()[entry] != 1:
            raise AssertionError(f"hist {what}: not launched through "
                                 f"{entry}")
        check(torch, "hist", out, hist_ref(x, bins), what)
        print(f"kernel hist {what}: entry={entry} exact", flush=True)

    for n, bins, lo, hi in [(1000, 16, 0, 16), (4099, 7, -2, 9),
                            ((1 << 20) + 3, 4096, 0, 4096),
                            (5, 3, 0, 3), (2, 1, 0, 1),
                            ((1 << 22) + 5, 64, -3, 67),
                            (300_001, 256, -1, 257),
                            (100_003, 1816, -5, 1821),
                            (100_003, 1817, -5, 1822)]:
        x = torch.tensor(rng.integers(lo, hi, n, dtype=np.int32),
                         device=dev)
        hist_case(x, bins, f"N={n} bins={bins} keys [{lo}, {hi})")
        hist_case(x[1:], bins, f"N={n - 1} bins={bins} (offset slice)")
    for bins in (256, 1816):
        x = torch.full((1 << 20,), bins - 1, dtype=torch.int32, device=dev)
        hist_case(x, bins, f"N=2^20 bins={bins} all in bin {bins - 1}")
    n = HIST_N // 16
    x = torch.tensor(rng.integers(0, HIST_BINS, n, dtype=np.int32),
                     device=dev)
    common.reset_launches()
    hist_cuda(x, HIST_BINS)
    check_entry("kernel hist main path chunk", "hist",
                common.launch_counts(), common.entry_counts())
    hist_case(x, HIST_BINS, "main path chunk")
    row("hist", 0.0, time_ms(torch, lambda: hist_cuda(x, HIST_BINS), flush),
        time_ms(torch, lambda: hist_ref(x, HIST_BINS), flush),
        1.0 * n, 4.0 * (n + HIST_BINS),
        time_ms(torch, lambda: torch.bincount(x, minlength=HIST_BINS),
                flush), f"N={n} bins={HIST_BINS}", PEAK_F32_FLOPS,
        hist_route(HIST_BINS))
    # PR 11's kernel, its memset included as its wrapper has it, timed
    # in the same run, in turns with the new route; then both at sort's
    # binning shape
    check(torch, "hist", hist_first(x, HIST_BINS), hist_ref(x, HIST_BINS),
          "main path chunk, first version")
    first_ms = time_ms(torch, lambda: hist_first(x, HIST_BINS), flush)
    again_ms = time_ms(torch, lambda: hist_cuda(x, HIST_BINS), flush)
    print(f"kernel hist first version (hist_i32 + memset) N={n} "
          f"bins={HIST_BINS}: ms={first_ms:.4f} (hist_priv_i32 again: "
          f"{again_ms:.4f})", flush=True)
    xs = torch.tensor(rng.integers(0, SORT_BINS, SORT_N, dtype=np.int32),
                      device=dev)
    hist_case(xs, SORT_BINS, "sort's binning shape")
    check(torch, "hist", hist_first(xs, SORT_BINS), hist_ref(xs, SORT_BINS),
          "sort's binning shape, first version")
    new_ms = time_ms(torch, lambda: hist_cuda(xs, SORT_BINS), flush)
    first_ms = time_ms(torch, lambda: hist_first(xs, SORT_BINS), flush)
    bound_ms = 4.0 * (SORT_N + SORT_BINS) / PEAK_BYTES * 1e3
    print(f"kernel hist sort shape N={SORT_N} bins={SORT_BINS}: "
          f"hist_priv_i32 ms={new_ms:.4f} hist_i32 + memset ms="
          f"{first_ms:.4f} bound_ms={bound_ms:.4f} (bytes)", flush=True)
    del xs

    rows += spmv_probe_rows(torch, np, dev, flush, rng)

    # K5 sort_bitonic: ragged G and L (every row length from 2 to 8192,
    # G off the rows a block takes) with +inf padding, -inf, duplicates
    # and -0.0 beside 0.0, then the main path's rows (the sort workload's
    # 2^24 keys as 1024-wide rows).  Bitwise the plain network's.
    def sort_case(xt, what):
        out = sort_rows_cuda(xt)
        plain = bitonic_rows_torch(xt)
        if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
            raise AssertionError(f"sort_bitonic {what}: not bitwise the "
                                 f"plain network")
        check(torch, "sort_bitonic", out, torch.sort(xt, dim=1).values,
              f"{what} against torch.sort")
        return out

    for G, L in [(10, 16), (70, 64), (33, 256), (1, 2), (5, 8192),
                 (515, 4), (1029, 2), (133, 8), (37, 32), (21, 128),
                 (9, 512), (7, 1024), (3, 2048), (6, 4096)]:
        x = rng.standard_normal((G, L)).astype(np.float32)
        x[0, L // 2:] = np.inf
        x[-1, :L // 4] = -np.inf
        if G > 2:
            x[1] = np.round(x[1])
            x[2, ::2], x[2, 1::2] = -0.0, 0.0
        xt = torch.tensor(x, device=dev)
        out = sort_case(xt, f"G={G} L={L}")
        if G > 2:
            # == cannot tell -0.0 from 0.0: report (not assert) whether
            # the signed zeros come out in torch.sort's order too
            same = torch.equal(out[2].view(torch.int32),
                               torch.sort(xt, dim=1).values[2].view(
                                   torch.int32))
            print(f"kernel sort_bitonic G={G} L={L}: -0.0/0.0 row bitwise "
                  f"equal to the plain network: True, to torch.sort: "
                  f"{same}", flush=True)
    x = torch.tensor(sort_w.make_inputs(SORT_N), device=dev).reshape(
        -1, SORT_TILE)
    G, L = x.shape
    common.reset_launches()
    sort_case(x, "main path rows")
    check_entry("kernel sort_bitonic main path rows", "sort_bitonic",
                common.launch_counts(), common.entry_counts())
    stages = (L.bit_length() - 1) * L.bit_length() // 2
    row("sort_bitonic", 0.0,
        time_ms(torch, lambda: sort_rows_cuda(x), flush),
        time_ms(torch, lambda: bitonic_rows_torch(x), flush, iters=10),
        2.0 * G * (L // 2) * stages,            # compare + select per pair
        8.0 * G * L,
        time_ms(torch, lambda: torch.sort(x, dim=1), flush),
        f"G={G} L={L}", PEAK_F32_FLOPS, SORT_ENTRY)
    del x

    # K6 bilateral: ragged H/W (a 1-row block, odd W) at every radius
    # 1-7 (the register route) and 9 (K = 19, the first version), then
    # the main path's chunk (225 rows + 14 halo rows of the 3600-wide
    # image, K=15).  Error 0 against the plain LUT filter on both.
    for H, W, radius in [(37, 101, 1), (50, 33, 2), (129, 77, 3),
                         (1, 301, 4), (65, 31, 5), (9, 15, 6),
                         (129, 77, 7), (1, 301, 7), (9, 15, 7),
                         (70, 45, 9)]:
        img = torch.tensor((rng.random((H, W)) * 255).astype(np.float32),
                           device=dev)
        sp, rl = (torch.tensor(a, device=dev) for a in bilateral_luts(
            BILAT_SIGMA_S, BILAT_SIGMA_R, radius))
        entry = bilateral_route(sp.shape[0], rl.numel())
        common.reset_launches()
        out = bilateral_cuda(img, sp, rl)
        if common.entry_counts()[entry] != 1:
            raise AssertionError(f"bilateral {H}x{W} r={radius}: not "
                                 f"launched through {entry}")
        err = check(torch, "bilateral", out,
                    bilateral_lut_torch(img, sp, rl),
                    f"{H}x{W} r={radius} ({entry})")
        print(f"kernel bilateral {H}x{W} r={radius}: entry={entry} "
              f"max_abs_err={err!r}", flush=True)
    H = BILAT_SIZE // 16 + 2 * BILAT_RADIUS
    img = torch.tensor(bilateral_w.make_inputs(BILAT_SIZE)[:H], device=dev)
    sp, rl = (torch.tensor(a, device=dev) for a in bilateral_luts(
        BILAT_SIGMA_S, BILAT_SIGMA_R, BILAT_RADIUS))
    K = sp.shape[0]
    common.reset_launches()
    out = bilateral_cuda(img, sp, rl)
    check_entry("kernel bilateral main path chunk", "bilateral",
                common.launch_counts(), common.entry_counts())
    err = check(torch, "bilateral", out, bilateral_lut_torch(img, sp, rl),
                "main path chunk")
    row("bilateral", err,
        time_ms(torch, lambda: bilateral_cuda(img, sp, rl), flush),
        time_ms(torch, lambda: bilateral_lut_torch(img, sp, rl), flush,
                iters=10),
        6.0 * H * BILAT_SIZE * K * K,           # the reference's count
        4.0 * (2 * H * BILAT_SIZE + K * K + rl.numel()),
        None, f"{H}x{BILAT_SIZE} K={K}", PEAK_F32_FLOPS,
        bilateral_route(K, rl.numel()))
    # the first version (still the route past K = 15) at the same chunk,
    # timed in the same run: what the register route bought
    first = torch.empty_like(img)

    def bilateral_first():
        common.launch("bilateral", "bilateral_f32", dev, img.data_ptr(),
                      sp.data_ptr(), rl.data_ptr(), first.data_ptr(), H,
                      BILAT_SIZE, K, rl.numel())

    bilateral_first()
    check(torch, "bilateral", first, bilateral_lut_torch(img, sp, rl),
          "main path chunk, first version")
    print(f"kernel bilateral first version (bilateral_f32) {H}x"
          f"{BILAT_SIZE} K={K}: ms="
          f"{time_ms(torch, bilateral_first, flush):.4f}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# hybrid phase
# ---------------------------------------------------------------------------
def overlap_s(trace) -> float:
    """Seconds during which both groups were executing chunks."""
    spans = {}
    for r in trace.records:
        lo, hi = spans.get(r.group, (r.t_start, r.t_end))
        spans[r.group] = (min(lo, r.t_start), max(hi, r.t_end))
    if len(spans) < 2:
        return 0.0
    return max(0.0, min(h for _, h in spans.values())
               - max(lo for lo, _ in spans.values()))


def report(label, out) -> None:
    """The call's split and the paper's metrics.  A call with no chunk
    trace (the task-graph workloads, lbm's plane split) reports its
    plan's units as the split, mode ``none``, and no makespan or
    overlap."""
    r, trace = out.result, out.trace
    if trace is None:
        split = dict(zip(r.busy_times, out.plan.units))
        mode = makespan = overlap = "none"
    else:
        split = {g: trace.group_units.get(g, 0) for g in r.busy_times}
        mode = trace.mode
        makespan, overlap = repr(trace.makespan), repr(overlap_s(trace))
    print(f"hybrid {label}: mode={mode} split={split} "
          f"plan={out.plan.units} chunks={r.n_chunks} steals={r.steals} "
          f"hybrid_time_s={r.hybrid_time!r} "
          f"makespan_s={makespan} single_s={r.single_times} "
          f"gain={r.gain!r} idle={r.idle_fracs} "
          f"resource_efficiency={r.resource_efficiency!r} "
          f"analytic_s={r.analytic_time!r} "
          f"overlap_s={overlap}")
    if split.get("host", 0) == 0:
        print(f"hybrid {label}: finding: the host group ran 0 units")


def _union_s(spans) -> float:
    """Length in seconds of the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e6


def profiled(torch, label, fn):
    """Run ``fn`` under torch.profiler and print the GPU's busy time
    inside the call's timed windows (the executor's chunk run and merge,
    which it marks with record_function) against the call's
    hybrid_time: the union of the device's kernel, copy and memset
    intervals, so that nothing is counted twice and set-up outside the
    windows (sort's binning) is left out.  Also prints the busy time of
    the whole call, the device time by name inside the windows and
    that of the workload's own kernel (``OWN_KERNEL``), where it has
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hybrid_executor import TIMED_MERGE, TIMED_RUN
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    events = prof.events()
    marks = (TIMED_RUN, TIMED_MERGE)
    # each window is the span of its marker's events: the host's record
    # and, where the main thread launched device work inside it (the
    # merge), the profiler's mirror of it on the device's timeline, an
    # annotation that is no device work and whose device type differs
    # between torch versions.  A call that runs the executor more than
    # once (raycast's two phases) has one window per run: a mirror ends
    # with its record (the timed code synchronises the device before it
    # returns), so a span that starts after the window ends starts a
    # new one
    windows = []
    for mark in marks:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == mark)
        if not spans:
            raise AssertionError(f"{label}: no {mark} window in the "
                                 f"profile")
        lo, hi = spans[0]
        for s0, s1 in spans[1:]:
            if s0 > hi:
                windows.append((lo, hi))
                lo = s0
            hi = max(hi, s1)
        windows.append((lo, hi))
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in marks
              and not getattr(e, "is_user_annotation", False)]
    inside, by_name = [], {}
    for e in device:
        for w0, w1 in windows:
            lo, hi = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if hi > lo:
                inside.append((lo, hi))
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + hi - lo, n + 1)
    busy = _union_s(inside)
    if busy <= 0:
        raise AssertionError(f"{label}: no device time inside the timed "
                             f"windows")
    span = out.result.hybrid_time
    call = _union_s([(e.time_range.start, e.time_range.end)
                     for e in device])
    print(f"hybrid {label}: gpu_busy_s={busy!r} "
          f"gpu_idle_share={1.0 - busy / span!r} "
          f"windows_s={sum(w1 - w0 for w0, w1 in windows) / 1e6!r} "
          f"gpu_busy_call_s={call!r}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    for name, (t, n) in top:
        print(f"hybrid {label}: device {t / 1e3:.3f} ms in {n}  {name[:90]}")
    own = OWN_KERNEL.get(label.split()[0])
    if own is not None:
        mine = [v for name, v in by_name.items() if own in name]
        print(f"hybrid {label}: {own} kernels: device "
              f"{sum(t for t, _ in mine) / 1e3:.4f} ms in "
              f"{sum(n for _, n in mine)}")
    return out


# the kernel each workload's cold and warm calls must launch: sort's
# timed path sorts natively, as the reference's does; it launches the
# hist kernel in its binning, and the bitonic kernel in ``sort leaf``
OWN_KERNEL = {"conv": "conv2d", "hist": "hist", "spmv": "spmv_ell",
              "bilateral": "bilateral", "sort": "hist"}


def hybrid_phase(torch, np):
    """Returns the launch counts of each main-path call ("conv cold",
    "conv warm", ..., "sort leaf"): every count is set to 0 just before
    the call and read just after it."""
    from repro_torch.core import cost_model
    from repro_torch.core.host_offload import bilateral_luts
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels import common
    from repro_torch.kernels.bilateral.bilateral import bilateral_lut_torch
    from repro_torch.kernels.bilateral.ref import bilateral_ref
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.workloads import bilateral, conv, hist, sort, spmv
    from repro_torch.workloads.sort import leaf_sort_bitonic

    ex = HybridExecutor()
    devs = {g.name: [str(d) for d in g.devices] for g in ex.groups}
    print(f"hybrid: groups={devs} simulated={ex.simulated} "
          f"host_threads={torch.get_num_threads()}")
    if ex.simulated or devs != {"accel": ["cuda:0"], "host": ["cpu"]}:
        raise AssertionError(f"expected accel=cuda:0 host=cpu, got {devs}")

    per_call = {}

    def run(label, fn, reference, tol, forced=False, profile=False):
        common.reset_launches()
        t0 = time.perf_counter()
        out = profiled(torch, label, fn) if profile else fn()
        wall = time.perf_counter() - t0
        counts = common.launch_counts()
        print(f"hybrid {label}: launches={counts}")
        workload, kind = label.split()
        entries = common.entry_counts()
        if OWN_KERNEL[workload] in MAIN_ENTRY:
            check_entry(f"hybrid {label}", OWN_KERNEL[workload], counts,
                        entries)
        # the cold calls' profile measurement: K4 on its one-block entry
        first_probe = MAIN_ENTRY["probe_add_one"][1]
        if counts["probe_add_one"] or entries[first_probe]:
            check_entry(f"hybrid {label}", "probe_add_one", counts, entries)
        if kind in ("cold", "warm"):
            per_call[label] = counts
            if counts[OWN_KERNEL[workload]] <= 0:
                raise AssertionError(f"{label}: {OWN_KERNEL[workload]} was "
                                     f"not launched")
        if out.result.mode != "threads":
            raise AssertionError(f"{label}: mode {out.result.mode}")
        value = out.value.cpu()
        if tol == 0:
            if not torch.equal(value, reference):
                raise AssertionError(f"{label}: value differs")
        else:
            torch.testing.assert_close(value, reference, rtol=tol, atol=tol,
                                       msg=lambda m: f"{label}: {m}")
        report(label, out)
        print(f"hybrid {label}: wall_s={wall!r} value ok (tol {tol})")
        if forced and not (out.trace.group_units.get("host", 0) > 0
                           and overlap_s(out.trace) > 0):
            raise AssertionError(f"{label}: the host lane did not run "
                                 f"concurrently with the card")
        return out

    img, w = conv.make_inputs(CONV_SIZE, CONV_K)
    conv_ref = conv2d_ref(torch.tensor(img), torch.tensor(w))
    keys = hist.make_inputs(HIST_N, HIST_BINS)
    hist_ref = torch.tensor(np.bincount(keys, minlength=HIST_BINS)
                            .astype(np.int32))
    A = spmv.make_matrix(SPMV_N, SPMV_DENSITY)
    spmv_ref = torch.tensor((A.astype(np.float64)
                             @ spmv.make_vector(SPMV_N).astype(np.float64))
                            .astype(np.float32))
    print(f"hybrid: spmv at n={SPMV_N} (make_matrix builds a dense n x n "
          f"matrix on the host, so n is cut to what host memory and time "
          f"allow)")

    # each workload's cold call starts, as in a fresh process, with no
    # hardware profile: its calibration measures one (the probe kernel)
    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"conv {label}", lambda: conv.run_hybrid(
            ex, size=CONV_SIZE, ksize=CONV_K), conv_ref, TOL["conv2d"])
    run("conv profiled", lambda: conv.run_hybrid(
        ex, size=CONV_SIZE, ksize=CONV_K), conv_ref, TOL["conv2d"],
        profile=True)
    chunk = CONV_SIZE // ex.n_chunks
    run("conv forced", lambda: conv.run_hybrid(
        ex, size=CONV_SIZE, ksize=CONV_K,
        plan_override=[CONV_SIZE - 2 * chunk, 2 * chunk]),
        conv_ref, TOL["conv2d"], forced=True)

    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"hist {label}", lambda: hist.run_hybrid(
            ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0)
    run("hist profiled", lambda: hist.run_hybrid(
        ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0, profile=True)
    run("hist forced", lambda: hist.run_hybrid(
        ex, n=HIST_N, n_bins=HIST_BINS, plan_override=[56, 8]),
        hist_ref, 0, forced=True)

    cost_model.reset_profiles()
    outs = [run(f"spmv {label}", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4)
        for label in ("cold", "warm")]
    run("spmv profiled", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4, profile=True)
    total = sum(outs[0].plan.units)
    run("spmv forced", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY,
        plan_override=[total - total // 4, total // 4]),
        spmv_ref, 1e-4, forced=True)

    # bilateral: the value against the plain LUT filter over the whole
    # image on the card (independent of the kernel), and a band at each
    # edge against the direct filter on the CPU at the reference
    # test's tolerances
    dev = torch.device("cuda", 0)
    img = bilateral.make_inputs(BILAT_SIZE)
    sp, rl = bilateral_luts(BILAT_SIGMA_S, BILAT_SIGMA_R, BILAT_RADIUS)
    bilat_ref = bilateral_lut_torch(
        torch.tensor(img, device=dev), torch.tensor(sp, device=dev),
        torch.tensor(rl, device=dev)).cpu()
    r, B = BILAT_RADIUS, BILAT_BAND
    bands = [(0, bilateral_ref(torch.tensor(img[:B + r]), BILAT_SIGMA_S,
                               BILAT_SIGMA_R, r)[:B]),
             (BILAT_SIZE - B, bilateral_ref(
                 torch.tensor(img[-B - r:]), BILAT_SIGMA_S, BILAT_SIGMA_R,
                 r)[r:])]
    bilat_kw = dict(size=BILAT_SIZE, sigma_s=BILAT_SIGMA_S,
                    sigma_r=BILAT_SIGMA_R, radius=BILAT_RADIUS)

    def run_bilateral(label, **kw):
        out = run(label, lambda: bilateral.run_hybrid(ex, **bilat_kw, **kw),
                  bilat_ref, TOL["bilateral"], forced="plan_override" in kw,
                  profile=label.endswith("profiled"))
        value = out.value.cpu()
        for lo, band in bands:
            torch.testing.assert_close(
                value[lo:lo + B], band, rtol=5e-3, atol=5e-2,
                msg=lambda m: f"{label} rows {lo}:{lo + B} against the "
                              f"direct filter: {m}")
        print(f"hybrid {label}: rows 0:{B} and {BILAT_SIZE - B}:"
              f"{BILAT_SIZE} match the direct filter (5e-3, 5e-2)")

    cost_model.reset_profiles()
    for label in ("cold", "warm", "profiled"):
        run_bilateral(f"bilateral {label}")
    chunk = BILAT_SIZE // ex.n_chunks
    run_bilateral("bilateral forced",
                  plan_override=[BILAT_SIZE - 2 * chunk, 2 * chunk])

    # sort: exact against np.sort; then the leaf sorter on the card
    keys = sort.make_inputs(SORT_N)
    sort_ref = torch.from_numpy(np.sort(keys))
    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"sort {label}", lambda: sort.run_hybrid(
            ex, n=SORT_N, n_bins=SORT_BINS), sort_ref, 0)
    run("sort profiled", lambda: sort.run_hybrid(
        ex, n=SORT_N, n_bins=SORT_BINS), sort_ref, 0, profile=True)
    run("sort forced", lambda: sort.run_hybrid(
        ex, n=SORT_N, n_bins=SORT_BINS,
        plan_override=[SORT_BINS - SORT_BINS // 8, SORT_BINS // 8]),
        sort_ref, 0, forced=True)

    keys_gpu = common.to_device(keys, dev)
    common.reset_launches()
    t0 = time.perf_counter()
    value = leaf_sort_bitonic(keys_gpu, tile=SORT_TILE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = common.launch_counts()
    per_call["sort leaf"] = counts
    print(f"hybrid sort leaf: launches={counts}")
    check_entry("hybrid sort leaf", "sort_bitonic", counts,
                common.entry_counts())
    if not (torch.equal(value, torch.sort(keys_gpu).values)
            and torch.equal(value.cpu(), sort_ref)):
        raise AssertionError("sort leaf: value differs from torch.sort")
    print(f"hybrid sort leaf: rows=({SORT_N // SORT_TILE}, {SORT_TILE}) "
          f"wall_s={wall!r} value ok (exact against torch.sort and "
          f"np.sort)")

    for workload in OWN_KERNEL:
        if per_call[f"{workload} cold"]["probe_add_one"] <= 0:
            raise AssertionError(f"{workload} cold: the calibration did "
                                 f"not launch probe_add_one")
    return per_call


# ---------------------------------------------------------------------------
# the other eight Table-1 workloads on the real pair
# ---------------------------------------------------------------------------
def _canonical(np, labels):
    """Relabel each component by its least vertex."""
    _, first, inv = np.unique(labels, return_index=True,
                              return_inverse=True)
    return first[inv]


def table1_value(torch, np, name, out, refs) -> str:
    """Hold one call's value to its check; ``refs`` keeps the CPU-side
    references between a workload's calls.  Returns what was checked."""
    import importlib
    mod = importlib.import_module(f"repro_torch.workloads.{name}")
    kw = TABLE1_SIZES[name]
    value = out.value
    if name == "spgemm":
        if name not in refs:
            A, B = mod.make_matrices(kw["n"], kw["density"])
            refs[name] = A.astype(np.float64) @ B.astype(np.float64)
        np.testing.assert_allclose(value.cpu().numpy(), refs[name],
                                   rtol=2e-3, atol=2e-3)
        return "against A @ B in float64 (2e-3)"
    if name == "raycast":
        if name not in refs:
            vol, ro, rd = mod._placed(kw["n_rays"], kw["d"], "cpu")
            refs[name] = mod.march(vol, ro, rd, mod.entry(ro, rd))
        c = value.cpu()
        torch.testing.assert_close(c, refs[name], rtol=1e-4, atol=1e-4)
        if not (c.min() >= 0 and c.max() > 0):
            raise AssertionError("raycast: no ray hit the volume")
        return "against the port's CPU value on every ray (1e-4)"
    if name == "montecarlo":
        if name not in refs:
            refs[name] = float(mod.simulate_photons(
                mod._placed(kw["n_photons"], "cpu")))
        if abs(value - refs[name]) > 1e-5 * abs(refs[name]):
            raise AssertionError(f"montecarlo: {value!r} against the CPU's "
                                 f"{refs[name]!r}")
        return f"{value!r} against the CPU value (1e-5 relative)"
    if name == "listrank":
        succ, head = mod.make_list(kw["n"])
        rank = value.cpu().numpy().astype(np.int64)
        tail = succ == np.arange(kw["n"])
        # the tail is 0, the head n-1, every other node one more than
        # its successor: the ranks walk the list
        if not (rank[head] == kw["n"] - 1 and (rank[tail] == 0).all()
                and (rank[~tail] == rank[succ[~tail]] + 1).all()):
            raise AssertionError("listrank: the ranks do not walk the list")
        return "the ranks walk the list exactly"
    if name == "concomp":
        if name not in refs:
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components
            n, edges = mod.make_graph(kw["n"], kw["avg_deg"])
            adj = coo_matrix((np.ones(len(edges)), (edges[:, 0],
                                                    edges[:, 1])),
                             shape=(n, n))
            refs[name] = _canonical(
                np, connected_components(adj, directed=False)[1])
        if not np.array_equal(_canonical(np, value), refs[name]):
            raise AssertionError("concomp: not scipy's partition")
        return (f"scipy's partition ({len(np.unique(refs[name]))} "
                f"components)")
    if name == "lbm":
        f0 = mod.init_state(kw["d"])
        if name not in refs:
            one = mod.step_all(torch.from_numpy(f0))
            cur = one
            for _ in range(kw["n_steps"] - 1):
                cur = mod.step_all(cur)
            refs[name] = one, cur
        one, cur = refs[name]
        card = mod.step_all(torch.from_numpy(f0).to(value.device)).cpu()
        torch.testing.assert_close(card, one, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(value.cpu(), cur, rtol=1e-5, atol=1e-5)
        mass0 = float(f0.astype(np.float64).sum())
        mass = float(value.double().sum())
        if abs(mass - mass0) > 1e-4 * abs(mass0):
            raise AssertionError(f"lbm: mass {mass!r} against {mass0!r}")
        return ("one step_all on the card and the hybrid steps against "
                "step_all on the CPU (1e-5), mass conserved (1e-4)")
    if name == "dither":
        if name not in refs:
            refs[name] = mod.fsd_dither(torch.from_numpy(
                mod.make_image(kw["h"], kw["w"])))
        if not torch.equal(value.cpu(), refs[name]):
            raise AssertionError("dither: differs from the CPU's")
        return "equal to the port's CPU fsd_dither"
    # bundle
    if name not in refs:
        cams, pts, obs = (torch.from_numpy(a) for a in mod.make_problem(
            kw["n_cams"], kw["n_pts"]))
        refs[name] = float(torch.sum(mod.residuals(cams, pts, obs) ** 2))
    if not (np.isfinite(value) and value < refs[name]):
        raise AssertionError(f"bundle: error {value!r} from {refs[name]!r}")
    return f"reprojection error {refs[name]!r} -> {value!r}"


def table1_phase(torch, np) -> None:
    """The other eight Table-1 workloads on the real pair
    (``HybridExecutor()``): a cold and a warm call each, and a profiled
    warm call for those that run through the executor's chunks (mode
    ``threads``); every value held to its check."""
    import importlib

    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels import common
    ex = HybridExecutor()
    refs = {}
    for name, kw in TABLE1_SIZES.items():
        mod = importlib.import_module(f"repro_torch.workloads.{name}")
        kinds = ("cold", "warm") + (("profiled",) if name in CHUNKED
                                    else ())
        for kind in kinds:
            label = f"{name} {kind}"
            common.reset_launches()
            t0 = time.perf_counter()
            if kind == "profiled":
                out = profiled(torch, label,
                               lambda: mod.run_hybrid(ex, **kw))
            else:
                out = mod.run_hybrid(ex, **kw)
            wall = time.perf_counter() - t0
            print(f"hybrid {label}: size={kw} launches="
                  f"{common.launch_counts()}")
            if name in CHUNKED and out.trace.mode != "threads":
                raise AssertionError(f"{label}: mode {out.trace.mode}")
            report(label, out)
            what = table1_value(torch, np, name, out, refs)
            print(f"hybrid {label}: wall_s={wall!r} value ok ({what})",
                  flush=True)


# ---------------------------------------------------------------------------
# table2 and the figures, on the simulated pair on the card
# ---------------------------------------------------------------------------
def table2_phase(torch):
    """The port's ``table2_hybrid.run()``: all 13 workloads at both
    ratios on the simulated pair on cuda:0, a cold pass and then two
    warm ones.  In the cold pass each row's single times and plan are
    the cost model's prior after one update; in the warm passes they
    are the unit times the pass before measured (the process's
    calibration store), so their rows read the pair.  K1, K2, K3 and K6
    must launch on their redesigned entries in every pass, and K4 in
    the cold calibrations (the hardware profile is measured anew
    first).  Returns the launch counts of the cold pass."""
    from repro_torch.benchmarks import table2_hybrid
    from repro_torch.core import cost_model
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels import common
    ex = HybridExecutor(force_simulated=True)
    devs = [str(d) for g in ex.groups for d in g.devices]
    print(f"table2: groups={devs} simulated={ex.simulated} "
          f"backend={ex.backend}")
    if devs != ["cuda:0", "cuda:0"] or not ex.simulated:
        raise AssertionError(f"table2: expected the simulated pair on "
                             f"cuda:0, got {devs}")
    cost_model.reset_profiles()
    cold = None
    for label in ("cold", "warm 1", "warm 2"):
        print(f"table2: pass={label}", flush=True)
        common.reset_launches()
        t0 = time.perf_counter()
        results = table2_hybrid.run()
        wall = time.perf_counter() - t0
        counts, entries = common.launch_counts(), common.entry_counts()
        print(f"table2 {label}: launches={counts} wall_s={wall!r}")
        names = ("conv2d", "hist", "spmv_ell", "bilateral")
        if cold is None:
            cold = counts
            names += ("probe_add_one",)
        for name in names:
            check_entry(f"table2 {label}", name, counts, entries)
        for pname, rs in results.items():
            if len(rs) != 13 or not all(
                    r.hybrid_time > 0 and math.isfinite(r.gain) for r in rs):
                raise AssertionError(
                    f"table2 {label} {pname}: {[r.row() for r in rs]}")
            modes = {r.mode for r in rs if r.mode}
            if modes != {"virtual"}:
                raise AssertionError(f"table2 {label} {pname}: modes {modes}")
    return cold


def figures_phase(torch):
    """Fig. 4, the split sweep and Fig. 3 at the reference's defaults,
    on the simulated pair on cuda:0.  Returns the launch counts."""
    from repro_torch.benchmarks import fig3_scaling, fig4_overlap, split_sweep
    from repro_torch.kernels import common
    common.reset_launches()
    t0 = time.perf_counter()
    out = fig4_overlap.run()
    if out.result.mode != "virtual" or out.trace.group_units.get(
            "accel", 0) <= 0:
        raise AssertionError(f"fig4: {out.result.row()}")
    split_sweep.run()
    fig3_scaling.run()
    counts, entries = common.launch_counts(), common.entry_counts()
    print(f"figures: launches={counts} "
          f"wall_s={time.perf_counter() - t0!r}")
    for name in ("conv2d", "hist", "spmv_ell"):
        check_entry("figures", name, counts, entries)
    return counts


# ---------------------------------------------------------------------------
# LM phase
# ---------------------------------------------------------------------------
def profile_window(torch, label, fn, top=6):
    """``fn()`` and a synchronisation under torch.profiler: the GPU's
    busy time (union of its kernel, copy and memset intervals) inside
    the window (the host's span of the call and its synchronisation),
    the idle share, and the device time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = f"lm:{label}"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(mark):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == mark]
    w0, w1 = min(lo for lo, _ in spans), max(hi for _, hi in spans)
    inside, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == mark \
                or getattr(e, "is_user_annotation", False):
            continue
        lo, hi = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if hi > lo:
            inside.append((lo, hi))
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + hi - lo, n + 1)
    busy = _union_s(inside)
    if busy <= 0:
        raise AssertionError(f"{label}: no device time in the window")
    window = (w1 - w0) / 1e6
    print(f"{label}: window_s={window!r} gpu_busy_s={busy!r} "
          f"gpu_idle_share={1.0 - busy / window!r}")
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        print(f"{label}: device {t / 1e3:.3f} ms in {n}  {name[:90]}")


def lm_phase(torch, dev):
    """Serve kimi-k2 (full width, depth 2) through ``generate`` with K7
    and K8, then with their plain versions; returns the launch counts
    of the ``generate`` call, its per-prefill and per-step counts, and
    the model's parameters (the K7/K8 rows use its expert weights)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.models import model_zoo
    from repro_torch.models.param import count_params, param_bytes
    from repro_torch.serve.plain_check import (MARGIN, check_tokens,
                                               greedy_with_gaps,
                                               plain_kernels)
    from repro_torch.serve.serve_step import (generate, make_prefill_step,
                                              make_serve_step)

    cfg = registry.get(LM_ARCH).replace(n_layers=LM_LAYERS)
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"lm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads}x{cfg.head_dim} experts={m.n_routed} "
          f"top{m.top_k} d_ff={m.d_ff}/{cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.n_layers} (of 61: the dense layer and {n_moe} MoE) "
          f"params={count_params(params)} weights_bytes="
          f"{param_bytes(params)} init_s={time.perf_counter() - t0!r}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)

    # the main path: one generate call through K7 and K8
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    passes = 1 + m.overflow_passes
    want = {"flash_attention": cfg.n_layers,
            "gmm": 3 * passes * n_moe * (1 + LM_NEW)}
    entries = common.entry_counts()
    print(f"lm generate: batch={LM_BATCH} prompt={LM_PROMPT} "
          f"new={LM_NEW} tokens={tuple(toks.shape)} wall_s={wall!r} "
          f"peak_bytes={peak} launches={counts} predicted={want}",
          flush=True)
    print(f"lm generate: launches by entry: " + ", ".join(
        f"{e}={entries[e]}" for pair in LM_ENTRY.values() for e in pair))
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"lm generate: {name} launched "
                                 f"{counts[name]} times, predicted {n}")
        tensor_core, cuda_core = LM_ENTRY[name]
        if entries[tensor_core] != n or entries[cuda_core]:
            raise AssertionError(
                f"lm generate: {name} went {entries[tensor_core]} times "
                f"through {tensor_core} and {entries[cuda_core]} through "
                f"{cuda_core}; all {n} must take the tensor cores")
    if toks.shape != (LM_BATCH, LM_NEW + 1) or toks.dtype != torch.int32 \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"lm generate: bad tokens {toks}")

    # per call: one prefill, then the decode steps, each synchronised
    L = LM_PROMPT + LM_NEW
    per = {}
    with torch.inference_mode():
        prefill = make_prefill_step(cfg, cache_len=L)
        step = make_serve_step(cfg)
        common.reset_launches()
        t0 = time.perf_counter()
        tok, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per["prefill"] = common.launch_counts()
        tok = tok.to(torch.int32)
        step_s = []
        for t in range(LM_NEW):
            common.reset_launches()
            t0 = time.perf_counter()
            tok, caches = step(params, tok, caches, LM_PROMPT + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per["decode step"] = common.launch_counts()
        decode_s = statistics.median(step_s)
        print(f"lm prefill: s={prefill_s!r} tokens_per_s="
              f"{LM_BATCH * LM_PROMPT / prefill_s!r} "
              f"launches={per['prefill']}")
        print(f"lm decode: median_step_s={decode_s!r} "
              f"min_step_s={min(step_s)!r} tokens_per_s="
              f"{LM_BATCH / decode_s!r} launches_per_step="
              f"{per['decode step']}", flush=True)
        profile_window(torch, "lm decode profiled",
                       lambda: step(params, tok, caches, L - 1))
        del caches
        # the prefill's device time by kernel: K7, K8, the dense layers
        # and the copies around K7 (flash_attention.ops._flatten_gqa)
        profile_window(torch, "lm prefill profiled",
                       lambda: prefill(params, {"tokens": prompt}), top=12)

    # the plain path: the same greedy run with K7 and K8 swapped out
    common.reset_launches()
    with plain_kernels():
        plain, gaps, plain_last = greedy_with_gaps(cfg, params, prompt,
                                                   LM_NEW)
    if common.launch_counts()["gmm"] or \
            common.launch_counts()["flash_attention"]:
        raise AssertionError("lm plain path launched K7 or K8")
    _, _, kern_last = greedy_with_gaps(cfg, params, prompt, 0)
    try:
        differed = check_tokens(toks, plain, gaps)
    except AssertionError as e:
        raise AssertionError(f"lm check: {e}") from None
    for b, t, gap in differed:
        print(f"lm: row {b} differs first at token {t} ({int(toks[b, t])} "
              f"vs {int(plain[b, t])}), plain top-1/top-2 gap {gap!r}")
    print(f"lm check: {LM_BATCH - len(differed)} of {LM_BATCH} rows equal "
          f"to the plain path's tokens; the others pass the margin rule "
          f"(gap < {MARGIN}); last prompt position's logits max |diff| "
          f"{(kern_last - plain_last).abs().max().item()!r}; min gap "
          f"{gaps.min().item()!r}", flush=True)
    return counts, per, cfg, params


def lm_kernel_rows(torch, dev, flush, cfg, params):
    """K7 and K8 against their plain versions at the main path's shapes
    (the JSON rows: K7 at prefill, K8 at each of its five shapes: decode
    and prefill up and down, the prefill's tail pass) and at ragged
    shapes, with the library call and the route (C entry) beside each."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.flash_attention import (
        route as flash_route)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch
    from repro_torch.kernels.gmm.gmm import route as gmm_route

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    def check(name, out, ref, what):
        tol = TOL[name]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol,
                                   msg=lambda msg: f"{name} {what}: {msg}")
        return (out.float() - ref.float()).abs().max().item()

    def attn_plain(q, k, v, causal):
        rep = q.shape[0] // k.shape[0]
        return attention_ref(q, k.repeat_interleave(rep, 0),
                             v.repeat_interleave(rep, 0), causal)

    for BH, BHkv, T, S, d, causal in [(8, 4, 100, 100, 80, True),
                                      (16, 2, 77, 130, 112, False),
                                      (4, 1, 200, 130, 128, True),
                                      (6, 3, 65, 65, 32, False)]:
        q, k, v = randn(BH, T, d), randn(BHkv, S, d), randn(BHkv, S, d)
        check("flash_attention", flash_attention_cuda(q, k, v, causal),
              attn_plain(q, k, v, causal), f"BH={BH}/{BHkv} T={T} S={S} "
              f"d={d} causal={causal}")
    B, H, Kv, T, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, \
        cfg.head_dim
    q, k, v = randn(B * H, T, d), randn(B * Kv, T, d), randn(B * Kv, T, d)
    err = check("flash_attention", flash_attention_cuda(q, k, v, True),
                attn_plain(q, k, v, True), "main path (prefill)")
    q4, k4, v4 = (t.view(B, -1, T, d) for t in (q, k, v))
    pairs = T * (T + 1) // 2                      # causal (q, k) pairs
    rows = [kernel_row(
        "flash_attention", err,
        time_ms(torch, lambda: flash_attention_cuda(q, k, v, True), flush),
        time_ms(torch, lambda: attn_plain(q, k, v, True), flush, iters=10),
        4.0 * B * H * pairs * d, 2.0 * (2 * B * H + 2 * B * Kv) * T * d,
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), flush),
        f"prefill: BH={B * H}/{B * Kv} T=S={T} d={d} causal",
        PEAK_BF16_FLOPS, entry=flash_route(q.dtype, d))]
    del q, k, v, q4, k4, v4

    # the model path calls K7 through ops.flash_attention, which takes
    # (B, T, H, d) and copies q/k/v to (B*H, T, d) first
    # (_flatten_gqa): its time beside the kernel's is the copies' cost
    qm, km, vm = randn(B, T, H, d), randn(B, T, Kv, d), randn(B, T, Kv, d)
    ops_ms = time_ms(torch, lambda: flash_ops.flash_attention(qm, km, vm),
                     flush)
    print(f"kernel flash_attention model layout: ops.flash_attention "
          f"{ops_ms:.4f} ms, the kernel alone {rows[0]['ms']:.4f} ms "
          f"(the difference: _flatten_gqa's copies)")
    del qm, km, vm

    # host cost of a call on each route at a shape whose kernel takes a
    # few microseconds: the tensor-core route also encodes three TMA
    # tensor maps (cuTensorMapEncodeTiled) on every call
    qs = randn(1, 64, 64)
    for label, x in (("wgmma (bf16)", qs), ("fma (f32)", qs.float())):
        flash_attention_cuda(x, x, x, True)
        torch.cuda.synchronize()
        n = 2000
        t0 = time.perf_counter()
        for _ in range(n):
            flash_attention_cuda(x, x, x, True)
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        print(f"kernel flash_attention host: {label} route "
              f"{host_us:.2f} us a call (BH=1 T=S=64 d=64)")

    for E, C, D, F_ in [(3, 1, 40, 24), (5, 7, 33, 130), (6, 13, 100, 11),
                        (2, 200, 64, 72)]:
        x, w = randn(E, C, D), randn(E, D, F_, scale=D ** -0.5)
        check("gmm", gmm_cuda(x, w), gmm_torch(x, w),
              f"E={E} C={C} D={D} F={F_}")
    ffn = params["stack"]["groups"][0]["l0"]["ffn"]
    m = cfg.moe
    C = max(1, int(LM_PROMPT * m.top_k / m.n_routed * m.capacity_factor))
    # (label, C rows, weight): decode's up projection is the JSON row
    shapes = [("decode up", LM_BATCH, ffn["w_up"]),
              ("decode down", LM_BATCH, ffn["w_down"]),
              ("prefill up", LM_BATCH * C, ffn["w_up"]),
              ("prefill down", LM_BATCH * C, ffn["w_down"]),
              ("prefill tail up", LM_BATCH * max(1, C // 4), ffn["w_up"])]
    for label, c, w in shapes:
        E, D, F_ = w.shape
        x = randn(E, c, D)
        err = check("gmm", gmm_cuda(x, w), gmm_torch(x, w), label)
        rows.append(kernel_row(
            "gmm", err, time_ms(torch, lambda: gmm_cuda(x, w), flush),
            time_ms(torch, lambda: gmm_torch(x, w), flush, iters=10),
            2.0 * E * c * D * F_, 2.0 * E * (c * D + D * F_ + c * F_),
            time_ms(torch, lambda: torch.bmm(x, w), flush),
            f"{label}: E={E} C={c} D={D} F={F_}", PEAK_BF16_FLOPS,
            entry=gmm_route(x.dtype, D, F_)))
    return rows


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        fail("src/repro_torch/csrc not found beside this script: run it "
             "from a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA GPU")
    os.environ["REPRO_CALIB_CACHE"] = "0"
    sys.path.insert(0, SRC)
    from repro_torch.kernels import common

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    common.kernel_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {common.BUILD_DIR}")
    ptxas_report(common.build_log())

    dev = torch.device("cuda", 0)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    rows = kernel_phase(torch, np, dev, flush)
    del flush

    per_call = hybrid_phase(torch, np)
    lm_counts, lm_per, lm_cfg, lm_params = lm_phase(torch, dev)
    per_call["lm generate"] = lm_counts
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    rows += lm_kernel_rows(torch, dev, flush, lm_cfg, lm_params)
    del flush, lm_params
    # after the LM, so that the inputs these phases keep on the card
    # (montecarlo's 512 MB stream among them) stay out of its peak
    per_call["table2"] = table2_phase(torch)
    per_call["figures"] = figures_phase(torch)
    table1_phase(torch, np)
    for r in rows:
        if r["name"] in LM_ENTRY:
            r["launches_per_prefill"] = lm_per["prefill"][r["name"]]
            r["launches_per_decode_step"] = \
                lm_per["decode step"][r["name"]]
    # the main path: the cold and the warm call of each workload, sort's
    # leaf sorter, table2, the figures and the LM's generate call
    for r in rows:
        r["launches_per_call"] = {label: c[r["name"]]
                                  for label, c in per_call.items()}
        r["launches"] = sum(r["launches_per_call"].values())
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on the "
                                 f"main path")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
