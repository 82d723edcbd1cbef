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
   forced split that puts an eighth of the work on the CPU, the card's
   share sized to take at least ``FORCED_CARD_S`` (a finer chunk grid
   until a card-alone call's measured chunk time says it does; hist
   forced at 2^27 keys, sort at 1024 bins; spmv, one chunk a share,
   packs its card share anew in that call and the forced one, and is
   sized from its time a unit), the line printing the host
   lane's first chunk start and the card lane's last chunk end, then
   sort's leaf sorter
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
6. Serve phase (the serving core): ``Scheduler()`` on the real pair,
   cold, serves an open-loop Poisson stream (6 req/s for 10 s) of the
   hybrid phase's workloads (hist and sort cut; spmv at two densities)
   and then a burst of same-bucket requests that coalesce and merge:
   per workload the placements and latency percentiles, the audited
   invariant with nothing in flight, the placement audit, the GPU's
   idle share over the run; every value against its check, every
   demuxed row bitwise its member's solo run on the same device, a
   dedicated execution on each group on its own device, K1-K4, K6 and
   K7 (f32) on their entries.  Then the LM's weights served through
   ``launch/serve.py``'s ``run_stream`` on the accel group alone (each
   request's tokens equal to a solo ``generate``, K7/K8 on the tensor
   cores), and ``launch/serve.py --hybrid`` at kimi-k2's reduced config
   cold and warm (the GPU's rows equal to a solo ``generate`` on the
   GPU, the host's on the CPU copy, held to it under the margin rule).
   Then the continuous-batching engine, the LM's weights still on the
   card: (a) a scheduler over the accel group serves a burst of 8
   batch-1 requests (1024 + 16 tokens) through the slot-batched step
   (4 slots), then ``run_stream(continuous=True)`` at 1 req/s for 6 s:
   steps, joins, evictions, the most live rows, per-step time by live
   rows, each request's time to first token and latency, K7/K8
   launches per prefill and per step by C entry (all on the tensor
   cores), the GPU's idle share in one profiled step, the slot-batched
   step's logits against B = 1 steps (teacher-forced), each request's
   tokens against a solo ``generate`` at B = 1; (b) the same burst with
   the engine off (``REPRO_SERVE_CONTINUOUS=0``); (c) kimi-k2
   ``reduced()`` on the real pair, cold: the engine's lanes from the
   priors with no probe, tokens against a solo ``generate`` on the
   decode lane's device (the margin rule where prefill and decode ran
   on two devices); (d) the listrank, lbm and dither steppers on the
   real pair, each value bitwise its solo ``run_one`` on the decode
   lane's device; (e) ``launch/serve.py --stream --continuous``.
   Then, on the same weights, the ``lm tuned`` phase: ``generate`` at
   4 x 1024 + 16 against a default run (tp = 1, no pin, no hit): (a)
   at tp = 16 (kv_repeat 2: the caches' bytes twice tp = 1's, K7 on its
   tensor-core entry over 16 K/V heads a row, the prefill's logits
   against tp = 1's); (b) ``REPRO_TUNE_PIN_FLASH_ATTENTION`` on the
   blocked attention, then ``REPRO_TUNE_PIN_GMM`` on the einsum: the
   pinned kernel launches 0 times, the other as in the default run;
   (c) a tune-cache hit (``REPRO_AUTOTUNE=1``, a throwaway tune file,
   a timer that fails if called): K7's prefill bucket on its CUDA-core
   entry, K8's decode up/gate bucket on the einsum, with the launches
   that moves; each run's tokens against the default run's under the
   margin rule; (d) K7's row at the tp = 16 prefill shape.
   Also K7's f32 entry at the serve stream's attention shape (4 x 1024,
   64/8 heads, d = 112, causal) against its plain version and SDPA in
   f32, its launches per serve-stream run.
   Then (after the continuous phase, kimi-k2's weights freed) the
   model families: (a) deepseek-v2-lite-16b, full width and all 27
   layers (MLA + 64 experts top-6, ~31 GB of bf16 weights from seed 0),
   greedy ``generate`` at batch 4 x 1024 + 16: K8's launches per
   prefill and per step (all on ``gmm_wgmma_bf16``), prefill and step
   times, peak memory, the tokens against the plain path under the
   margin rule, K8's rows at the prefill (C = 480) and decode (C = 4)
   shapes on the model's expert weights beside ``torch.bmm``; then, on
   the same weights, the mesh (``deepseek mesh ...`` lines): a
   one-device mesh over cuda:0 (nccl, one rank), (a) the baseline's
   prefill and 4 decode steps under ``use_mesh`` bitwise the no-mesh
   logits with the same K8 launches, (b) ``get_optimized``'s shard_map
   MoE (one-hot dispatch, capacity 1.05) through one ``generate`` of
   1 x 1024 + 8 under the mesh, K8 3 times per MoE layer a forward, its
   prefill and step times and K8's rows at the smap shapes (C = 100 at
   prefill, C = 1 at decode), (c) layer 1's MoE in the smap form
   against the dense one at a capacity that drops nothing, within 1e-2;
   (b)
   minicpm3-4b, full width, cut to 31 of its 62 MLA layers, on the continuous
   engine: a burst of 8 batch-1 requests (1024 + 16) into 4 slots, each
   request's tokens bitwise a solo ``generate`` and the 4-slot step's
   logits bitwise four B = 1 steps'; (c) whisper-tiny, full config, at
   batch 4: the encoder over 1500 frames, the decoder teacher-forced
   over 448 tokens and 16 decode steps against its logits (atol 0.25,
   rtol 0.1), K7's full route launched at T = S = 1500, T = 448 and
   T = 1 against S = 1500, every launch held against its plain version,
   K7's rows at the three shapes beside SDPA.
   Then the recurrent families: (d) xlstm-350m, full width, one of its
   three 8-layer groups (7 mLSTM, 1 sLSTM; no kernel of the port: the
   reference computes it in plain ``jnp``), greedy ``generate`` at 4 x 1024 + 16
   (prefill and step times, peak memory, the GPU's idle share in a
   profiled step and a profiled 4-slot step), the gap of 16
   teacher-forced decode steps to the forward's logits (printed: at
   full width the reference itself misses atol 0.25), the chunkwise
   and recurrent mLSTM forms in f32 at its head shapes (atol 2e-5, rtol
   2e-4) and the reference's own decode-consistency test config (atol
   0.25) on the card, the continuous engine (8
   batch-1 requests into 4 slots, tokens bitwise a solo ``generate``,
   the 4-slot step's logits bitwise four B = 1 steps') and
   ``launch/serve.py --arch xlstm-350m --full --stream --continuous``
   (1 s at 4 req/s, 4 new tokens: the engine's priors put its decode
   lane on the CPU);
   (e) jamba-1.5-large at full width, cut to one group's first five
   layers (4 mamba, 2 of them MoE; attention with the dense MLP; ~24 B
   parameters, ~48 GB in bf16), greedy ``generate`` at 4 x 1024 + 16:
   K7 (64/8 heads, d = 128, causal) held against its plain version at
   its one prefill launch, K7 and K8 on their tensor-core entries, K8's
   launches per prefill and per step, the tokens against the plain path
   under the margin rule, the decode steps' gap to the forward
   (printed), its mamba layer's full and decode forms in f32 (1e-5,
   1e-4), K7's row at the prefill shape beside SDPA and K8's at C = 640
   and C = 4 on the model's expert weights beside ``torch.bmm``.
   Then the fleet (the router and transport): (a) two ``InProcWorker``s,
   each a ``Scheduler()`` on the real pair, behind the ``Router``: every
   payload of the serve phase's Table-1 mix once on each, one at a
   time, then its stream (6 req/s, 6 s) under ``torch.profiler``:
   latency percentiles, throughput, requests per worker, the GPU's idle
   share, every value against the serve phase's references; (b) two
   ``ProcWorker`` children on cuda:0 sharing one calibration store: the
   compute processes on the card and each child's own CUDA memory, the
   same warm-up, then the stream for
   8 s with a scripted ``ChaosInjector`` (SIGSTOP then SIGKILL of the
   worker that owns the most keys at 40 % of the trace, the kill held
   until a request waits on it; its restart at 70 %): every future
   resolved once, nothing dropped, the death detected, its requests
   resubmitted, the restarted child rejoined, every value against the
   references; then ``serving_bench.fleet_cold_join_check`` (a cold
   child on a warm shared store probes nothing); K1-K4, K6 and K7 (f32)
   launched on their entries by (a)'s workers and (b)'s children (their
   launch counts ride their heartbeats).  Then the scenarios:
   the port's ``run_scenarios`` over its six specs (copies of the
   reference's), each through a fresh ``Scheduler()`` on the real pair:
   p95 and goodput per SLO class, the counters, the trace digest, the
   accounting invariant, the chaos scenario's lane death, every
   closed-loop request answered.  Then training (``train ...`` lines),
   then the mesh tools, in four child processes started together:
   ``launch/dryrun.py`` on whisper-tiny's decode_32k and
   h2o-danube-1.8b's train_4k at full depth, ``launch/hillclimb.py``'s
   probe of deepseek-v2-lite-16b's train_4k as the baseline and with
   ``moe.shard_mode=smap``, all on the fake 16x16 mesh: each record and
   wall time, CUDA uninitialised in every child, no launch and no
   allocated byte in this process, the smap probe's all-to-all > 0,
   the cells' roofline rows on the H100 SXM's data-sheet constants
   beside the card's name and power limit, the phase <= 60 s.
7. Table 2 phase: the port's ``table2_hybrid.run()``, all 13 Table-1
   workloads at both of the paper's ratios (10 and 3.9) on the
   simulated pair on the GPU (``force_simulated``), a cold pass (its
   rows read the cost model's prior) and two warm passes (their rows
   read the unit times measured before), with K1, K2, K3 and K6 on
   their redesigned entries and K4 in the cold calibrations;
   then Fig. 4 (``fig4_overlap``), the split sweep and Fig. 3 at the
   reference's defaults, on the same pair.
8. The other eight Table-1 workloads on the real pair: spgemm (n=4096,
   density 0.02), raycast (2^20 rays, d=128), montecarlo (2^22
   photons), listrank (2^22 nodes), concomp (2^17 vertices), lbm
   (128^3, 4 steps), dither (1024x1024) and bundle (16 cameras, 4096
   points), a cold and a warm call each and a profiled warm call for
   the four that run through the executor's chunks; each value held
   to its check (spgemm against A @ B in f64, raycast, montecarlo,
   lbm and dither against the port's CPU values, listrank's ranks
   walking the list, concomp against scipy's components, bundle's
   error falling).
9. Autotune phase (every phase before it runs with ``REPRO_AUTOTUNE=0``,
   so each kernel stays on its route's C entry): the search on, with a
   throwaway tune file under ``src/repro_torch/build/autotune/``; K1-K3
   and K5-K8 tuned at the main path's shapes (conv's chunk, hist's
   2^22 keys, spmv's heavy and light tiles, sort's rows, bilateral's
   chunk, K7 at the LM's prefill, K8 at its decode step): one line per
   candidate the search measured and the winner (a native winner is
   printed as a finding: ``autotune <kernel> winner=... (not the CUDA
   kernel)``), a second resolution that must measure nothing, then
   every candidate of each space timed with CUDA events and held
   against the plain version; conv and hist tuned on the host CPU at
   the host lane's chunk shapes; one conv ``run_hybrid`` on the real
   pair, cold (each lane searches its own winner) then warm; and the
   port-side ``overlap_check``, ``cold_start`` (subprocesses that
   import only ``repro_torch``) and ``fig5_tasks`` at the reference's
   defaults.
10. Prints the kernels' numbers as one JSON line, the card line again,
   and, last, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It also exits
non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  The calibration store is kept in memory
(``REPRO_CALIB_CACHE=0``): the run writes nothing outside the checkout
but for the kernel build and the throwaway stores of the fleet and the
autotune phase, all under ``src/repro_torch/build/``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
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
       "gmm": 1e-2, "flash_attention_f32": 2e-5}
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
# the CUDA-core entries of K7 and K8 live in the first versions' sources
ENTRY_SOURCE = {
    **dict.fromkeys(("flash_attention_fma_f32", "flash_attention_fma_bf16"),
                    "src/repro_torch/csrc/flash_attention.cu"),
    **dict.fromkeys(("gmm_fma_f32", "gmm_fma_bf16"),
                    "src/repro_torch/csrc/gmm.cu")}
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
# a forced split's card share must outlast the host lane's start: the
# host lane's thread needs the interpreter lock while the card lane's
# thread launches, and a thread waiting for it gets it after at most a
# switch interval (5 ms) at each of its two handoffs (the thread's
# start, its first chunk).  Each forced call's card share is sized from
# a measured card time to at least twice that
FORCED_CARD_S = 4 * sys.getswitchinterval()
# the forced calls' finer grids need more units than the main calls
# have: hist twice the keys in 4096 units (its own calibration key),
# sort its keys in 1024 bins
HIST_FORCED_N, HIST_FORCED_UNITS = 2 * HIST_N, 4096
SORT_FORCED_BINS = 1024
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
# those whose profiled call pins the card seven eighths of the units
PINNED_PROFILE = ("montecarlo",)
LM_ARCH, LM_LAYERS = "kimi-k2-1t-a32b", 2
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 16
# the serve stream's attention requests, K7's f32 row
SERVE_ATTN = dict(B=4, T=1024, H=64, Kv=8, d=112)
K7_F32_ENTRY = "flash_attention_fma_f32"
# launches by C entry of the phases that record them (the f32 row's
# launches per serve-stream run)
PHASE_ENTRIES = {}


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
    ``peak_flops``.  ``entry``: the C entry point (route) that ran; its
    source file is the row's."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    src, rep = SOURCE[name]
    src = ENTRY_SOURCE.get(entry, src)
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


def lanes_s(trace):
    """(the host lane's first chunk start, the card lane's last chunk
    end), seconds since the call's start; None for a lane that ran no
    chunk."""
    starts = [r.t_start for r in trace.records if r.group == "host"]
    ends = [r.t_end for r in trace.records if r.group == "accel"]
    return (min(starts) if starts else None, max(ends) if ends else None)


def report(label, out, lanes: bool = False) -> None:
    """The call's split and the paper's metrics.  A call with no chunk
    trace (the task-graph workloads, lbm's plane split) reports its
    plan's units as the split, mode ``none``, and no makespan or
    overlap.  ``lanes``: also the host lane's first chunk start and the
    card lane's last chunk end (the forced calls' overlap check)."""
    r, trace = out.result, out.trace
    if trace is None:
        split = dict(zip(r.busy_times, out.plan.units))
        mode = makespan = overlap = "none"
    else:
        split = {g: trace.group_units.get(g, 0) for g in r.busy_times}
        mode = trace.mode
        makespan, overlap = repr(trace.makespan), repr(overlap_s(trace))
    extra = ""
    if lanes:
        host_start, card_end = lanes_s(trace)
        extra = (f" host_first_start_s={host_start!r} "
                 f"card_last_end_s={card_end!r}")
    print(f"hybrid {label}: mode={mode} split={split} "
          f"plan={out.plan.units} chunks={r.n_chunks} steals={r.steals} "
          f"hybrid_time_s={r.hybrid_time!r} "
          f"makespan_s={makespan} single_s={r.single_times} "
          f"gain={r.gain!r} idle={r.idle_fracs} "
          f"resource_efficiency={r.resource_efficiency!r} "
          f"analytic_s={r.analytic_time!r} "
          f"overlap_s={overlap}{extra}")
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


def take_profile(torch, label, fn, marks=(), cpu=True, card_ran=None,
                 retake=True):
    """``fn()`` under torch.profiler (the CUDA activity, and the host's
    where ``cpu``); returns its value, the profile's events, its device
    events (kernels, copies and memsets: no annotation, and not the
    device mirrors of the record_function ``marks``) and the seconds
    ``fn()`` took.  A profile that kept no device event at all while
    the card worked in the call (``card_ran(value)``; by default it
    always does) is a trace the profiler lost, not an idle card: the
    line says so, with the CUDA runtime calls the profile kept and how
    far the host's wall clock moved against its monotonic one during
    the call, and, where ``retake``, the call is profiled once more.
    The caller's check holds the second take as it held the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for take in (1, 2):
        wall_mono = time.time_ns() - time.monotonic_ns()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
        moved_ms = (time.time_ns() - time.monotonic_ns() - wall_mono) / 1e6
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in marks
                  and not getattr(e, "is_user_annotation", False)]
        if device or (card_ran is not None and not card_ran(out)):
            break
        runtime = sum(1 for e in events if e.device_type == DeviceType.CPU
                      and e.name.startswith("cuda"))
        print(f"{label}: the profiler lost the call's device events (take "
              f"{take}: 0 of them, {runtime} CUDA runtime calls kept, the "
              f"wall clock moved {moved_ms!r} ms against the monotonic "
              f"one)" + (": profiling the call once more"
                         if retake and take == 1 else ""), flush=True)
        if not retake:
            break
    return out, events, device, wall


def profiled(torch, label, fn):
    """Run ``fn`` under torch.profiler and print the GPU's busy time
    inside the call's timed windows (the executor's chunk run and merge,
    which it marks with record_function) against the call's
    hybrid_time: the union of the device's kernel, copy and memset
    intervals, so that nothing is counted twice and set-up outside the
    windows (sort's binning) is left out.  Also prints the busy time of
    the whole call, the device time by name inside the windows and
    that of the workload's own kernel (``OWN_KERNEL``), where it has
    one.  A trace the profiler lost is taken once more
    (``take_profile``)."""
    from repro_torch.core.hybrid_executor import TIMED_MERGE, TIMED_RUN
    marks = (TIMED_RUN, TIMED_MERGE)

    def units_of(out):
        if out.trace is not None:
            return dict(out.trace.group_units)
        return dict(zip(out.result.busy_times, out.plan.units))

    out, events, device, _ = take_profile(
        torch, f"hybrid {label}", fn, marks,
        card_ran=lambda out: units_of(out).get("accel", 0) > 0)
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
                             f"windows (units by group {units_of(out)}, "
                             f"{len(device)} device events in the call)")
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
        report(label, out, lanes=forced)
        print(f"hybrid {label}: wall_s={wall!r} value ok (tol {tol})")
        if forced and not (out.trace.group_units.get("host", 0) > 0
                           and overlap_s(out.trace) > 0):
            host_start, card_end = lanes_s(out.trace)
            raise AssertionError(f"{label}: the host lane did not run "
                                 f"concurrently with the card (host lane's "
                                 f"first start {host_start!r} s, card "
                                 f"lane's last end {card_end!r} s)")
        return out

    grids = {ex.n_chunks: ex}

    def forced(label, call, units, runner, cold=None):
        """A forced split: the host lane takes an eighth of the units,
        and the card's share is sized from a measured card time to take
        at least ``FORCED_CARD_S``.  The measurement: a card-alone call
        (``call(executor, [units, 0])``) at the main grid, then at
        grids twice as fine until the card's share of the forced split
        (its chunks times the median measured time a chunk) reaches the
        mark.  A workload whose shares run as one chunk each (spmv)
        has no grid to refine: ``cold()`` drops what its earlier calls
        packed, before the card-alone call and again before the forced
        call, so both pack their card share anew, and the card's share
        is the card-alone call's time a unit times its units.
        ``runner(label, fn)`` runs and checks the forced call."""
        G = ex.n_chunks
        while True:
            cu = max(units // G, 1)
            host = max(units // 8 // cu, 1) * cu
            exg = grids.get(G) or grids.setdefault(
                G, HybridExecutor(n_chunks=G))
            if cold is not None:
                cold()
            probe = call(exg, [units, 0])
            recs = [r for r in probe.trace.records if r.group == "accel"]
            if cold is not None:
                per_unit = (sum(r.t_end - r.t_start for r in recs)
                            / sum(r.chunk.units for r in recs))
                predicted = per_unit * (units - host)
                source = (f"a card-alone call packing its share anew: "
                          f"{per_unit * 1e3:.4f} ms a unit")
            else:
                # the median: one slow chunk does not size the grid
                per_chunk = statistics.median(r.t_end - r.t_start
                                              for r in recs)
                predicted = per_chunk * -(-(units - host) // cu)
                source = (f"a card-alone call at this grid: "
                          f"{len(recs)} chunks, median {per_chunk * 1e3:.4f}"
                          f" ms a chunk")
            print(f"hybrid {label} sizing: grid={G} units={units} "
                  f"host_units={host} card_share_predicted_s="
                  f"{predicted!r} from {source} (needs >= "
                  f"{FORCED_CARD_S!r})")
            if predicted >= FORCED_CARD_S:
                break
            if cold is not None or 2 * G > units:
                raise AssertionError(f"{label}: no grid gives the card a "
                                     f"share of {FORCED_CARD_S} s")
            G *= 2
        if cold is not None:
            cold()
        return runner(label, lambda: call(exg, [units - host, host]))

    def forced_run(reference, tol):
        return lambda label, fn: run(label, fn, reference, tol, forced=True)

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
    forced("conv forced", lambda e, plan: conv.run_hybrid(
        e, size=CONV_SIZE, ksize=CONV_K, plan_override=plan), CONV_SIZE,
        forced_run(conv_ref, TOL["conv2d"]))

    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"hist {label}", lambda: hist.run_hybrid(
            ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0)
    run("hist profiled", lambda: hist.run_hybrid(
        ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0, profile=True)
    keys = hist.make_inputs(HIST_FORCED_N, HIST_BINS)
    forced("hist forced", lambda e, plan: hist.run_hybrid(
        e, n=HIST_FORCED_N, n_bins=HIST_BINS,
        unit=HIST_FORCED_N // HIST_FORCED_UNITS, plan_override=plan),
        HIST_FORCED_UNITS, forced_run(torch.tensor(np.bincount(
            keys, minlength=HIST_BINS).astype(np.int32)), 0))
    del keys

    cost_model.reset_profiles()
    outs = [run(f"spmv {label}", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4)
        for label in ("cold", "warm")]
    run("spmv profiled", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4, profile=True)
    # spmv's card share is a few ELL launches of microseconds each: no
    # grid makes it last.  What lasts is packing the share's rows, which
    # its first call at a split does inside the card lane; a warm
    # call's card time may or may not hold one (its split may repeat an
    # earlier call's), so the forced call packs anew, as its probe does
    forced("spmv forced", lambda e, plan: spmv.run_hybrid(
        e, n=SPMV_N, density=SPMV_DENSITY, plan_override=plan),
        sum(outs[1].plan.units), forced_run(spmv_ref, 1e-4),
        cold=spmv._PREP_CACHE.clear)

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

    def run_bilateral(label, fn=None):
        out = run(label, fn or (lambda: bilateral.run_hybrid(ex, **bilat_kw)),
                  bilat_ref, TOL["bilateral"], forced=fn is not None,
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
    forced("bilateral forced", lambda e, plan: bilateral.run_hybrid(
        e, **bilat_kw, plan_override=plan), BILAT_SIZE, run_bilateral)

    # sort: exact against np.sort; then the leaf sorter on the card
    keys = sort.make_inputs(SORT_N)
    sort_ref = torch.from_numpy(np.sort(keys))
    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"sort {label}", lambda: sort.run_hybrid(
            ex, n=SORT_N, n_bins=SORT_BINS), sort_ref, 0)
    run("sort profiled", lambda: sort.run_hybrid(
        ex, n=SORT_N, n_bins=SORT_BINS), sort_ref, 0, profile=True)
    forced("sort forced", lambda e, plan: sort.run_hybrid(
        e, n=SORT_N, n_bins=SORT_FORCED_BINS, plan_override=plan),
        SORT_FORCED_BINS, forced_run(sort_ref, 0))

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
        warm_plan = None
        for kind in kinds:
            label = f"{name} {kind}"
            common.reset_launches()
            call_kw = dict(kw)
            if kind == "profiled" and name in PINNED_PROFILE:
                # montecarlo's lanes tie (its card lane is host-bound),
                # so its own plan may give the card no unit to profile:
                # the profiled call pins the forced calls' split
                units = kw["n_photons"] // kw["unit"]
                call_kw["plan_override"] = [units - units // 8, units // 8]
                print(f"hybrid {label}: warm plan {warm_plan}, pinned "
                      f"plan {call_kw['plan_override']}")
            t0 = time.perf_counter()
            if kind == "profiled":
                out = profiled(torch, label,
                               lambda: mod.run_hybrid(ex, **call_kw))
            else:
                out = mod.run_hybrid(ex, **call_kw)
            wall = time.perf_counter() - t0
            if kind == "warm":
                warm_plan = list(out.plan.units)
                print(f"hybrid {label}: warm plan {warm_plan}")
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
# autotune phase: the search on, on the card and on the host CPU
# ---------------------------------------------------------------------------
def _measured_config(fn):
    """The config a candidate thunk runs: every ``tuned_config`` builds
    its thunks as ``lambda: _<kernel>_cfg(..., cfg)``, so the config is
    the closure's ``cfg`` cell."""
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__ or ())))
    return cells.get("cfg")


def _cfg_str(cfg) -> str:
    return json.dumps(cfg, sort_keys=True)


def tune(label, tuned, device, where=None):
    """Resolve ``tuned()`` twice with the search on: the first searches
    (one line per candidate measured: config and the search's host
    time, min of 2 after a warmup, the device synchronised) and the
    second must measure nothing.  ``where`` = (kernel, bucket) names
    the tune entry, whose ``via`` shows a transfer.  Returns the
    winner."""
    from repro_torch.kernels import autotune as at

    measured = []
    default_timer = at._default_timer

    def timer(fn):
        t = default_timer(fn)
        measured.append((_measured_config(fn), t))
        return t

    prev = at.set_timer(timer)
    try:
        t0 = time.perf_counter()
        cfg = tuned()
        t_search = time.perf_counter() - t0
        n = len(measured)
        again = tuned()
    finally:
        at.set_timer(prev)
    for c, t in measured[:n]:
        print(f"autotune {label} on {device}: measured {_cfg_str(c)} "
              f"ms={t * 1e3:.4f}", flush=True)
    if again != cfg or len(measured) != n:
        raise AssertionError(f"autotune {label}: the second tuned_config "
                             f"measured {len(measured) - n} candidates")
    native = "" if cfg["impl"] == "cuda" or device == "cpu" else \
        " (not the CUDA kernel)"
    via = ""
    if where is not None:
        entry = at.tuned_entry(*where, device=device)
        via = f" via={entry['via']}" if "via" in entry else ""
    print(f"autotune {label} on {device}: winner={_cfg_str(cfg)}{native} "
          f"search_s={t_search!r} measured={n}{via}; second tuned_config "
          f"measured 0", flush=True)
    if native:
        print(f"autotune {label.split()[0]} winner={_cfg_str(cfg)} (not "
              f"the CUDA kernel)", flush=True)
    return cfg


def autotune_phase(torch, np, dev):
    """The search on (``REPRO_AUTOTUNE=1``, a throwaway tune file under
    the build directory): K1-K3 and K5-K8 tuned at the main path's
    shapes on the card (every candidate of each space then timed with
    CUDA events and held against the plain version), conv and hist
    tuned on the host CPU at the host lane's chunk shapes, one conv
    ``run_hybrid`` on the real pair cold then warm, and the port-side
    ``overlap_check``, ``cold_start`` and ``fig5_tasks`` at the
    reference's defaults.  Returns the launch counts of the searches
    and of the conv calls."""
    import shutil

    from repro_torch.benchmarks import cold_start, fig5_tasks, overlap_check
    from repro_torch.core import cost_model
    from repro_torch.core.calibration import (clear_calibration_cache,
                                              measure)
    from repro_torch.core.host_offload import bilateral_luts
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import common
    from repro_torch.kernels.bilateral import ops as bilateral_ops
    from repro_torch.kernels.bilateral.bilateral import bilateral_lut_torch
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.conv2d import conv2d_shift_add
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.gmm import gmm_torch
    from repro_torch.kernels.hist import ops as hist_ops
    from repro_torch.kernels.hist.ref import hist_ref
    from repro_torch.kernels.sort_bitonic import ops as sort_ops
    from repro_torch.kernels.sort_bitonic.sort_bitonic import (
        bitonic_rows_torch)
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    from repro_torch.workloads import bilateral as bilateral_w
    from repro_torch.workloads import conv
    from repro_torch.workloads import sort as sort_w
    from repro_torch.workloads import spmv as spmv_w

    t_phase = time.perf_counter()
    root = os.path.join(common.BUILD_DIR, "autotune")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["REPRO_AUTOTUNE"] = "1"
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(root, "tune.json")
    at.reset_tune_cache()
    print(f"autotune: REPRO_AUTOTUNE=1 REPRO_TUNE_CACHE="
          f"{os.environ['REPRO_TUNE_CACHE']} top_k={at.top_k()} "
          f"transfer={at.transfer_enabled()}", flush=True)
    rng = np.random.default_rng(19)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)

    def on(a, device=dev):
        return torch.tensor(a, device=device)

    def randn(*shape, device=dev):
        return on(rng.standard_normal(shape).astype(np.float32), device)

    # the main path's shapes, with each kernel's plain version and the
    # tolerance it is held to (TOL; the kernel phase holds K1 bitwise)
    H = CONV_SIZE // 16 + CONV_K - 1
    img, w = randn(H, CONV_SIZE), randn(CONV_K, CONV_K)
    keys = on(rng.integers(0, HIST_BINS, HIST_N // 16, dtype=np.int32))
    A = spmv_w.make_matrix(SPMV_N, SPMV_DENSITY)
    A_sorted = A[np.argsort(-(A != 0).sum(1))]
    xv = on(spmv_w.make_vector(SPMV_N))
    tiles = []
    for t0 in (0, 512):
        sub = A_sorted[t0:t0 + 512]
        tiles.append(spmv_ops.prepare(
            sub, k_threshold=int(max((sub != 0).sum(1).max(), 1)),
            device=dev))
    del A, A_sorted
    rows = on(sort_w.make_inputs(SORT_N)).reshape(-1, SORT_TILE)
    Hb = BILAT_SIZE // 16 + 2 * BILAT_RADIUS
    pix = on(bilateral_w.make_inputs(BILAT_SIZE)[:Hb])
    sp, rl = (on(a) for a in bilateral_luts(BILAT_SIGMA_S, BILAT_SIGMA_R,
                                            BILAT_RADIUS))
    gen = torch.Generator(device=dev).manual_seed(3)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    # K7 at the LM's prefill (kimi-k2: 64 query heads over 8 K/V heads,
    # d=112, batch 4 x 1024, causal); K8 at its decode up projection
    q = bf16(LM_BATCH, LM_PROMPT, 64, 112)
    k, v = bf16(LM_BATCH, LM_PROMPT, 8, 112), bf16(LM_BATCH, LM_PROMPT, 8,
                                                   112)
    xe, we = bf16(384, LM_BATCH, 7168), bf16(384, 7168, 2048,
                                            scale=7168 ** -0.5)

    def attn_plain():
        return flash_ops.flash_attention(q, k, v, use_kernel=False)

    # (label, kernel, tuned(), call(cfg), plain, tol, candidates,
    # (tune kernel, bucket))
    cases = [
        (f"conv2d {H}x{CONV_SIZE} K={CONV_K}", "conv2d",
         lambda: conv_ops.tuned_config(img, w),
         lambda c: conv_ops.conv2d(img, w, config=c),
         conv2d_shift_add(img, w), TOL["conv2d"],
         conv_ops.candidates(H, CONV_SIZE, CONV_K, dev),
         ("conv2d", conv_ops.shape_bucket(H, CONV_SIZE, CONV_K))),
        (f"hist N={keys.numel()} bins={HIST_BINS}", "hist",
         lambda: hist_ops.tuned_config(keys, HIST_BINS),
         lambda c: hist_ops.histogram(keys, HIST_BINS, config=c),
         hist_ref(keys, HIST_BINS), 0,
         hist_ops.candidates(keys.numel(), HIST_BINS, dev),
         ("hist", hist_ops.shape_bucket(keys.numel(), HIST_BINS)))]
    for i, m in enumerate(tiles):
        R, K = m.ell_vals.shape
        cases.append((
            f"spmv tile {i} R={R} K={K}", "spmv_ell",
            lambda m=m: spmv_ops.tuned_config(m.ell_vals, m.ell_idx, xv),
            lambda c, m=m: spmv_ops.spmv_ell(m.ell_vals, m.ell_idx, xv,
                                             config=c),
            spmv_ell_ref(m.ell_vals, m.ell_idx, xv), TOL["spmv_ell"],
            spmv_ops.candidates(R, K, dev),
            ("spmv", spmv_ops.shape_bucket(R, K))))
    cases += [
        (f"sort_bitonic G={rows.shape[0]} L={SORT_TILE}", "sort_bitonic",
         lambda: sort_ops.tuned_config(rows),
         lambda c: sort_ops.sort_rows(rows, config=c),
         bitonic_rows_torch(rows), 0,
         sort_ops.candidates(rows.shape[0], SORT_TILE, dev),
         ("sort_bitonic", sort_ops.shape_bucket(rows.shape[0], SORT_TILE))),
        (f"bilateral {Hb}x{BILAT_SIZE} K={sp.shape[0]}", "bilateral",
         lambda: bilateral_ops.tuned_config(pix, sp, rl),
         lambda c: bilateral_ops.bilateral_filter(pix, sp, rl, config=c),
         bilateral_lut_torch(pix, sp, rl), TOL["bilateral"],
         bilateral_ops.candidates(Hb, BILAT_SIZE, sp.shape[0], dev),
         ("bilateral", bilateral_ops.shape_bucket(Hb, BILAT_SIZE,
                                                  sp.shape[0]))),
        (f"flash_attention prefill B={LM_BATCH} T={LM_PROMPT} H=64/8 "
         f"d=112 causal bf16", "flash_attention",
         lambda: flash_ops.tuned_config(q, k, v),
         lambda c: flash_ops.flash_attention(q, k, v, config=c),
         attn_plain(), TOL["flash_attention"],
         flash_ops.candidates(LM_PROMPT, LM_PROMPT, 112, True, dev,
                              torch.bfloat16),
         ("flash_attention", flash_ops.shape_bucket(
             LM_BATCH * 64, LM_PROMPT, LM_PROMPT, 112, True))),
        (f"gmm decode up E=384 C={LM_BATCH} D=7168 F=2048 bf16", "gmm",
         lambda: gmm_ops.tuned_config(xe, we),
         lambda c: gmm_ops.gmm(xe, we, config=c),
         gmm_torch(xe, we), TOL["gmm"],
         gmm_ops.candidates(384, LM_BATCH, 7168, 2048, dev,
                            torch.bfloat16),
         ("gmm", gmm_ops.shape_bucket(384, LM_BATCH, 7168, 2048))),
    ]
    torch.backends.cudnn.allow_tf32 = False

    # the searches: the main path of this phase, its launches counted
    t0 = time.perf_counter()
    common.reset_launches()
    winners = {label: tune(label, tuned, "cuda", where)
               for label, _, tuned, _, _, _, _, where in cases}
    search_counts = common.launch_counts()
    print(f"autotune search: launches={search_counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # every candidate of each space, timed on the device and held
    # against its plain version (uncounted); a CUDA candidate must
    # launch exactly its entry
    t0 = time.perf_counter()
    for label, name, _, call, plain, tol, cands, _ in cases:
        for cfg in cands:
            common.reset_launches()
            out = call(cfg)
            counts, entries = common.launch_counts(), common.entry_counts()
            if cfg["impl"] == "cuda":
                entry = cfg.get("entry", "sort_rows_reg_f32")
                if counts[name] != 1 or entries[entry] != 1:
                    raise AssertionError(f"autotune {label} {cfg}: "
                                         f"launched {entries}")
            if tol == 0:
                if not torch.equal(out, plain):
                    raise AssertionError(f"autotune {label} {cfg}: not "
                                         f"exactly the plain version")
                err = 0.0
            else:
                torch.testing.assert_close(
                    out.float(), plain.float(), rtol=tol, atol=tol,
                    msg=lambda m: f"autotune {label} {cfg}: {m}")
                err = (out.float() - plain.float()).abs().max().item()
            ms = time_ms(torch, lambda: call(cfg), flush, iters=10)
            mark = " <- winner" if cfg == {
                k_: v_ for k_, v_ in winners[label].items()
                if k_ in cfg} else ""
            print(f"autotune {label} candidate {_cfg_str(cfg)}: "
                  f"device_ms={ms:.4f} max_abs_err={err!r}{mark}",
                  flush=True)
    print(f"autotune candidates: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del cases, q, k, v, xe, we, rows
    torch.cuda.empty_cache()

    # the host CPU at the host lane's chunk shapes (conv: a chunk of the
    # 3600-wide image with its halo rows; hist: one of 16 chunks)
    t0 = time.perf_counter()
    img_h, w_h = img.cpu(), w.cpu()
    keys_h = keys.cpu()
    tune(f"conv2d {H}x{CONV_SIZE} K={CONV_K}",
         lambda: conv_ops.tuned_config(img_h, w_h), "cpu",
         ("conv2d", conv_ops.shape_bucket(H, CONV_SIZE, CONV_K)))
    tune(f"hist N={keys_h.numel()} bins={HIST_BINS}",
         lambda: hist_ops.tuned_config(keys_h, HIST_BINS), "cpu",
         ("hist", hist_ops.shape_bucket(keys_h.numel(), HIST_BINS)))
    print(f"autotune host: {time.perf_counter() - t0:.1f} s", flush=True)

    # one conv run_hybrid on the real pair with the search on, cold (a
    # fresh tune file and calibration: each lane searches its own
    # winner inside the call's set-up) then warm
    t0 = time.perf_counter()
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(root, "hybrid.json")
    at.reset_tune_cache()
    clear_calibration_cache("torch:cuda")
    cost_model.reset_profiles()
    ex = HybridExecutor()
    cimg, cw = conv.make_inputs(CONV_SIZE, CONV_K)
    conv_ref = conv2d_ref(on(cimg), on(cw)).cpu()
    rows_c = CONV_SIZE // ex.n_chunks + CONV_K - 1
    bkt = conv_ops.shape_bucket(rows_c, CONV_SIZE, CONV_K)
    per_call = {"autotune search": search_counts}
    for label in ("cold", "warm"):
        measured = []
        default_timer = at._default_timer
        prev = at.set_timer(lambda fn: measured.append(1)
                            or default_timer(fn))
        common.reset_launches()
        try:
            t1 = time.perf_counter()
            out = conv.run_hybrid(ex, size=CONV_SIZE, ksize=CONV_K)
            wall = time.perf_counter() - t1
        finally:
            at.set_timer(prev)
        counts = common.launch_counts()
        per_call[f"autotune conv {label}"] = counts
        torch.testing.assert_close(out.value.cpu(), conv_ref,
                                   rtol=TOL["conv2d"], atol=TOL["conv2d"],
                                   msg=lambda m: f"autotune conv {label}: "
                                                 f"{m}")
        lanes = {g.name: at.tuned_entry("conv2d", bkt,
                                        device=g.devices[0])["config"]
                 for g in ex.groups}
        print(f"hybrid autotune conv {label}: lane winners "
              f"accel={_cfg_str(lanes['accel'])} "
              f"host={_cfg_str(lanes['host'])} (bucket {bkt}); "
              f"candidates measured={len(measured)} "
              f"probes={ex.last_probe_runs} launches={counts}", flush=True)
        report(f"autotune conv {label}", out)
        print(f"hybrid autotune conv {label}: wall_s={wall!r} value ok "
              f"(tol {TOL['conv2d']})", flush=True)
        if label == "warm" and measured:
            raise AssertionError("autotune conv warm: the search ran "
                                 "again")
    print(f"autotune hybrid: {time.perf_counter() - t0:.1f} s", flush=True)
    del flush
    torch.cuda.empty_cache()

    # the port-side scripts at the reference's defaults
    t0 = time.perf_counter()
    overlap_check.run()
    print(f"autotune overlap_check: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    cold = cold_start.run(root=root)
    print(f"autotune cold_start: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for kernel in cold_start.KERNELS:
        r = cold[kernel]["topk"]
        if r["n_transfer"] != 1 or r["n_warm"] != 0:
            raise AssertionError(f"cold_start {kernel}: transfer measured "
                                 f"{r['n_transfer']}, warm lookup "
                                 f"{r['n_warm']}")
    # a native winner of cold_start's searches is a finding: every
    # candidate of that space at that shape, timed on the device (CUDA
    # events) and on the host (min of 3, the device synchronised)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    for kernel in cold_start.KERNELS:
        picks = {mode: cold[kernel][mode]["cfg"] for mode in ("topk",
                                                               "full")}
        natives = {m: c for m, c in picks.items() if c["impl"] != "cuda"}
        if not natives:
            continue
        for mode, c in natives.items():
            print(f"autotune {kernel} winner={_cfg_str(c)} (not the CUDA "
                  f"kernel) in cold_start's {mode} search at "
                  f"{cold_start.SHAPES[kernel]}", flush=True)
        _, run, cands = cold_start.setup(kernel, device=dev)
        for c in cands:
            ms = time_ms(torch, lambda: run(c), flush, iters=10)
            host = measure(lambda: run(c), warmup=1, iters=3, reduce="min")
            print(f"autotune {kernel} cold_start shape candidate "
                  f"{_cfg_str(c)}: device_ms={ms:.4f} "
                  f"host_ms={host * 1e3:.4f}", flush=True)
    del flush
    b = cold["hybrid"]["b"]
    if b["probes_first_call"] != 0 or not cold["hybrid"]["plan_match"]:
        raise AssertionError(
            f"cold_start hybrid: the fresh process's first call probed "
            f"{b['probes_first_call']}, plan {b['plan']} against "
            f"{cold['hybrid']['a']['next_plan']} (chunk "
            f"{cold['hybrid']['a']['chunk_units']} units)")
    t0 = time.perf_counter()
    fig5_tasks.run()
    print(f"autotune fig5_tasks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    os.environ["REPRO_AUTOTUNE"] = "0"
    at.reset_tune_cache()
    print(f"autotune phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return per_call


# ---------------------------------------------------------------------------
# LM phase
# ---------------------------------------------------------------------------
def profile_window(torch, label, fn, top=6, retake=True):
    """``fn()`` and a synchronisation under torch.profiler: the GPU's
    busy time (union of its kernel, copy and memset intervals) inside
    the window (the host's span of the call and its synchronisation),
    the idle share, and the device time by name.  A trace the profiler
    lost is taken once more where ``retake`` (``fn`` can run twice)."""
    from torch.profiler import record_function

    mark = f"lm:{label}"

    def call():
        with record_function(mark):
            fn()
            torch.cuda.synchronize()

    _, events, device, _ = take_profile(torch, label, call, (mark,),
                                        retake=retake)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == mark]
    w0, w1 = min(lo for lo, _ in spans), max(hi for _, hi in spans)
    inside, by_name = [], {}
    for e in device:
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


def profile_idle(torch, label, fn, top=6):
    """``fn()`` and a synchronisation under torch.profiler with the CUDA
    activity alone: the GPU's busy time (union of its kernel, copy and
    memset intervals) against the call's wall time, the idle share, and
    the device time by name.  No host event is recorded: a training
    step makes ~10^5 of them, which ``profile_window`` would take tens
    of seconds to read back.  A trace the profiler lost is taken once
    more."""
    def call():
        fn()
        torch.cuda.synchronize()

    _, _, device, window = take_profile(torch, label, call, cpu=False)
    inside, by_name = [], {}
    for e in device:
        inside.append((e.time_range.start, e.time_range.end))
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    busy = _union_s(inside)
    if busy <= 0:
        raise AssertionError(f"{label}: no device time in the window")
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


def _k7_row(torch, flush, label, q, k, v, causal):
    """K7 on (BH, T, d) / (BHkv, S, d) bf16 against its plain version and
    SDPA on the same inputs: the JSON row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    BH, T, d = q.shape
    BHkv, S, _ = k.shape
    rep = BH // BHkv

    def plain():
        return attention_ref(q, k.repeat_interleave(rep, 0),
                             v.repeat_interleave(rep, 0), causal)

    out, ref = flash_attention_cuda(q, k, v, causal), plain()
    tol = TOL["flash_attention"]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"flash_attention {label}: {m}")
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    pairs = T * (T + 1) // 2 if causal else T * S
    q4, k4, v4 = (t.view(1, -1, t.shape[1], d) for t in (q, k, v))
    return kernel_row(
        "flash_attention", err,
        time_ms(torch, lambda: flash_attention_cuda(q, k, v, causal), flush),
        time_ms(torch, plain, flush, iters=10),
        4.0 * BH * pairs * d, 2.0 * (2 * BH * T + 2 * BHkv * S) * d,
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True), flush),
        f"{label}: BH={BH}/{BHkv} T={T} S={S} d={d} "
        f"{'causal' if causal else 'full'}", PEAK_BF16_FLOPS,
        entry=route(q.dtype, d))


def _k8_row(torch, flush, label, x, w):
    """K8 on the model's expert weights against its plain version and
    ``torch.bmm`` on the same operands: the JSON row."""
    from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch, route

    E, c, D = x.shape
    F_ = w.shape[2]
    out, ref = gmm_cuda(x, w), gmm_torch(x, w)
    tol = TOL["gmm"]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"gmm {label}: {m}")
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    return kernel_row(
        "gmm", err, time_ms(torch, lambda: gmm_cuda(x, w), flush),
        time_ms(torch, lambda: gmm_torch(x, w), flush, iters=10),
        2.0 * E * c * D * F_, 2.0 * E * (c * D + D * F_ + c * F_),
        time_ms(torch, lambda: torch.bmm(x, w), flush),
        f"{label}: E={E} C={c} D={D} F={F_}", PEAK_BF16_FLOPS,
        entry=route(x.dtype, D, F_))


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
    rows = [_k7_row(torch, flush, "prefill", q, k, v, True)]
    del q, k, v

    # K7's f32 entry (the CUDA-core kernel, flash_attention_fma_f32) at
    # the serve stream's attention requests: 4 x 1024, 64/8 heads,
    # d = 112, causal, f32; SDPA in f32 (TF32 is off, main())
    B, T = SERVE_ATTN["B"], SERVE_ATTN["T"]
    H, Kv, d = SERVE_ATTN["H"], SERVE_ATTN["Kv"], SERVE_ATTN["d"]
    q, k, v = (randn(B * n, T, d).float() for n in (H, Kv, Kv))
    out = flash_attention_cuda(q, k, v, True)
    tol = TOL["flash_attention_f32"]
    ref = attn_plain(q, k, v, True)
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol, msg=lambda m:
                               f"flash_attention f32 serve stream: {m}")
    err = (out - ref).abs().max().item()
    del out, ref
    q4, k4, v4 = (t.view(B, -1, T, d) for t in (q, k, v))
    pairs = T * (T + 1) // 2
    rows.append(kernel_row(
        "flash_attention", err,
        time_ms(torch, lambda: flash_attention_cuda(q, k, v, True), flush),
        time_ms(torch, lambda: attn_plain(q, k, v, True), flush, iters=10),
        4.0 * B * H * pairs * d, 4.0 * (2 * B * H + 2 * B * Kv) * T * d,
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), flush),
        f"serve stream: BH={B * H}/{B * Kv} T=S={T} d={d} causal f32",
        PEAK_F32_FLOPS, entry=flash_route(q.dtype, d)))
    if rows[-1]["entry"] != K7_F32_ENTRY:
        raise AssertionError(f"K7 f32 went to {rows[-1]['entry']}")
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
        E, D, _ = w.shape
        rows.append(_k8_row(torch, flush, label, randn(E, c, D), w))
    return rows


# ---------------------------------------------------------------------------
# serve phase: the serving scheduler on the real pair
# ---------------------------------------------------------------------------
# the Table-1 stream: the hybrid phase's sizes, with hist and sort cut
# so that the host lane's numpy work fits the arrival rate.  spmv comes
# twice: at the hybrid phase's density every row has more nonzeros
# (~82) than the adapter's ELL threshold (32, the reference's), so a
# dedicated spmv is all COO tail and never reaches K3; at 0.003 (~25 a
# row) the ELL head + COO tail split of the reference's adapter holds
SERVE_RATE, SERVE_SECONDS = 6.0, 10.0
SERVE_SPMV_HEAD = 0.003
SERVE_MIX = (
    ("conv", {"size": CONV_SIZE, "ksize": CONV_K}),
    ("hist", {"n": 1 << 24, "n_bins": HIST_BINS}),
    ("spmv", {"n": SPMV_N, "density": SPMV_DENSITY}),
    ("spmv", {"n": SPMV_N, "density": SERVE_SPMV_HEAD}),
    ("bilateral", {"size": BILAT_SIZE, "radius": BILAT_RADIUS}),
    ("sort", {"n": 1 << 22}),
    ("attention", {"batch": 4, "seq": 1024, "heads": 64, "kv_heads": 8,
                   "dim": 112}),
)
# one burst of same-bucket requests a workload, all submitted together,
# so that coalescing and the merge hooks run (seeds 0..7: the members
# differ, so a demux that mixed rows up would show)
SERVE_BURST = (("hist", {"n": 1 << 20}), ("sort", {"n": 1 << 16}),
               ("conv", {"size": 512}), ("attention", {}))
SERVE_BURST_N = 8
# the kernels every Table-1 stream must launch, on these entries (K4 in
# the scheduler's cold calibration: the first placement measures each
# device's profile)
SERVE_ENTRY = {"conv2d": "conv2d_reg_f32", "hist": "hist_priv_i32",
               "spmv_ell": "spmv_ell_seg_f32",
               "bilateral": "bilateral_reg_f32",
               "flash_attention": "flash_attention_fma_f32",
               "probe_add_one": "probe_add_one_vec_f32"}
LM_STREAM_RATE, LM_STREAM_SECONDS = 1.0, 6.0


_SERVE_REFS = {}


def _serve_checks(torch, np):
    """Each stream workload's check on the host: the reference value of
    its (deterministic, seed 0) inputs, and the tolerance of the hybrid
    phase's check of the same workload.  Made once and kept: the fleet
    phase holds its results to the same values."""
    if _SERVE_REFS:
        return _SERVE_REFS
    from repro_torch.core.host_offload import bilateral_luts
    from repro_torch.kernels.bilateral.bilateral import bilateral_lut_torch
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.workloads import bilateral, conv, hist, spmv
    from repro_torch.workloads.requests import _attn_inputs, _sort_inputs

    dev = torch.device("cuda", 0)
    refs = {}
    img, w = conv.make_inputs(CONV_SIZE, CONV_K)
    refs["conv"] = (conv2d_ref(torch.tensor(img), torch.tensor(w)),
                    TOL["conv2d"])
    keys = hist.make_inputs(1 << 24, HIST_BINS)
    refs["hist"] = (torch.tensor(np.bincount(keys, minlength=HIST_BINS)
                                 .astype(np.int32)), 0)
    x = spmv.make_vector(SPMV_N).astype(np.float64)
    for density in (SPMV_DENSITY, SERVE_SPMV_HEAD):
        A = spmv.make_matrix(SPMV_N, density)
        refs[("spmv", density)] = (torch.tensor(
            (A.astype(np.float64) @ x).astype(np.float32)), 1e-4)
    img = bilateral.make_inputs(BILAT_SIZE)
    sp, rl = bilateral_luts(BILAT_SIGMA_S, BILAT_SIGMA_R, BILAT_RADIUS)
    refs["bilateral"] = (bilateral_lut_torch(
        torch.tensor(img, device=dev), torch.tensor(sp, device=dev),
        torch.tensor(rl, device=dev)).cpu(), TOL["bilateral"])
    refs["sort"] = (torch.from_numpy(np.sort(_sort_inputs(1 << 22, 0))), 0)
    q, k, v = (torch.tensor(a, device=dev)
               for a in _attn_inputs(4, 1024, 64, 112, 8, 0).host)
    refs["attention"] = (attn_ops.sdpa(q, k, v, causal=True,
                                       config={"impl": "torch_ref"}).cpu(),
                         2e-5)
    _SERVE_REFS.update(refs)
    return refs


def _as_cpu(torch, value):
    import numpy as np
    return (value.cpu() if isinstance(value, torch.Tensor)
            else torch.from_numpy(np.asarray(value)))


def serve_stream_phase(torch, np):
    """The Table-1 stream and the burst through ``Scheduler()`` on the
    real pair; returns the launch counts of the whole run (counts set
    to 0 just before the scheduler is made, read after ``drain()``)."""
    from repro_torch.core import cost_model
    from repro_torch.kernels import common
    from repro_torch.kernels.common import lane_device
    from repro_torch.serve.request_queue import RequestRejected
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.workloads import requests as adapters

    t0 = time.perf_counter()
    refs = _serve_checks(torch, np)
    print(f"serve: reference values made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # every request resolves exactly once: count each future's callbacks
    resolved = {}

    def on_done(f):
        resolved[id(f)] = resolved.get(id(f), 0) + 1

    # the first placement of a fresh scheduler measures each device's
    # hardware profile (K4 on the card): a cold calibration
    cost_model.reset_profiles()
    common.reset_launches()
    # explore_every=8: each workload is dispatched ~10 times in the
    # trace, fewer than the default 16 that lets a lane the estimates
    # pass over run it once
    sched = Scheduler(max_batch=SERVE_BURST_N, batch_window_s=0.005,
                      explore_every=8)
    groups = {g.name: str(g.devices[0]) for g in sched.groups}
    print(f"serve: groups={groups} simulated={sched._ex.simulated} "
          f"span_factors={sched.span_factors}", flush=True)
    if groups != {"accel": "cuda:0", "host": "cpu"}:
        raise AssertionError(f"serve: expected accel=cuda:0 host=cpu, got "
                             f"{groups}")
    # every request's inputs made (and memoized) before the trace, as a
    # service holds its data: the burst's submissions then take
    # microseconds and land inside one batching window
    for wl, payload in SERVE_MIX:
        adapters.make_request(wl, payload)
    for wl, payload in SERVE_BURST:
        for seed in range(SERVE_BURST_N):
            adapters.make_request(wl, dict(payload, seed=seed))
    rng = np.random.default_rng(0)
    futs = []                       # (workload, payload, t_submit, future)
    done_at = {}

    def submit(wl, payload):
        f = sched.submit(wl, payload)
        f.add_done_callback(on_done)
        f.add_done_callback(
            lambda f_: done_at.__setitem__(id(f_), time.perf_counter()))
        futs.append((wl, payload, time.perf_counter(), f))

    # the device's kernels, copies and memsets over the whole run, for
    # the GPU's idle share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        t_end = t_start + SERVE_SECONDS
        while time.perf_counter() < t_end:
            wl, payload = SERVE_MIX[int(rng.integers(len(SERVE_MIX)))]
            submit(wl, dict(payload))
            time.sleep(float(rng.exponential(1.0 / SERVE_RATE)))
        n_stream = len(futs)
        for wl, payload in SERVE_BURST:
            for seed in range(SERVE_BURST_N):
                submit(wl, dict(payload, seed=seed))
        if not sched.drain(timeout=600):
            raise AssertionError("serve: drain() timed out")
        wall = time.perf_counter() - t_start
    gpu_busy = _union_s([(e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)])
    counts, entries = common.launch_counts(), common.entry_counts()
    PHASE_ENTRIES["serve stream"] = entries
    st = sched.stats
    audit = sched.audit.summary()
    sched.shutdown()

    # the audited invariant, with nothing left in flight
    rejected = st.rejected_full + st.rejected_shutdown + st.rejected_failure
    shed = st.shed_deadline + st.shed_brownout
    print(f"serve stream: {st.row()}")
    print(f"serve stream: invariant submitted={st.submitted} == completed="
          f"{st.completed} + failed={st.failed} + rejected={rejected} + "
          f"shed={shed} + in_flight={st.in_flight}", flush=True)
    if (st.submitted != st.completed + st.failed + rejected + shed
            + st.in_flight or st.in_flight != 0
            or st.submitted != len(futs)):
        raise AssertionError("serve stream: the audited invariant fails")
    if st.failed or rejected or shed:
        raise AssertionError(f"serve stream: {st.failed} failed, "
                             f"{rejected} rejected, {shed} shed")
    if any(resolved.get(id(f), 0) != 1 for _, _, _, f in futs):
        raise AssertionError("serve stream: a future did not resolve "
                             "exactly once")

    # per workload: count, placements, latency percentiles
    rows = {}
    for wl, payload, t_sub, f in futs[:n_stream]:
        key = f"{wl}@{payload['density']}" if wl == "spmv" else wl
        r = rows.setdefault(key, {"n": 0, "accel": 0, "host": 0,
                                 "shared": 0, "queued": 0, "lat": []})
        r["n"] += 1
        r[f.meta["lane"]] += 1
        r["queued"] += f.meta["queued_behind_s"] > 1e-9
        r["lat"].append(done_at[id(f)] - t_sub)
    placed = {}
    for wl, r in sorted(rows.items()):
        p50, p95, p99 = (float(v) for v in
                         np.percentile(r["lat"], [50, 95, 99]))
        print(f"serve stream {wl}: n={r['n']} dedicated_accel={r['accel']} "
              f"dedicated_host={r['host']} shared={r['shared']} "
              f"queued={r['queued']} "
              f"latency_ms p50={p50 * 1e3!r} p95={p95 * 1e3!r} "
              f"p99={p99 * 1e3!r}")
    lat_all = [done_at[id(f)] - t for _, _, t, f in futs[:n_stream]]
    p50, p95, p99 = (float(v) for v in np.percentile(lat_all, [50, 95, 99]))
    print(f"serve stream: {n_stream} requests in {SERVE_SECONDS} s at "
          f"{SERVE_RATE}/s, then a burst of {len(futs) - n_stream}; wall_s="
          f"{wall!r} throughput={len(futs) / wall!r} req/s latency_ms "
          f"p50={p50 * 1e3!r} p95={p95 * 1e3!r} p99={p99 * 1e3!r} "
          f"executions dedicated={st.dedicated} shared={st.shared} "
          f"batches={st.batches} merged={st.merged_batches} "
          f"probe_runs={st.probe_runs}")
    print(f"serve stream: gpu_busy_s={gpu_busy!r} of wall_s={wall!r}: "
          f"gpu_idle_share={1.0 - gpu_busy / wall!r} (torch.profiler, "
          f"CUDA activity only, on for the whole run)")
    print(f"serve stream: audit lane_utilization="
          f"{audit['lane_utilization']} resource_efficiency="
          f"{audit['resource_efficiency']!r} open={audit['open_decisions']}")
    for key, v in sorted(audit["placements"].items()):
        print(f"serve stream: audit {key}: n={v['n']} mean_abs_err_s="
              f"{v['mean_abs_err_s']!r} mean_rel_err={v['mean_rel_err']!r}")
    print(f"serve stream: launches={counts}")
    print("serve stream: launches by entry: " + ", ".join(
        f"{e}={entries[e]}" for e in SERVE_ENTRY.values()))
    for name, entry in SERVE_ENTRY.items():
        if counts[name] <= 0 or entries[entry] != counts[name]:
            raise AssertionError(
                f"serve stream: {name} launched {counts[name]} times, "
                f"{entries[entry]} through {entry}")

    # every value against its check; dedicated runs on their group's
    # device; merged rows bitwise their member's solo run on that device
    for wl, payload, _, f in futs:
        try:
            value = f.result(timeout=0)
        except RequestRejected as e:
            raise AssertionError(f"serve stream {wl}: {e}") from None
        lane, dev = f.meta["lane"], f.meta.get("device")
        if isinstance(value, torch.Tensor):
            want = groups["accel"] if lane == "shared" else dev
            if str(value.device) != want:
                raise AssertionError(f"serve stream {wl}: ran on {lane}, "
                                     f"value on {value.device}")
        if "seed" not in payload:
            ref, tol = refs[(wl, payload["density"]) if wl == "spmv"
                            else wl]
            got = _as_cpu(torch, value)
            if tol == 0:
                if not torch.equal(got, ref):
                    raise AssertionError(f"serve stream {wl}: value differs")
            else:
                torch.testing.assert_close(
                    got, ref, rtol=tol, atol=tol,
                    msg=lambda m: f"serve stream {wl}: {m}")
        if f.meta.get("merged"):
            with lane_device(dev):
                solo = adapters.make_request(wl, payload).run_one()
            if not torch.equal(_as_cpu(torch, value), _as_cpu(torch, solo)):
                raise AssertionError(f"serve stream {wl} seed "
                                     f"{payload.get('seed')}: demuxed row "
                                     f"differs from the solo run on {dev}")
    for g in ("accel", "host"):
        n = sum(1 for _, _, _, f in futs if f.meta["lane"] == g)
        if n == 0:
            raise AssertionError(f"serve stream: no dedicated execution "
                                 f"ran on {g}")
        placed[g] = n
    merged = {wl for wl, _, _, f in futs if f.meta.get("merged")}
    print(f"serve stream: every value ok (the hybrid phase's tolerances); "
          f"dedicated executions accel={placed['accel']} (cuda:0) "
          f"host={placed['host']} (cpu), each value on its group's device; "
          f"merged workloads {sorted(merged)}, every demuxed row bitwise "
          f"its member's solo run_one on the same device", flush=True)
    return counts


def serve_lm_phase(torch, cfg, params):
    """kimi-k2 (full width, depth 2) served by ``run_stream`` on a
    scheduler over the accel group alone (a host copy of the weights
    would be ~40 GB); returns the stream's launch counts."""
    from types import SimpleNamespace

    from repro_torch.core.hybrid_executor import detect_platform
    from repro_torch.kernels import common
    from repro_torch.launch.serve import run_stream
    from repro_torch.serve.serve_step import generate
    from repro_torch.workloads import requests as adapters

    accel = detect_platform()[0][0]
    args = SimpleNamespace(batch=LM_BATCH, prompt_len=LM_PROMPT,
                           new_tokens=LM_NEW, rate=LM_STREAM_RATE,
                           duration=LM_STREAM_SECONDS, deadline=None,
                           max_batch=8, window_ms=2.0, continuous=False,
                           trace=None, stats_json=None)
    common.reset_launches()
    out = run_stream(cfg, params, args, groups=[accel])
    counts, entries = common.launch_counts(), common.entry_counts()
    # the adapter holds the weights: drop it, so that the phases after
    # this one get the card's memory back with the weights' last use
    adapters.unregister(out["workload"])
    lat = out["latency_s"]
    import numpy as np
    p50, p95 = (float(v) for v in np.percentile(lat, [50, 95]))
    print(f"serve lm: {len(out['tokens'])} requests of batch {LM_BATCH} at "
          f"{LM_STREAM_RATE}/s for {LM_STREAM_SECONDS} s (+1 warmup): "
          f"latency_ms p50={p50 * 1e3!r} p95={p95 * 1e3!r} "
          f"wall_s={out['wall_s']!r} launches={counts}")
    print("serve lm: launches by entry: " + ", ".join(
        f"{e}={entries[e]}" for pair in LM_ENTRY.values() for e in pair))
    for name, (tensor_core, cuda_core) in LM_ENTRY.items():
        if entries[tensor_core] <= 0 or entries[cuda_core] \
                or entries[tensor_core] != counts[name]:
            raise AssertionError(f"serve lm: {name} not all on "
                                 f"{tensor_core}")
    if out["rejected"] or not out["tokens"]:
        raise AssertionError(f"serve lm: {out['rejected']} rejected")
    # each request's tokens against a solo generate on the same prompt
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen).cuda()
    solo = generate(cfg, params, prompt, LM_NEW,
                    cache_len=LM_PROMPT + LM_NEW + 1)
    for i, toks in enumerate(out["tokens"]):
        if not torch.equal(toks, solo):
            raise AssertionError(f"serve lm: request {i}'s tokens differ "
                                 f"from a solo generate")
    print(f"serve lm: all {len(out['tokens'])} requests' tokens equal a "
          f"solo generate on the same prompt", flush=True)
    return counts


def serve_hybrid_phase(torch):
    """``launch/serve.py --hybrid`` at kimi-k2's reduced() config on the
    real pair, cold then warm (the warm call plans from the unit times
    the cold one measured), then ``run_hybrid`` with the rows forced half
    on each group, so that both groups decode at once in one call and
    its combine gathers rows from both devices; each against a solo
    generate on the GPU.  Returns the launch counts of the three calls,
    each read right after its call and before its checks."""
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.serve.plain_check import check_tokens, greedy_with_gaps

    argv = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "64",
            "--new-tokens", "16"]
    solo = serve.main(argv).cpu()
    # main's own weights and prompt, for the forced call and the margin
    # rule's gaps
    cfg = registry.get(LM_ARCH).reduced()
    params = model_zoo.init(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                           device="cuda")
    calls = (("cold", lambda: serve.main(argv + ["--hybrid"])),
             ("warm", lambda: serve.main(argv + ["--hybrid"])),
             ("forced", lambda: serve.run_hybrid(cfg, params, prompt, 16,
                                                 plan_override=[2, 2])))
    counts, gaps, host_rows = {}, None, 0
    for label, call in calls:
        common.reset_launches()
        ws = call()
        for name, n in common.launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        split = {g: ws.trace.group_units.get(g, 0)
                 for g in ("accel", "host")}
        print(f"serve hybrid {label}: split={split} plan={ws.plan.units} "
              f"mode={ws.result.mode} {ws.result.row()}")
        rows_of = {}
        for rec in ws.trace.records:
            out = ws.trace.outputs[rec.chunk.seq]
            want = "cpu" if rec.group == "host" else "cuda:0"
            if str(out.device) != want:
                raise AssertionError(f"serve hybrid {label}: {rec.group}'s "
                                     f"rows ran on {out.device}")
            for b in range(rec.chunk.start,
                           rec.chunk.start + rec.chunk.units):
                rows_of[b] = rec.group
        host_rows += split["host"]
        value = ws.value.cpu()
        if label == "forced" and (split != {"accel": 2, "host": 2}
                                  or sorted(rows_of) != [0, 1, 2, 3]
                                  or value.shape[0] != 4):
            raise AssertionError(f"serve hybrid forced: split {split}, rows "
                                 f"{rows_of}: not both groups' rows in one "
                                 f"value")
        differ = [b for b in range(value.shape[0])
                  if not torch.equal(value[b], solo[b])]
        if any(rows_of[b] != "host" for b in differ):
            raise AssertionError(f"serve hybrid {label}: the GPU's rows "
                                 f"{differ} differ from a solo generate")
        if differ:
            # a CPU row (bf16 on the host) against the card's: the plain
            # check's margin rule, the gaps from the GPU's greedy run
            if gaps is None:
                _, gaps, _ = greedy_with_gaps(cfg, params, prompt, 16)
            for b, t, gap in check_tokens(value[differ], solo[differ],
                                          gaps.cpu()[differ]):
                print(f"serve hybrid {label}: host row {differ[b]} differs "
                      f"first at token {t}, GPU top-1/top-2 gap {gap!r}")
        print(f"serve hybrid {label}: the GPU's rows equal a solo generate "
              f"on the GPU, the host's {len(differ)} differing rows pass "
              f"the margin rule; each group's rows ran on its own device",
              flush=True)
    if host_rows == 0:
        raise AssertionError("serve hybrid: the host ran no rows")
    return counts


# ---------------------------------------------------------------------------
# continuous phase: the continuous-batching engine
# ---------------------------------------------------------------------------
CB_SLOTS, CB_BURST = 4, 8
# the reduced-config parts: kimi-k2 reduced() on the real pair
CB_R_PROMPT, CB_R_BURST = 64, 4
# the iteration steppers' requests on the real pair (the table1 phase's
# sizes), four a workload
CB_ITER = (("listrank", {"n": 1 << 22}),
           ("lbm", {"d": 128, "n_steps": 4}),
           ("dither", {"h": 1024, "w": 1024}))
CB_ITER_N = 4


def _entry_delta(before, after):
    return {e: after[e] - before.get(e, 0) for e in after
            if after[e] != before.get(e, 0)}


def _instrument(torch, common, stepper, engine_of):
    """Wrap the stepper's prefill and step: each call's time (both end
    synchronised) and its launches by C entry.  The engine's lane locks
    serialise its prefills and steps on one group, so the global counts'
    deltas are each call's own.  While ``rec["profile_at"]`` is set, the
    first step with that many live rows runs under ``profile_window`` on
    the engine's step thread instead (kept out of the record) and clears
    it.  Returns the record."""
    rec = {"prefill": [], "step": [], "profile_at": None}
    prefill, step = stepper.prefill, stepper.step

    def timed_prefill(spec):
        e0, t0 = common.entry_counts(), time.perf_counter()
        out = prefill(spec)
        rec["prefill"].append((time.perf_counter() - t0,
                               _entry_delta(e0, common.entry_counts())))
        return out

    def timed_step(state):
        eng = engine_of()
        n_live = eng.live_rows if eng is not None else None
        if n_live is not None and n_live == rec["profile_at"]:
            rec["profile_at"] = None
            out = []
            # the engine's step moves its state on: taken once
            profile_window(torch, f"serve continuous engine step profiled "
                           f"(live={n_live})", lambda: out.append(step(state)),
                           retake=False)
            return out[0]
        e0, t0 = common.entry_counts(), time.perf_counter()
        out = step(state)
        rec["step"].append((n_live, time.perf_counter() - t0,
                            _entry_delta(e0, common.entry_counts())))
        return out

    stepper.prefill, stepper.step = timed_prefill, timed_step
    return rec


def _burst(sched, wl, payloads, timeout=600):
    """Submit every payload at once; returns [(future, submit time on
    the scheduler's clock, latency s)] once all resolved."""
    done_at = {}

    def stamp(f):
        done_at[id(f)] = sched.clock()

    subs = []
    for p in payloads:
        t = sched.clock()
        f = sched.submit(wl, p)
        f.add_done_callback(stamp)
        subs.append((f, t))
    for f, _ in subs:
        f.result(timeout=timeout)
    return [(f, t, done_at[id(f)] - t) for f, t in subs]


def _lat_line(np, lat):
    p50, p95 = (float(v) for v in np.percentile(lat, [50, 95]))
    return f"latency_ms p50={p50 * 1e3!r} p95={p95 * 1e3!r}"


def _check_lm_entries(label, counts, entries):
    for name, (tensor_core, cuda_core) in LM_ENTRY.items():
        if entries.get(tensor_core, 0) <= 0 or entries.get(cuda_core, 0) \
                or entries[tensor_core] != counts[name]:
            raise AssertionError(f"{label}: {name} not all on {tensor_core} "
                                 f"({entries})")


def _slot_vs_solo(torch, cfg, params, stepper, prompts, n_new):
    """The slot-batched step against B = 1 steps on the same rows,
    teacher-forced with each row's solo tokens: each row prefilled
    alone, the rows stacked into the stepper's slots, then every step
    one ``decode_step`` over the slots at per-row positions.  Returns
    (max |logits diff|, argmax disagreements, steps x rows)."""
    from repro_torch.kernels.common import lane_device
    from repro_torch.models import model_zoo
    from repro_torch.serve.continuous import _tree_map
    from repro_torch.serve.serve_step import greedy_logits

    dev = torch.device("cuda", 0)
    solo_lg = []
    with torch.inference_mode(), lane_device(dev):
        state = stepper.init_slots()
        for b, prompt in enumerate(prompts):
            rows = list(greedy_logits(cfg, params, prompt, n_new,
                                      cache_len=stepper.cache_len))
            solo_lg.append(torch.stack(rows, 1)[0])      # (n_new + 1, V)
            first, caches = stepper._prefill(prompt)
            stepper.insert(state, b, (_tree_map(lambda a: a[0], caches),
                                      first[0]))
        n = len(prompts)
        toks = torch.stack([lg.argmax(-1) for lg in solo_lg])   # (n, T)
        pos = torch.full((CB_SLOTS,), stepper.prompt_len, dtype=torch.long,
                         device=dev)
        tok = torch.zeros((CB_SLOTS, 1), dtype=torch.int32, device=dev)
        worst, flips = 0.0, 0
        for t in range(n_new):
            tok[:n, 0] = toks[:, t].to(torch.int32)
            logits, state["caches"] = model_zoo.decode_step(
                cfg, params, tok, state["caches"], pos)
            lg = logits[:n, 0].float()
            want = torch.stack([s[t + 1] for s in solo_lg])
            worst = max(worst, (lg - want).abs().max().item())
            flips += int((lg.argmax(-1) != want.argmax(-1)).sum())
            pos += 1
    return worst, flips, n_new * len(prompts)


def serve_continuous_phase(torch, np, cfg, params):
    """The continuous-batching engine: (a) kimi-k2 at full width, depth
    2 (the LM phase's weights) on a scheduler over the accel group: a
    burst of batch-1 requests stacked into the slot-batched step, then
    ``run_stream(continuous=True)``; (b) the same burst with the engine
    off; (c) kimi-k2 reduced() on the real pair, cold; (d) the
    listrank, lbm and dither steppers on the real pair; (e)
    ``launch/serve.py --continuous``.  Returns the launch counts of (a):
    the burst's (set to 0 after the warm-up request, read right after
    the burst) plus the stream's (set to 0 just before it, read right
    after it), no check's among them."""
    import contextlib
    import io
    from types import SimpleNamespace

    from repro_torch.configs import registry
    from repro_torch.core.hybrid_executor import detect_platform
    from repro_torch.kernels import common
    from repro_torch.kernels.common import lane_device
    from repro_torch.launch import serve
    from repro_torch.launch.serve import run_stream
    from repro_torch.models import model_zoo
    from repro_torch.serve.plain_check import check_tokens, greedy_with_gaps
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.serve_step import generate
    from repro_torch.workloads import requests as adapters

    dev = torch.device("cuda", 0)
    accel = detect_platform()[0][0]
    t_phase = time.perf_counter()

    # (a) full width on the accel group
    wl = adapters.make_continuous_lm_adapter(
        cfg, params, prompt_len=LM_PROMPT, new_tokens=LM_NEW,
        n_slots=CB_SLOTS, warm_background=False, name="serve-lm-cb/chip")
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    sched = Scheduler(groups=[accel], max_batch=CB_BURST,
                      batch_window_s=0.002)
    rec = _instrument(torch, common, stepper,
                      lambda: next(iter(sched._engines.values()), None))
    t0 = time.perf_counter()
    sched.submit(wl, {"batch": 1, "seed": 100}).result(timeout=600)
    print(f"serve continuous: warm-up request (engine built, S={CB_SLOTS} "
          f"slots) {time.perf_counter() - t0!r} s", flush=True)
    rec["prefill"].clear()
    rec["step"].clear()
    common.reset_launches()
    st0 = sched.stats.snapshot()
    t0 = time.perf_counter()
    burst = _burst(sched, wl, [{"batch": 1, "seed": s}
                               for s in range(CB_BURST)])
    wall = time.perf_counter() - t0
    counts, entries = common.launch_counts(), common.entry_counts()
    st1 = sched.stats.snapshot()
    eng = next(iter(sched._engines.values()))
    snap = eng.snapshot()
    d = {k: st1[k] - st0[k] for k in ("engine_steps", "engine_joins",
                                      "engine_evictions")}
    lat = [x for _, _, x in burst]
    ttft = [f.meta["t_first_token"] - t for f, t, _ in burst]
    print(f"serve continuous burst: {CB_BURST} requests of batch 1 x "
          f"{LM_PROMPT} + {LM_NEW}: engine_steps={d['engine_steps']} "
          f"engine_joins={d['engine_joins']} engine_evictions="
          f"{d['engine_evictions']} max_live={snap['max_live']} "
          f"{_lat_line(np, lat)} ttft_ms p50="
          f"{float(np.median(ttft)) * 1e3!r} p95="
          f"{float(np.percentile(ttft, 95)) * 1e3!r} wall_s={wall!r} "
          f"tokens_per_s={CB_BURST * (LM_NEW + 1) / wall!r}", flush=True)
    for (f, t, x), tt in zip(burst, ttft):
        print(f"serve continuous burst: request ttft_ms={tt * 1e3!r} "
              f"latency_ms={x * 1e3!r}")
    if not 0 < d["engine_steps"] < CB_BURST * LM_NEW:
        raise AssertionError(f"serve continuous: {d['engine_steps']} steps "
                             f"for {CB_BURST} x {LM_NEW} row-steps: the "
                             f"rows did not stack")
    if d["engine_joins"] != CB_BURST or d["engine_evictions"] != CB_BURST:
        raise AssertionError(f"serve continuous: joins/evictions {d}")
    by_live = {}
    for n_live, s_, _ in rec["step"]:
        by_live.setdefault(n_live, []).append(s_)
    for n_live in sorted(by_live):
        print(f"serve continuous step: live={n_live} "
              f"median_step_s={statistics.median(by_live[n_live])!r} "
              f"n={len(by_live[n_live])}")
    pre_s = [s_ for s_, _ in rec["prefill"]]
    print(f"serve continuous prefill: B=1 median_s="
          f"{statistics.median(pre_s)!r} n={len(pre_s)} launches by entry "
          f"{rec['prefill'][0][1]}; a step: {rec['step'][-1][2]}")
    want = {"flash_attention": cfg.n_layers, "gmm": 0}
    m = cfg.moe
    want["gmm"] = 3 * (1 + m.overflow_passes) * (cfg.n_layers
                                                 - m.n_dense_layers)
    tc = {n: LM_ENTRY[n][0] for n in LM_ENTRY}
    for _, ent in rec["prefill"]:
        if ent.get(tc["flash_attention"], 0) != want["flash_attention"] \
                or ent.get(tc["gmm"], 0) != want["gmm"] \
                or any(ent.get(LM_ENTRY[n][1], 0) for n in LM_ENTRY):
            raise AssertionError(f"serve continuous: a prefill launched "
                                 f"{ent}, predicted {want} on "
                                 f"{list(tc.values())}")
    for _, _, ent in rec["step"]:
        if ent.get(tc["gmm"], 0) != want["gmm"] \
                or any(ent.get(LM_ENTRY[n][1], 0) for n in LM_ENTRY):
            raise AssertionError(f"serve continuous: a step launched {ent}, "
                                 f"predicted {want['gmm']} on {tc['gmm']}")
    # the GPU's idle share in one of the engine's own steps with every
    # slot live, on its step thread, in a second burst after the counts
    rec["profile_at"] = CB_SLOTS
    _burst(sched, wl, [{"batch": 1, "seed": CB_BURST + s}
                       for s in range(CB_BURST)])
    sched.shutdown()
    if rec["profile_at"] is not None:
        raise AssertionError(f"serve continuous: no step with {CB_SLOTS} "
                             f"live rows to profile")
    # each request's tokens against a solo generate of its prompt at B=1
    solos = []
    for s_, (f, _, _) in enumerate(burst):
        prompt = adapters.make_request(wl, {"batch": 1, "seed": s_}) \
            .arrays[0].on(dev)[0]
        solos.append(generate(cfg, params, prompt, LM_NEW,
                              cache_len=stepper.cache_len).cpu())
        got = f.result()
        if got.shape != solos[-1].shape or got.dtype != solos[-1].dtype \
                or not torch.equal(got, solos[-1]):
            raise AssertionError(f"serve continuous: request {s_} gave "
                                 f"{tuple(got.shape)} {got.dtype}, not its "
                                 f"solo generate's tokens")
    # the slot-batched step's numerics against B = 1 steps, teacher-forced
    prompts = [adapters.make_request(wl, {"batch": 1, "seed": s_})
               .arrays[0].on(dev)[0] for s_ in range(CB_SLOTS)]
    worst, flips, n_cmp = _slot_vs_solo(torch, cfg, params, stepper,
                                        prompts, LM_NEW)
    print(f"serve continuous: {CB_SLOTS}-slot step vs B=1 steps "
          f"(teacher-forced, {n_cmp} row-steps): max |logits diff| "
          f"{worst!r}, argmax disagreements {flips}", flush=True)
    if worst != 0.0 or flips:
        raise AssertionError("serve continuous: the slot-batched step is "
                             "not bitwise the B=1 step")
    print(f"serve continuous: all {CB_BURST} requests' tokens equal a "
          f"solo generate of their prompt at B=1", flush=True)

    # the stream: run_stream(continuous=True) at the serve lm phase's rate
    args = SimpleNamespace(batch=1, prompt_len=LM_PROMPT, new_tokens=LM_NEW,
                           rate=LM_STREAM_RATE, duration=LM_STREAM_SECONDS,
                           deadline=None, max_batch=8, window_ms=2.0,
                           continuous=True, trace=None, stats_json=None)
    common.reset_launches()
    out = run_stream(cfg, params, args, groups=[accel])
    for have, now in ((counts, common.launch_counts()),
                      (entries, common.entry_counts())):
        for k, n in now.items():
            have[k] = have.get(k, 0) + n
    adapters.unregister(out["workload"])
    if out["rejected"] or not out["tokens"]:
        raise AssertionError(f"serve continuous stream: {out['rejected']} "
                             f"rejected")
    st = out["stats"]
    print(f"serve continuous stream: {len(out['tokens'])} requests at "
          f"{LM_STREAM_RATE}/s for {LM_STREAM_SECONDS} s (+1 warmup): "
          f"{_lat_line(np, out['latency_s'])} ttft_ms p50="
          f"{float(np.median(out['ttft_s'])) * 1e3!r} engine_steps="
          f"{st.engine_steps} joins={st.engine_joins}", flush=True)
    print(f"serve continuous: launches={counts} by entry: " + ", ".join(
        f"{e}={entries[e]}" for pair in LM_ENTRY.values() for e in pair))
    _check_lm_entries("serve continuous", counts, entries)

    # (b) the same burst with the engine off: the monolithic route
    os.environ["REPRO_SERVE_CONTINUOUS"] = "0"
    try:
        sched = Scheduler(groups=[accel], max_batch=CB_BURST,
                          batch_window_s=0.002)
        sched.submit(wl, {"batch": 1, "seed": 100}).result(timeout=600)
        t0 = time.perf_counter()
        off = _burst(sched, wl, [{"batch": 1, "seed": s}
                                 for s in range(CB_BURST)])
        wall_off = time.perf_counter() - t0
        if sched.stats.engine_steps:
            raise AssertionError("serve continuous off: the engine ran")
        sched.shutdown()
    finally:
        os.environ.pop("REPRO_SERVE_CONTINUOUS", None)
    for s_, (f, _, _) in enumerate(off):
        if not torch.equal(f.result().cpu(), solos[s_]):
            raise AssertionError(f"serve continuous off: request {s_} "
                                 f"differs from its solo generate")
    print(f"serve continuous off (REPRO_SERVE_CONTINUOUS=0): {CB_BURST} "
          f"requests: {_lat_line(np, [x for _, _, x in off])} wall_s="
          f"{wall_off!r}; engine on: {_lat_line(np, lat)} wall_s={wall!r}",
          flush=True)
    adapters.unregister(wl)
    del stepper, burst, off
    gc.collect()

    # (c) kimi-k2 reduced() on the real pair, a fresh scheduler
    cfg_r = registry.get(LM_ARCH).reduced()
    params_r = model_zoo.init(cfg_r, 0, device=dev)
    sched = Scheduler()
    devs = [g.devices[0] for g in sched.groups]
    wl_r = adapters.make_continuous_lm_adapter(
        cfg_r, params_r, prompt_len=CB_R_PROMPT, new_tokens=LM_NEW,
        n_slots=CB_SLOTS, warm_background=False, name="serve-lm-cb/chip-r",
        devices=devs)
    stepper_r = adapters.make_request(wl_r, {"batch": 1}).stepper
    stepper_r.warm()
    res = _burst(sched, wl_r, [{"batch": 1, "seed": s}
                               for s in range(CB_R_BURST)])
    snap = sched.stats.snapshot()
    plan = sched.engine_placements[wl_r]
    sched.shutdown()
    by_name = {g.name: g.devices[0] for g in sched.groups}
    pre_dev, dec_dev = by_name[plan.prefill_group], \
        by_name[plan.decode_group]
    print(f"serve continuous reduced: engine_placements prefill="
          f"{plan.prefill_group} ({pre_dev}) decode={plan.decode_group} "
          f"({dec_dev}) est_prefill_s={plan.est_prefill_s!r} est_decode_s="
          f"{plan.est_decode_s!r} probe_runs={snap['probe_runs']} "
          f"engine_steps={snap['engine_steps']}", flush=True)
    if snap["probe_runs"] != 0:
        raise AssertionError("serve continuous reduced: a probe ran")
    w_dec = stepper_r.weights(dec_dev)
    n_differ = 0
    for s_, (f, _, _) in enumerate(res):
        prompt = adapters.make_request(wl_r, {"batch": 1, "seed": s_}) \
            .arrays[0].on(dec_dev)[0]
        solo = generate(cfg_r, w_dec, prompt, LM_NEW,
                        cache_len=stepper_r.cache_len).cpu()
        got = f.result()
        if torch.equal(got, solo):
            continue
        if str(pre_dev) == str(dec_dev):
            raise AssertionError(f"serve continuous reduced: request {s_} "
                                 f"differs from a solo generate on "
                                 f"{dec_dev}")
        # prefill on one device, decode on the other: the margin rule
        _, gaps, _ = greedy_with_gaps(cfg_r, w_dec, prompt, LM_NEW)
        for _, t, gap in check_tokens(got, solo, gaps.cpu()):
            print(f"serve continuous reduced: request {s_} differs first "
                  f"at token {t}, solo top-1/top-2 gap {gap!r} (prefill on "
                  f"{pre_dev}, decode on {dec_dev})")
        n_differ += 1
    print(f"serve continuous reduced: {CB_R_BURST - n_differ} of "
          f"{CB_R_BURST} requests equal a solo generate on {dec_dev}, the "
          f"rest pass the margin rule", flush=True)
    adapters.unregister(wl_r)

    # (d) the iteration steppers on the real pair
    sched = Scheduler()
    for name, payload in CB_ITER:
        t0 = time.perf_counter()
        res = _burst(sched, name, [dict(payload, seed=s, continuous=True)
                                   for s in range(CB_ITER_N)])
        wall_i = time.perf_counter() - t0
        spec = adapters.make_request(name, dict(payload, continuous=True))
        plan = sched.engine_placements[spec.stepper.workload]
        eng = sched._engines[id(spec.stepper)].snapshot()
        dec_dev = {g.name: g.devices[0] for g in sched.groups}[
            plan.decode_group]
        for s_, (f, _, _) in enumerate(res):
            with lane_device(dec_dev):
                solo = adapters.make_request(
                    name, dict(payload, seed=s_)).run_one()
            got = f.result()
            if isinstance(solo, torch.Tensor):
                ok = (got.device == solo.device
                      and torch.equal(got, solo))
            else:
                ok = np.array_equal(got, solo)
            if not ok:
                raise AssertionError(f"serve continuous {name}: request "
                                     f"{s_} differs from its solo run_one "
                                     f"on {dec_dev}")
        print(f"serve continuous {name}: {CB_ITER_N} requests {payload} "
              f"prefill={plan.prefill_group} decode={plan.decode_group} "
              f"({dec_dev}) steps={eng['steps']} max_live={eng['max_live']} "
              f"wall_s={wall_i!r} {_lat_line(np, [x for _, _, x in res])}; "
              f"every value bitwise its solo run_one on {dec_dev}",
              flush=True)
    sched.shutdown()

    # (e) launch/serve.py --continuous at kimi-k2's reduced config
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(["--arch", LM_ARCH, "--batch", "1", "--prompt-len",
                          str(CB_R_PROMPT), "--new-tokens", str(LM_NEW),
                          "--stream", "--continuous", "--rate", "4",
                          "--duration", "2"])
    text = buf.getvalue()
    print("\n".join(f"serve continuous cli: {ln}"
                    for ln in text.splitlines()))
    engine_lines = [ln for ln in text.splitlines()
                    if ln.startswith("engine ") and " prefill=" in ln
                    and " decode=" in ln]
    if out["rejected"] or not out["tokens"] or len(engine_lines) != 1:
        raise AssertionError("serve continuous cli: no engine line or a "
                             "rejected request")
    adapters.unregister(out["workload"])
    print(f"serve continuous: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# lm tuned phase: tp= (the repeated K/V heads) and the model layers'
# tune-cache lookup, on the LM phase's kimi-k2 weights
# ---------------------------------------------------------------------------
LM_TP = 16
# the CUDA-core bf16 entries a tune-cache hit may name
K7_FMA_BF16, K8_FMA_BF16 = "flash_attention_fma_bf16", "gmm_fma_bf16"


def _lm_run(torch, common, label, fn):
    """``fn()``'s tokens and its launch counts (total and by C entry),
    the counts set to 0 just before it and read just after it."""
    common.reset_launches()
    t0 = time.perf_counter()
    toks = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, entries = common.launch_counts(), common.entry_counts()
    print(f"{label}: wall_s={wall!r} launches={counts} by entry " + ", ".join(
        f"{e}={entries[e]}" for pair in LM_ENTRY.values() for e in pair),
        flush=True)
    return toks, counts, entries


def _margin(label, toks, plain, gaps):
    """The margin rule against the default run (``plain_check``)."""
    from repro_torch.serve.plain_check import MARGIN, check_tokens
    try:
        differed = check_tokens(toks, plain, gaps)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    print(f"{label}: {toks.shape[0] - len(differed)} of {toks.shape[0]} "
          f"rows equal to the default run's tokens; the others differ "
          f"first where its top-1/top-2 gap < {MARGIN}: {differed}",
          flush=True)


def lm_tuned_phase(torch, dev, cfg, params, flush):
    """kimi-k2 (full width, depth 2; the LM phase's weights) through
    ``generate`` at 4 x 1024 + 16 with the search off, against the
    default run (tp = 1, no pin, no hit: its tokens, top-1/top-2 gaps and
    launches): (a) at tp = 16 (kv_repeat 2: the caches' bytes twice
    tp = 1's, K7 on its tensor-core entry over 16 K/V heads a row); (b)
    K7 pinned to the blocked attention, then K8 to the einsum: the
    pinned kernel launches 0 times, the other as in the default run;
    (c) a tune-cache hit with the search on and a timer that fails if
    called: K7's prefill bucket on its CUDA-core entry, K8's decode
    up/gate bucket on the einsum; (d) K7's row at the tp = 16 prefill
    shape.  The tokens of (a)-(c) against the default run's under the
    margin rule.  Returns the launch counts of (a)-(c)'s ``generate``
    calls, summed, and (d)'s row."""
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.models import model_zoo
    from repro_torch.models.attention import kv_repeat_for
    from repro_torch.serve.plain_check import greedy_with_gaps
    from repro_torch.serve.serve_step import generate

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)   # the LM phase's
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    B, H, Kv, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = LM_PROMPT + LM_NEW
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers
    passes = 1 + m.overflow_passes
    k7, k8 = cfg.n_layers, 3 * passes * n_moe * (1 + LM_NEW)
    total = {}

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    # the default run: tokens, gaps and the prefill's last logits
    plain, gaps, last1 = greedy_with_gaps(cfg, params, prompt, LM_NEW)
    _, base, base_entries = _lm_run(torch, common, "lm tuned default",
                                    lambda: generate(cfg, params, prompt,
                                                     LM_NEW))
    if base["flash_attention"] != k7 or base["gmm"] != k8:
        raise AssertionError(f"lm tuned default: launches {base}, "
                             f"predicted K7 {k7}, K8 {k8}")

    # (a) tp = 16
    rep = kv_repeat_for(cfg, LM_TP)
    c1 = model_zoo.init_caches(cfg, B, L, device=dev)
    c16 = model_zoo.init_caches(cfg, B, L, tp=LM_TP, device=dev)
    nbytes = [sum(t.numel() * t.element_size() for t in leaves(c))
              for c in (c1, c16)]
    del c1, c16
    print(f"lm tuned tp={LM_TP}: kv_repeat={rep} K/V heads "
          f"{Kv} -> {Kv * rep} cache_bytes tp=1 {nbytes[0]} tp={LM_TP} "
          f"{nbytes[1]}", flush=True)
    if rep != 2 or nbytes[1] != 2 * nbytes[0]:
        raise AssertionError(f"lm tuned tp={LM_TP}: kv_repeat {rep}, "
                             f"cache bytes {nbytes}")
    kv_rows, real = [], flash_ops.flash_attention_cuda

    def k7_spy(q, k, v, causal, entry=None):
        kv_rows.append(k.shape[0])
        return real(q, k, v, causal, entry=entry)
    flash_ops.flash_attention_cuda = k7_spy
    try:
        toks, counts, entries = _lm_run(
            torch, common, f"lm tuned tp={LM_TP} generate",
            lambda: generate(cfg, params, prompt, LM_NEW, tp=LM_TP))
    finally:
        flash_ops.flash_attention_cuda = real
    add(counts)
    wgmma = LM_ENTRY["flash_attention"][0]
    if counts != base or entries[wgmma] != k7 or \
            kv_rows != [B * Kv * rep] * k7:
        raise AssertionError(
            f"lm tuned tp={LM_TP}: launches {counts} (default {base}), "
            f"{entries[wgmma]} through {wgmma}, K/V rows a launch "
            f"{kv_rows} (want {B * Kv * rep} each)")
    _margin(f"lm tuned tp={LM_TP}", toks, plain, gaps)
    _, _, last16 = greedy_with_gaps(cfg, params, prompt, 0, tp=LM_TP)
    print(f"lm tuned tp={LM_TP}: K7 {k7} launches on {wgmma}, "
          f"{kv_rows[0] // B} K/V heads a row; prefill's last logits "
          f"max |diff| against tp=1 {(last16 - last1).abs().max().item()!r}"
          f" bitwise={bool(torch.equal(last16, last1))}", flush=True)

    # (b) a pin on each kernel
    for kernel, pin in (("flash_attention",
                         '{"impl": "torch_blocked", "block_q": 256}'),
                        ("gmm", '{"impl": "torch_einsum"}')):
        var = "REPRO_TUNE_PIN_" + kernel.upper()
        os.environ[var] = pin
        try:
            toks, counts, _ = _lm_run(
                torch, common, f"lm tuned pin {kernel}",
                lambda: generate(cfg, params, prompt, LM_NEW))
        finally:
            del os.environ[var]
        add(counts)
        other = "gmm" if kernel == "flash_attention" else "flash_attention"
        if counts[kernel] != 0 or counts[other] != base[other]:
            raise AssertionError(f"lm tuned pin {kernel}: launches "
                                 f"{counts}, default {base}")
        _margin(f"lm tuned pin {kernel}", toks, plain, gaps)

    # (c) a tune-cache hit with the search on; nothing may be timed
    root = os.path.join(common.BUILD_DIR, "autotune")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "lm_tuned.json")
    k7_bucket = flash_ops.shape_bucket(B * H, LM_PROMPT, LM_PROMPT, d, True)
    # a decode step's MoE buffers: (E, B * C, D) at C = 1 in both passes
    k8_bucket = gmm_ops.shape_bucket(m.n_routed, B, cfg.d_model, m.d_ff)
    with open(path, "w") as f:
        json.dump({"torch:cuda": {
            "flash_attention": {k7_bucket: {
                "config": {"impl": "cuda", "entry": K7_FMA_BF16},
                "us": 1.0}},
            "gmm": {k8_bucket: {"config": {"impl": "torch_einsum"},
                                "us": 1.0}}}}, f)
    saved = {v: os.environ.get(v) for v in ("REPRO_AUTOTUNE",
                                            "REPRO_TUNE_CACHE")}

    def no_search(fn):
        raise AssertionError("lm tuned hit: the model path timed a "
                             "candidate")
    os.environ["REPRO_AUTOTUNE"], os.environ["REPRO_TUNE_CACHE"] = "1", path
    at.reset_tune_cache()
    prev = at.set_timer(no_search)
    try:
        toks, counts, entries = _lm_run(
            torch, common, "lm tuned hit",
            lambda: generate(cfg, params, prompt, LM_NEW))
    finally:
        at.set_timer(prev)
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
        at.reset_tune_cache()
        os.remove(path)
    add(counts)
    # 4 of a step's 6 K8 launches (up and gate, both passes) are the hit's
    want_k8 = k8 - 4 * n_moe * LM_NEW
    print(f"lm tuned hit: buckets {k7_bucket} -> {K7_FMA_BF16}, "
          f"{k8_bucket} -> torch_einsum; K7 {entries[K7_FMA_BF16]} on "
          f"{K7_FMA_BF16}, K8 {counts['gmm']} (predicted {want_k8})",
          flush=True)
    if entries[K7_FMA_BF16] != k7 or entries[wgmma] or \
            counts["gmm"] != want_k8 or \
            entries[LM_ENTRY["gmm"][0]] != want_k8:
        raise AssertionError(f"lm tuned hit: launches {counts} {entries}")
    _margin("lm tuned hit", toks, plain, gaps)
    del toks, plain, gaps, last1, last16

    # (d) K7 at the tp = 16 prefill shape
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((B * n, LM_PROMPT, d), generator=g, device=dev)
               .to(torch.bfloat16) for n in (H, Kv * rep, Kv * rep))
    row = _k7_row(torch, flush, f"tp={LM_TP} prefill", q, k, v, True)
    row["path"] = "lm tuned"
    print(f"lm tuned: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, row


# ---------------------------------------------------------------------------
# model-families phase: MLA (deepseek-v2-lite-16b, minicpm3-4b) and the
# encoder-decoder (whisper-tiny)
# ---------------------------------------------------------------------------
FAM_DEEPSEEK, FAM_MINICPM, FAM_WHISPER = ("deepseek-v2-lite-16b",
                                          "minicpm3-4b", "whisper-tiny")
# minicpm3-4b cut to the first half of its 62 MLA layers (every layer
# is alike) to keep the whole run under its time limit on a loaded host
MINICPM_LAYERS = 31
# whisper's 30 s window: 1500 encoder frames; 448 decoder positions
WHISPER_FRAMES, WHISPER_DEC = 1500, 448
BF16_MODEL_TOL = dict(atol=0.25, rtol=0.1)   # tests/test_models.py's


def deepseek_phase(torch, dev):
    """(a) deepseek-v2-lite-16b at full width and depth (MLA + 64 experts
    top-6, two shared experts, a dense first layer) through greedy
    ``generate``: K8 on the MoE layers, then the plain path's tokens
    under the margin rule, then K8's rows at the prefill and the decode
    shapes on the model's expert weights.  Returns (the generate call's
    launch counts, the rows)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.models import model_zoo
    from repro_torch.models.param import count_params, param_bytes
    from repro_torch.serve.plain_check import (MARGIN, check_tokens,
                                               greedy_with_gaps,
                                               plain_kernels)
    from repro_torch.serve.serve_step import (generate, make_prefill_step,
                                              make_serve_step)

    cfg = registry.get(FAM_DEEPSEEK)
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"deepseek: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"mla kv_lora={cfg.mla.kv_lora_rank} rope={cfg.mla.qk_rope_head_dim}"
          f" experts={m.n_routed} top{m.top_k} shared={m.n_shared} "
          f"d_ff={m.d_ff}/{cfg.d_ff} layers={cfg.n_layers} (all: "
          f"{m.n_dense_layers} dense, {n_moe} MoE) params="
          f"{count_params(params)} weights_bytes={param_bytes(params)} "
          f"init_s={time.perf_counter() - t0!r}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)

    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, entries = common.launch_counts(), common.entry_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 0,
            "gmm": 3 * (1 + m.overflow_passes) * n_moe * (1 + LM_NEW)}
    print(f"deepseek generate: batch={LM_BATCH} prompt={LM_PROMPT} "
          f"new={LM_NEW} wall_s={wall!r} peak_bytes={peak} launches="
          f"{counts} predicted={want} by entry: gmm_wgmma_bf16="
          f"{entries['gmm_wgmma_bf16']} gmm_fma_bf16="
          f"{entries['gmm_fma_bf16']}", flush=True)
    if counts["gmm"] != want["gmm"] or counts["flash_attention"] \
            or entries["gmm_wgmma_bf16"] != want["gmm"]:
        raise AssertionError(f"deepseek generate: launches {counts} "
                             f"{entries}, predicted {want} on gmm_wgmma_bf16")
    if toks.shape != (LM_BATCH, LM_NEW + 1) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"deepseek generate: bad tokens {toks}")

    L = LM_PROMPT + LM_NEW
    with torch.inference_mode():
        prefill = make_prefill_step(cfg, cache_len=L)
        step = make_serve_step(cfg)
        common.reset_launches()
        t0 = time.perf_counter()
        tok, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = common.launch_counts()["gmm"]
        tok = tok.to(torch.int32)
        step_s, per_step = [], []
        for t in range(LM_NEW):
            common.reset_launches()
            t0 = time.perf_counter()
            tok, caches = step(params, tok, caches, LM_PROMPT + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(common.launch_counts()["gmm"])
        # how much of a step is K8 and how much the host's dispatch
        profile_window(torch, "deepseek decode profiled",
                       lambda: step(params, tok, caches, L - 1))
        del caches
    decode_s = statistics.median(step_s)
    print(f"deepseek prefill: ms={prefill_s * 1e3!r} tokens_per_s="
          f"{LM_BATCH * LM_PROMPT / prefill_s!r} gmm_launches={per_prefill}")
    print(f"deepseek decode: median_step_ms={decode_s * 1e3!r} min_step_ms="
          f"{min(step_s) * 1e3!r} tokens_per_s={LM_BATCH / decode_s!r} "
          f"gmm_launches_per_step={per_step[-1]}", flush=True)
    if per_prefill <= 0 or min(per_step) <= 0:
        raise AssertionError("deepseek: K8 not launched in a prefill or a "
                             "step")

    common.reset_launches()
    with plain_kernels():
        plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, LM_NEW)
    if common.launch_counts()["gmm"]:
        raise AssertionError("deepseek plain path launched K8")
    try:
        differed = check_tokens(toks, plain, gaps)
    except AssertionError as e:
        raise AssertionError(f"deepseek check: {e}") from None
    for b, t, gap in differed:
        print(f"deepseek: row {b} differs first at token {t}, plain "
              f"top-1/top-2 gap {gap!r}")
    print(f"deepseek check: {LM_BATCH - len(differed)} of {LM_BATCH} rows "
          f"equal to the plain path's tokens; the others pass the margin "
          f"rule (gap < {MARGIN}); min gap {gaps.min().item()!r}",
          flush=True)

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    w_up = params["stack"]["groups"][0]["l0"]["ffn"]["w_up"]
    C = max(1, int(LM_PROMPT * m.top_k / m.n_routed * m.capacity_factor))
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, c in (("deepseek prefill up", LM_BATCH * C),
                     ("deepseek decode up", LM_BATCH)):
        x = torch.randn((m.n_routed, c, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        rows.append(_k8_row(torch, flush, label, x, w_up))
        rows[-1].update(path="deepseek generate",
                        launches_per_prefill=per_prefill,
                        launches_per_decode_step=per_step[-1])
    del flush
    mesh_counts, mesh_rows = deepseek_mesh(torch, dev, cfg, params, prompt)
    rows += mesh_rows
    del params
    gc.collect()
    return counts, mesh_counts, rows


def _logits_run(torch, cfg, params, prompt, n_steps):
    """The prefill's and ``n_steps`` greedy decode steps' logits."""
    from repro_torch.models import model_zoo
    P = prompt.shape[1]
    with torch.inference_mode():
        logits, caches = model_zoo.prefill(cfg, params, {"tokens": prompt},
                                           P + n_steps)
        out = [logits]
        tok = logits[:, -1:].argmax(-1)
        for t in range(n_steps):
            logits, caches = model_zoo.decode_step(cfg, params, tok, caches,
                                                   P + t)
            out.append(logits)
            tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    return out


def deepseek_mesh(torch, dev, cfg, params, prompt):
    """The mesh on the card: a one-device mesh over cuda:0 (an nccl
    group of one rank), on deepseek-v2-lite-16b's full-width weights
    that the deepseek phase holds.  (a) the baseline config's prefill
    and 4 greedy decode steps under ``use_mesh`` give the no-mesh logits
    bitwise, with the same K8 launches; (b) ``get_optimized``'s preset
    (the shard_map MoE: one-hot dispatch, capacity 1.05, no overflow
    pass) through one greedy ``generate`` of a 1 x 1024 prompt under
    the mesh: K8 exactly 3 times per MoE layer per forward, its prefill
    and step times, and K8's rows at the smap MoE's two new shapes; (c)
    layer 1's MoE at full width, the smap form against the dense
    ``moe_ffn`` at a capacity that drops no token, bf16, K8 on both,
    within 1e-2.  Returns ((b)'s launch counts, the rows)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import sharding as ps
    from repro_torch.serve.serve_step import (generate, make_prefill_step,
                                              make_serve_step)

    t_phase = time.perf_counter()
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers
    t0 = time.perf_counter()
    mesh = mesh_mod.make_host_mesh()
    print(f"deepseek mesh: {mesh} over {dev} (nccl, world "
          f"{torch.distributed.get_world_size()}) built_s="
          f"{time.perf_counter() - t0!r}", flush=True)
    try:
        # (a) the baseline under the mesh: the no-mesh logits bitwise
        n_a = 4
        runs = []
        for under in (False, True):
            common.reset_launches()
            if under:
                with ps.use_mesh(mesh):
                    runs.append(_logits_run(torch, cfg, params, prompt, n_a))
            else:
                runs.append(_logits_run(torch, cfg, params, prompt, n_a))
            runs[-1] = (runs[-1], common.launch_counts()["gmm"])
        (plain_l, plain_k8), (mesh_l, mesh_k8) = runs
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(plain_l, mesh_l))
        want_a = 3 * (1 + m.overflow_passes) * n_moe * (1 + n_a)
        print(f"deepseek mesh (a): baseline prefill {tuple(prompt.shape)} "
              f"+ {n_a} decode steps, mesh vs no mesh max_abs_diff="
              f"{diff!r} bitwise={diff == 0.0} gmm_launches mesh="
              f"{mesh_k8} no_mesh={plain_k8} predicted={want_a}",
              flush=True)
        if diff != 0.0 or not all(torch.equal(a, b)
                                  for a, b in zip(plain_l, mesh_l)):
            raise AssertionError(f"deepseek mesh (a): logits differ under "
                                 f"the mesh (max {diff})")
        if mesh_k8 != plain_k8 or mesh_k8 != want_a:
            raise AssertionError(f"deepseek mesh (a): K8 launches {mesh_k8} "
                                 f"under the mesh, {plain_k8} without, "
                                 f"predicted {want_a}")
        del plain_l, mesh_l, runs

        # (b) the optimized preset through generate under the mesh
        opt = registry.get_optimized(FAM_DEEPSEEK)
        om = opt.moe
        if (om.shard_mode, om.dispatch, om.capacity_factor,
                om.overflow_passes) != ("smap", "onehot", 1.05, 0):
            raise AssertionError(f"deepseek mesh (b): preset {om}")
        prompt1 = prompt[:1]
        P = prompt1.shape[1]
        n_b = 8
        calls = []
        real = moe_mod.moe_ffn

        def spy(p, x, c):
            calls.append(tuple(x.shape))
            return real(p, x, c)

        with ps.use_mesh(mesh):
            common.reset_launches()
            moe_mod.moe_ffn = spy
            try:
                toks = generate(opt, params, prompt1, n_b)
                torch.cuda.synchronize()
            finally:
                moe_mod.moe_ffn = real
            counts = common.launch_counts()
            entries = common.entry_counts()
            # the dispatch group's capacity at each call: one group of
            # all the call's tokens
            cap = {n: max(1, int(n * om.top_k / om.n_routed
                                 * om.capacity_factor)) for n in (P, 1)}
            with torch.inference_mode():
                prefill = make_prefill_step(opt, cache_len=P + n_b)
                step = make_serve_step(opt)
                t0 = time.perf_counter()
                tok, caches = prefill(params, {"tokens": prompt1})
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                tok = tok.to(torch.int32)
                step_s = []
                for t in range(n_b):
                    t0 = time.perf_counter()
                    tok, caches = step(params, tok, caches, P + t)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                # where a smap step's time goes: K8, the one-rank nccl
                # collectives, the host
                profile_window(torch, "deepseek mesh (b) decode profiled",
                               lambda: step(params, tok, caches,
                                            P + n_b - 1))
                del caches
        want_b = 3 * n_moe * (1 + n_b)
        print(f"deepseek mesh (b): get_optimized preset shard_mode="
              f"{om.shard_mode} dispatch={om.dispatch} capacity_factor="
              f"{om.capacity_factor} overflow_passes={om.overflow_passes} "
              f"remat={opt.parallel.remat}; generate prompt={P} new={n_b} "
              f"launches={counts} predicted gmm={want_b} (3 a MoE layer a "
              f"forward, {n_moe} MoE layers, {1 + n_b} forwards) by entry: "
              f"gmm_wgmma_bf16={entries['gmm_wgmma_bf16']} gmm_fma_bf16="
              f"{entries['gmm_fma_bf16']}; smap calls {len(calls)}; "
              f"capacity prefill C={cap[P]} decode C={cap[1]}", flush=True)
        print(f"deepseek mesh (b): prefill ms={prefill_s * 1e3!r} "
              f"tokens_per_s={P / prefill_s!r}; decode median_step_ms="
              f"{statistics.median(step_s) * 1e3!r} min_step_ms="
              f"{min(step_s) * 1e3!r}", flush=True)
        if counts["gmm"] != want_b or entries["gmm_wgmma_bf16"] != want_b \
                or counts["flash_attention"]:
            raise AssertionError(f"deepseek mesh (b): launches {counts} "
                                 f"{entries}, predicted gmm {want_b} on "
                                 f"gmm_wgmma_bf16")
        if calls != [(1, P, cfg.d_model)] * n_moe \
                + [(1, 1, cfg.d_model)] * (n_moe * n_b):
            raise AssertionError(f"deepseek mesh (b): smap MoE calls "
                                 f"{calls[:3]}... ({len(calls)})")
        if toks.shape != (1, n_b + 1) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"deepseek mesh (b): bad tokens {toks}")

        # K8 at the smap MoE's shapes: one dispatch group of the call's
        # tokens, experts whole on the one-rank data axis
        flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
        w_up = params["stack"]["groups"][0]["l0"]["ffn"]["w_up"]
        gen = torch.Generator(device=dev).manual_seed(5)
        rows = []
        for label, c in (("deepseek smap prefill up", cap[P]),
                         ("deepseek smap decode up", cap[1])):
            x = torch.randn((m.n_routed, c, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            rows.append(_k8_row(torch, flush, label, x, w_up))
            rows[-1].update(path="deepseek mesh generate",
                            launches_per_prefill=3 * n_moe,
                            launches_per_decode_step=3 * n_moe)
        del flush

        # (c) layer 1's MoE: smap against dense, no token dropped
        lp = params["stack"]["groups"][0]["l0"]["ffn"]
        cf = float(math.ceil(m.n_routed / m.top_k))
        dense = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=cf, overflow_passes=0))
        smap = opt.replace(moe=dataclasses.replace(om, capacity_factor=cf))
        x = torch.randn((1, P, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            common.reset_launches()
            y0, a0 = moe_mod.moe_ffn(lp, x, dense)
            k8_dense = common.launch_counts()["gmm"]
            common.reset_launches()
            with ps.use_mesh(mesh):
                y1, a1 = moe_mod.moe_ffn(lp, x, smap)
            k8_smap = common.launch_counts()["gmm"]
        torch.cuda.synchronize()
        err = (y0.float() - y1.float()).abs().max().item()
        print(f"deepseek mesh (c): layer 1 MoE at x {tuple(x.shape)} bf16, "
              f"capacity_factor={cf} (>= {m.n_routed}/{m.top_k}: no drop): "
              f"smap vs dense max_abs_err={err!r} aux {a1.item()!r} vs "
              f"{a0.item()!r}; gmm launches smap={k8_smap} dense="
              f"{k8_dense}", flush=True)
        torch.testing.assert_close(
            y1.float(), y0.float(), rtol=1e-2, atol=1e-2,
            msg=lambda s: f"deepseek mesh (c): smap vs dense: {s}")
        if k8_smap != 3 or k8_dense != 3:
            raise AssertionError(f"deepseek mesh (c): K8 launches smap "
                                 f"{k8_smap}, dense {k8_dense}, want 3 each")
    finally:
        mesh_mod.release()
    if torch.distributed.is_initialized():
        raise AssertionError("deepseek mesh: process group left behind")
    print(f"deepseek mesh: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, rows


def minicpm_phase(torch, np):
    """(b) minicpm3-4b at full width, cut to ``MINICPM_LAYERS`` of its
    62 MLA layers (query LoRA, dense FFNs), on the continuous engine over
    the accel group: a burst of batch-1 requests into the slot-batched
    step, each request's tokens bitwise a solo ``generate``, the 4-slot
    step's logits bitwise four B = 1 steps'.  Returns the burst's launch
    counts."""
    from repro_torch.configs import registry
    from repro_torch.core.hybrid_executor import detect_platform
    from repro_torch.kernels import common
    from repro_torch.models import model_zoo
    from repro_torch.models.param import count_params, param_bytes
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.serve_step import generate
    from repro_torch.workloads import requests as adapters

    dev = torch.device("cuda", 0)
    cfg = registry.get(FAM_MINICPM).replace(n_layers=MINICPM_LAYERS)
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"minicpm3: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"mla q_lora={cfg.mla.q_lora_rank} kv_lora={cfg.mla.kv_lora_rank} "
          f"d_ff={cfg.d_ff} layers={cfg.n_layers} params="
          f"{count_params(params)} weights_bytes={param_bytes(params)} "
          f"init_s={time.perf_counter() - t0!r}", flush=True)
    wl = adapters.make_continuous_lm_adapter(
        cfg, params, prompt_len=LM_PROMPT, new_tokens=LM_NEW,
        n_slots=CB_SLOTS, warm_background=False, name="serve-lm-cb/chip-mla")
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    sched = Scheduler(groups=[detect_platform()[0][0]], max_batch=CB_BURST,
                      batch_window_s=0.002)
    rec = _instrument(torch, common, stepper,
                      lambda: next(iter(sched._engines.values()), None))
    sched.submit(wl, {"batch": 1, "seed": 100}).result(timeout=600)
    rec["prefill"].clear()
    rec["step"].clear()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    st0 = sched.stats.snapshot()
    t0 = time.perf_counter()
    burst = _burst(sched, wl, [{"batch": 1, "seed": s}
                               for s in range(CB_BURST)])
    wall = time.perf_counter() - t0
    counts = common.launch_counts()
    st1 = sched.stats.snapshot()
    sched.shutdown()
    peak = torch.cuda.max_memory_allocated()
    d = {k: st1[k] - st0[k] for k in ("engine_steps", "engine_joins",
                                      "engine_evictions")}
    lat = [x for _, _, x in burst]
    ttft = [f.meta["t_first_token"] - t for f, t, _ in burst]
    print(f"minicpm3 continuous burst: {CB_BURST} requests of batch 1 x "
          f"{LM_PROMPT} + {LM_NEW} into {CB_SLOTS} slots: {d} "
          f"{_lat_line(np, lat)} ttft_ms p50={float(np.median(ttft)) * 1e3!r}"
          f" wall_s={wall!r} tokens_per_s={CB_BURST * (LM_NEW + 1) / wall!r}"
          f" peak_bytes={peak} launches={counts}", flush=True)
    if not 0 < d["engine_steps"] < CB_BURST * LM_NEW \
            or d["engine_joins"] != CB_BURST:
        raise AssertionError(f"minicpm3 continuous: {d}: the rows did not "
                             f"stack")
    by_live = {}
    for n_live, s_, _ in rec["step"]:
        by_live.setdefault(n_live, []).append(s_)
    print("minicpm3 continuous step: " + " ".join(
        f"live={n} median_ms={statistics.median(v) * 1e3!r} (n={len(v)})"
        for n, v in sorted(by_live.items())) + f"; a B=1 prefill median_ms="
        f"{statistics.median(s_ for s_, _ in rec['prefill']) * 1e3!r}",
        flush=True)
    for s_, (f, _, _) in enumerate(burst):
        prompt = adapters.make_request(wl, {"batch": 1, "seed": s_}) \
            .arrays[0].on(dev)[0]
        solo = generate(cfg, params, prompt, LM_NEW,
                        cache_len=stepper.cache_len).cpu()
        if not torch.equal(f.result(), solo):
            raise AssertionError(f"minicpm3 continuous: request {s_} is not "
                                 f"its solo generate's tokens")
    prompts = [adapters.make_request(wl, {"batch": 1, "seed": s_})
               .arrays[0].on(dev)[0] for s_ in range(CB_SLOTS)]
    worst, flips, n_cmp = _slot_vs_solo(torch, cfg, params, stepper,
                                        prompts, LM_NEW)
    print(f"minicpm3 continuous: {CB_SLOTS}-slot step vs B=1 steps "
          f"(teacher-forced, {n_cmp} row-steps): max |logits diff| "
          f"{worst!r}, argmax disagreements {flips}; all {CB_BURST} "
          f"requests' tokens equal a solo generate at B=1", flush=True)
    if worst != 0.0 or flips:
        raise AssertionError("minicpm3 continuous: the slot-batched MLA "
                             "step is not bitwise the B=1 step")
    adapters.unregister(wl)
    del stepper, burst, params
    gc.collect()
    return counts


def _held_sdpa(torch, held, label):
    """(the real ``flash_ops.sdpa``, one that holds each K7 launch
    against its plain version): ``held`` maps (heads, K/V heads, d, T,
    S, causal) to (launches, max error)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    real = flash_ops.sdpa

    def sdpa(q, k, v, *, causal=True, config=None):
        out = real(q, k, v, causal=causal, config=config)
        ref = flash_ops.flash_attention(q, k, v, causal=causal,
                                        use_kernel=False)
        key = (q.shape[2], k.shape[2], q.shape[3], q.shape[1], k.shape[1],
               causal)
        tol = TOL["flash_attention"]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{label} K7 "
                                   f"{key}: {m}")
        n, e = held.get(key, (0, 0.0))
        held[key] = (n + 1, max(e, (out.float() - ref.float()).abs()
                                .max().item()))
        return out

    return real, sdpa


def whisper_phase(torch, dev):
    """(c) whisper-tiny, full config: the encoder over 1500 frames and
    the teacher-forced decoder over 448 tokens at B = 4, then decode
    steps against ``decode_train``'s logits.  K7's full route runs at
    T = S = 1500 (encoder), T = 448, S = 1500 (cross-attention) and
    T = 1, S = 1500 (a step's cross-attention); every K7 launch of the
    counted pass is held against its plain version on the same inputs.
    Returns (the pass's launch counts, K7's rows at the three shapes)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import encdec, model_zoo
    from repro_torch.models.param import count_params

    cfg = registry.get(FAM_WHISPER)
    params = model_zoo.init(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    B = LM_BATCH
    frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    dec = torch.randint(0, cfg.vocab_size, (B, WHISPER_DEC), generator=gen,
                        device=dev)
    print(f"whisper: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}x"
          f"{cfg.head_dim} layers={cfg.n_enc_layers}+{cfg.n_layers} params="
          f"{count_params(params)} batch={B} frames={WHISPER_FRAMES} "
          f"dec_tokens={WHISPER_DEC}", flush=True)

    held = {}
    real, sdpa_held = _held_sdpa(torch, held, "whisper")
    launches = {}
    flash_ops.sdpa = sdpa_held
    try:
        with torch.inference_mode():
            common.reset_launches()
            enc = encdec.encode(params, frames, cfg)
            launches["encode"] = common.launch_counts()["flash_attention"]
            full, _ = encdec.decode_train(params, enc, dec, cfg)
            launches["decode_train"] = common.launch_counts()[
                "flash_attention"] - launches["encode"]
            caches = model_zoo.init_caches(cfg, B, LM_NEW, params=params,
                                           enc_out=enc)
            worst = 0.0
            for t in range(LM_NEW):
                lg, caches = model_zoo.decode_step(cfg, params,
                                                   dec[:, t:t + 1], caches, t)
                torch.testing.assert_close(
                    lg[:, 0].float(), full[:, t].float(), **BF16_MODEL_TOL,
                    msg=lambda m: f"whisper decode step {t}: {m}")
                worst = max(worst, (lg[:, 0].float()
                                    - full[:, t].float()).abs().max().item())
            counts, entries = common.launch_counts(), common.entry_counts()
    finally:
        flash_ops.sdpa = real
    launches["steps"] = counts["flash_attention"] - launches["encode"] \
        - launches["decode_train"]
    want = {"encode": cfg.n_enc_layers, "decode_train": 2 * cfg.n_layers,
            "steps": LM_NEW * cfg.n_layers}
    hd = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    want_held = {hd + (WHISPER_FRAMES, WHISPER_FRAMES, False):
                 cfg.n_enc_layers,
                 hd + (WHISPER_DEC, WHISPER_DEC, True): cfg.n_layers,
                 hd + (WHISPER_DEC, WHISPER_FRAMES, False): cfg.n_layers,
                 hd + (1, WHISPER_FRAMES, False): LM_NEW * cfg.n_layers}
    print(f"whisper: K7 launches {launches} predicted {want}; by entry "
          f"flash_attention_wgmma_bf16={entries['flash_attention_wgmma_bf16']}"
          f" flash_attention_fma_bf16={entries['flash_attention_fma_bf16']}; "
          f"held against the plain version (heads, kv heads, d, T, S, "
          f"causal): launches, max err {held}")
    print(f"whisper decode: {LM_NEW} steps against decode_train's logits, "
          f"max |diff| {worst!r} (atol {BF16_MODEL_TOL['atol']}, rtol "
          f"{BF16_MODEL_TOL['rtol']})", flush=True)
    if launches != want or {k: n for k, (n, _) in held.items()} != want_held \
            or entries["flash_attention_wgmma_bf16"] != sum(want.values()) \
            or entries["flash_attention_fma_bf16"]:
        raise AssertionError(f"whisper: K7 launches {launches} {held} "
                             f"{entries}, predicted {want} {want_held} on "
                             f"flash_attention_wgmma_bf16")

    # the same work unchecked, timed
    with torch.inference_mode():
        for label, fn in (("encode", lambda: encdec.encode(params, frames,
                                                           cfg)),
                          ("decode_train", lambda: encdec.decode_train(
                              params, enc, dec, cfg))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            print(f"whisper {label}: ms={(time.perf_counter() - t0) * 1e3!r}")
        caches = model_zoo.init_caches(cfg, B, LM_NEW, params=params,
                                       enc_out=enc)
        step_s = []
        for t in range(LM_NEW):
            t0 = time.perf_counter()
            model_zoo.decode_step(cfg, params, dec[:, t:t + 1], caches, t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        print(f"whisper decode step: median_ms="
              f"{statistics.median(step_s) * 1e3!r} tokens_per_s="
              f"{B / statistics.median(step_s)!r}", flush=True)
        profile_window(torch, "whisper decode profiled",
                       lambda: model_zoo.decode_step(
                           cfg, params, dec[:, :1], caches, LM_NEW - 1))

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    H, d = cfg.n_heads, cfg.head_dim
    rows = []
    for label, T in (("whisper encoder", WHISPER_FRAMES),
                     ("whisper cross-attention", WHISPER_DEC),
                     ("whisper decode cross-attention", 1)):
        q = torch.randn((B * H, T, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B * H, WHISPER_FRAMES, d), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        rows.append(_k7_row(torch, flush, label, q, k, v, False))
        # this shape's launches in the counted whisper pass
        rows[-1].update(path="whisper", launches_at_shape=held[
            hd + (T, WHISPER_FRAMES, False)][0])
    del params, flush, enc, full, caches
    gc.collect()
    return counts, rows


# ---------------------------------------------------------------------------
# recurrent-families phase: xLSTM (xlstm-350m) and mamba + attention + MoE
# (jamba-1.5-large)
# ---------------------------------------------------------------------------
FAM_XLSTM, FAM_JAMBA = "xlstm-350m", "jamba-1.5-large-398b"
# jamba cut to its 8-layer group's first five layers (mamba, mamba +
# MoE, mamba, mamba + MoE, attention + the dense MLP): a whole group
# holds four MoE layers of 16 x 3 x 8192 x 24576, past 80 GB in bf16
JAMBA_LAYERS = 5
# xlstm-350m cut to one of its three 8-layer groups (7 mLSTM, 1 sLSTM)
# to keep the whole run under its time limit once the mesh tools' phase
# joined it; launch/serve.py --full below still serves all 24 layers
XLSTM_LAYERS = 8


def _decode_gap(torch, label, cfg, params, prompt, toks, pad_to=1):
    """16 teacher-forced decode steps (``greedy_logits``: the prefill,
    then each step on ``generate``'s tokens) against the full forward's
    logits at the same positions: the max |diff| a step, printed, not
    held.  At these widths the reference misses its bf16 model
    tolerance (atol 0.25) itself: an ulp of bf16 rounding in a few
    percent of each random layer's outputs grows through the stack
    (``ROADMAP.md`` queue 3); jamba's forward also drops what overflows
    an expert's capacity over T tokens, where a one-token step drops
    nothing.  ``_mlstm_cells``, ``_mamba_cells`` and ``_small_decode``
    hold what the reference holds.  The forward's sequence is padded
    past the steps' tokens to a multiple of ``pad_to`` (xLSTM's
    chunkwise form takes only multiples of its chunk); the forward is
    causal, so the padding leaves the compared positions alone."""
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import greedy_logits

    P, n = prompt.shape[1], toks.shape[1] - 1
    with torch.inference_mode():
        rows = list(greedy_logits(cfg, params, prompt, n))
        seq = torch.cat([prompt, toks[:, :n].to(prompt.dtype)], dim=1)
        T = -(-seq.shape[1] // pad_to) * pad_to
        seq = torch.cat([seq, prompt[:, :T - seq.shape[1]]], dim=1)
        full, _ = model_zoo.forward(cfg, params, {"tokens": seq})
        gaps = [(lg - full[:, P - 1 + t].float()).abs().max().item()
                for t, lg in enumerate(rows)]
        if not torch.equal(torch.stack([r.argmax(-1) for r in rows], 1)
                           .to(torch.int32), toks):
            raise AssertionError(f"{label}: greedy_logits' argmax is not "
                                 f"generate's tokens")
    print(f"{label} decode vs forward: the prefill's last position and "
          f"{n} teacher-forced steps against forward over T={T}, max "
          f"|diff| a step {[round(g, 4) for g in gaps]} (max {max(gaps)!r};"
          f" not held at this width: see _decode_gap)", flush=True)
    return max(gaps)


def _hold(torch, label, pairs, tol):
    """Each (got, want) of ``pairs`` within ``tol``; prints the max."""
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{label}: {m}")
        worst = max(worst, (got - want).abs().max().item())
    print(f"{label}: f32 on the card, {len(pairs)} pieces held at atol "
          f"{tol['atol']} rtol {tol['rtol']}: max |diff| {worst!r}",
          flush=True)


def _mlstm_cells(torch, dev):
    """The chunkwise mLSTM form against the recurrent one on the card at
    xlstm-350m's heads (4 x 512), B = 4, in f32, at the reference's
    tolerance (``tests/test_models.py``: 2e-5 abs, 2e-4 rel): the
    chunkwise form over the 1024-token prompt (chunk 256), then 16
    recurrent steps from its state, against the chunkwise form over all
    positions."""
    from repro_torch.models import layers, xlstm

    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    B, nh, dh, P, n, chunk = LM_BATCH, 4, 512, LM_PROMPT, LM_NEW, 256
    T = -(-(P + n) // chunk) * chunk
    q, k, v = (randn(B, T, nh, dh) for _ in range(3))
    li = randn(B, T, nh, scale=2.0)
    lf = layers.log_sigmoid(randn(B, T, nh, scale=2.0))
    with torch.inference_mode():
        h_all, _ = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk)
        h_pre, st = xlstm.mlstm_chunkwise(q[:, :P], k[:, :P], v[:, :P],
                                          li[:, :P], lf[:, :P], chunk)
        h_dec, _ = xlstm.mlstm_recurrent(
            q[:, P:P + n], k[:, P:P + n], v[:, P:P + n], li[:, P:P + n],
            lf[:, P:P + n], st)
    _hold(torch, "xlstm mlstm cells", [(h_pre, h_all[:, :P]),
                                       (h_dec, h_all[:, P:P + n])],
          dict(atol=2e-5, rtol=2e-4))


def _mamba_cells(torch, dev, mix, cfg):
    """jamba's mamba layer ``mix`` in f32 on the card, at the
    reference's tolerance (``test_mamba_decode_matches_full_fp32``: 1e-5
    abs, 1e-4 rel): a 16-token prefix with its cache, then 8 decode
    steps, against the full 24-token sequence."""
    from repro_torch.models import ssm

    gen = torch.Generator(device=dev).manual_seed(9)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in mix.items()}
    x = torch.randn((1, 24, cfg.d_model), generator=gen, device=dev)
    pairs = []
    with torch.inference_mode():
        y_all, _ = ssm.mamba(p32, x, cfg)
        _, cache = ssm.mamba(p32, x[:, :16], cfg, make_cache=True)
        for t in range(16, 24):
            y_t, cache = ssm.mamba_decode(p32, x[:, t:t + 1], cfg, cache)
            pairs.append((y_t[:, 0], y_all[:, t]))
    _hold(torch, "jamba mamba cells", pairs, dict(atol=1e-5, rtol=1e-4))


def _small_decode(torch, dev):
    """The reference's own xLSTM decode-consistency test at its config
    (``tests/test_models.py::test_decode_xlstm``: 4 layers, d_model 64,
    chunk 4), on the card: prefill(P) + step decode against the full
    forward, at atol 0.25 / rtol 0.1."""
    from repro_torch.configs.base import (ArchConfig, ParallelConfig,
                                          XLSTMConfig)
    from repro_torch.models import model_zoo

    cfg = ArchConfig(name="t", family="ssm", n_layers=4, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
                     head_dim=16, block_pattern="xlstm",
                     xlstm=XLSTMConfig(slstm_every=2, chunk_size=4),
                     parallel=ParallelConfig(remat="none"))
    T, P = 8, 4
    params = model_zoo.init(cfg, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, T), generator=gen,
                           device=dev)
    with torch.inference_mode():
        full, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
        pre, caches = model_zoo.prefill(cfg, params,
                                        {"tokens": tokens[:, :P]},
                                        cache_len=T)
        torch.testing.assert_close(pre.float(), full[:, :P].float(),
                                   **BF16_MODEL_TOL)
        errs = []
        for t in range(P, T):
            lg, caches = model_zoo.decode_step(cfg, params,
                                               tokens[:, t:t + 1], caches, t)
            errs.append((lg[:, 0].float() - full[:, t].float()).abs()
                        .max().item())
    if max(errs) >= BF16_MODEL_TOL["atol"]:
        raise AssertionError(f"xlstm small decode consistency: {errs}")
    print(f"xlstm small decode consistency (the reference's test config, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}): {T - P} steps "
          f"against forward, max |diff| {max(errs)!r} (< "
          f"{BF16_MODEL_TOL['atol']})", flush=True)


def xlstm_phase(torch, np):
    """(d) xlstm-350m at full width, one 8-layer group deep (7 mLSTM
    and 1 sLSTM layers, ``XLSTM_LAYERS``): greedy ``generate`` at 4 x 1024 + 16 (prefill and step
    times, peak memory, a profiled step's GPU idle share), its decode
    steps' gap to the forward's logits (printed), the chunkwise and
    recurrent mLSTM forms against each other in f32 at its head shapes
    (the reference's cell tolerance) and the reference's own xLSTM
    decode-consistency test on the card; then the continuous engine (a burst of 8 batch-1
    requests into 4 slots, each request's tokens bitwise a solo
    ``generate``, the 4-slot step's logits bitwise four B = 1 steps');
    then ``launch/serve.py --arch xlstm-350m --full --stream
    --continuous``.  xLSTM runs no kernel of the port (the reference
    computes it in plain ``jnp``); returns the generate call's launch
    counts, all zero."""
    import contextlib
    import io

    from repro_torch.configs import registry
    from repro_torch.core.hybrid_executor import detect_platform
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.models.param import count_params, param_bytes
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.serve_step import (generate, make_prefill_step,
                                              make_serve_step)
    from repro_torch.workloads import requests as adapters

    dev = torch.device("cuda", 0)
    cfg = registry.get(FAM_XLSTM).replace(n_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"xlstm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"mlstm d_inner={int(cfg.xlstm.proj_factor * cfg.d_model)} "
          f"chunk={cfg.xlstm.chunk_size} slstm_every="
          f"{cfg.xlstm.slstm_every} layers={cfg.n_layers} vocab="
          f"{cfg.vocab_size} params={count_params(params)} weights_bytes="
          f"{param_bytes(params)} init_s={time.perf_counter() - t0!r}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)

    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"xlstm generate: batch={LM_BATCH} prompt={LM_PROMPT} new={LM_NEW}"
          f" wall_s={wall!r} peak_bytes={peak} launches={counts}",
          flush=True)
    if any(counts.values()) or toks.shape != (LM_BATCH, LM_NEW + 1) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"xlstm generate: launches {counts}, tokens "
                             f"{toks}")
    L = LM_PROMPT + LM_NEW
    with torch.inference_mode():
        prefill = make_prefill_step(cfg, cache_len=L)
        step = make_serve_step(cfg)
        t0 = time.perf_counter()
        tok, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = tok.to(torch.int32)
        step_s = []
        for t in range(LM_NEW):
            t0 = time.perf_counter()
            tok, caches = step(params, tok, caches, LM_PROMPT + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        profile_window(torch, "xlstm decode profiled",
                       lambda: step(params, tok, caches, L - 1))
        # the engine's step: the same 4 rows at a (4,) position tensor,
        # the recurrent products row by row
        pos = torch.full((LM_BATCH,), L - 1, dtype=torch.long, device=dev)
        profile_window(torch, "xlstm slot step profiled (live=4)",
                       lambda: model_zoo.decode_step(cfg, params, tok,
                                                     caches, pos))
        del caches
    print(f"xlstm prefill: ms={prefill_s * 1e3!r} tokens_per_s="
          f"{LM_BATCH * LM_PROMPT / prefill_s!r} (the sLSTM time loop: "
          f"{cfg.n_layers // cfg.xlstm.slstm_every} x {LM_PROMPT} steps)")
    print(f"xlstm decode: median_step_ms={statistics.median(step_s) * 1e3!r}"
          f" min_step_ms={min(step_s) * 1e3!r} tokens_per_s="
          f"{LM_BATCH / statistics.median(step_s)!r}", flush=True)
    _decode_gap(torch, "xlstm", cfg, params, prompt, toks,
                pad_to=cfg.xlstm.chunk_size)
    _mlstm_cells(torch, dev)
    _small_decode(torch, dev)

    # the continuous engine on the accel group
    wl = adapters.make_continuous_lm_adapter(
        cfg, params, prompt_len=LM_PROMPT, new_tokens=LM_NEW,
        n_slots=CB_SLOTS, warm_background=False,
        name="serve-lm-cb/chip-xlstm")
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    sched = Scheduler(groups=[detect_platform()[0][0]], max_batch=CB_BURST,
                      batch_window_s=0.002)
    rec = _instrument(torch, common, stepper,
                      lambda: next(iter(sched._engines.values()), None))
    sched.submit(wl, {"batch": 1, "seed": 100}).result(timeout=600)
    rec["prefill"].clear()
    rec["step"].clear()
    torch.cuda.reset_peak_memory_stats()
    st0 = sched.stats.snapshot()
    t0 = time.perf_counter()
    burst = _burst(sched, wl, [{"batch": 1, "seed": s}
                               for s in range(CB_BURST)])
    wall = time.perf_counter() - t0
    st1 = sched.stats.snapshot()
    sched.shutdown()
    peak = torch.cuda.max_memory_allocated()
    d = {k: st1[k] - st0[k] for k in ("engine_steps", "engine_joins",
                                      "engine_evictions")}
    lat = [x for _, _, x in burst]
    ttft = [f.meta["t_first_token"] - t for f, t, _ in burst]
    print(f"xlstm continuous burst: {CB_BURST} requests of batch 1 x "
          f"{LM_PROMPT} + {LM_NEW} into {CB_SLOTS} slots: {d} "
          f"{_lat_line(np, lat)} ttft_ms p50={float(np.median(ttft)) * 1e3!r}"
          f" wall_s={wall!r} tokens_per_s={CB_BURST * (LM_NEW + 1) / wall!r}"
          f" peak_bytes={peak}", flush=True)
    if not 0 < d["engine_steps"] < CB_BURST * LM_NEW \
            or d["engine_joins"] != CB_BURST:
        raise AssertionError(f"xlstm continuous: {d}: the rows did not "
                             f"stack")
    by_live = {}
    for n_live, s_, _ in rec["step"]:
        by_live.setdefault(n_live, []).append(s_)
    print("xlstm continuous step: " + " ".join(
        f"live={n} median_ms={statistics.median(v) * 1e3!r} (n={len(v)})"
        for n, v in sorted(by_live.items())) + f"; a B=1 prefill median_ms="
        f"{statistics.median(s_ for s_, _ in rec['prefill']) * 1e3!r}",
        flush=True)
    for s_, (f, _, _) in enumerate(burst):
        p = adapters.make_request(wl, {"batch": 1, "seed": s_}) \
            .arrays[0].on(dev)[0]
        solo = generate(cfg, params, p, LM_NEW,
                        cache_len=stepper.cache_len).cpu()
        if not torch.equal(f.result(), solo):
            raise AssertionError(f"xlstm continuous: request {s_} is not "
                                 f"its solo generate's tokens")
    prompts = [adapters.make_request(wl, {"batch": 1, "seed": s_})
               .arrays[0].on(dev)[0] for s_ in range(CB_SLOTS)]
    worst, flips, n_cmp = _slot_vs_solo(torch, cfg, params, stepper,
                                        prompts, LM_NEW)
    print(f"xlstm continuous: {CB_SLOTS}-slot step vs B=1 steps "
          f"(teacher-forced, {n_cmp} row-steps): max |logits diff| "
          f"{worst!r}, argmax disagreements {flips}; all {CB_BURST} "
          f"requests' tokens equal a solo generate at B=1", flush=True)
    if worst != 0.0 or flips:
        raise AssertionError("xlstm continuous: the slot-batched step is "
                             "not bitwise the B=1 step")
    adapters.unregister(wl)
    del stepper, burst

    # the reference's documented recipe, at full width
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(["--arch", FAM_XLSTM, "--full", "--stream",
                          "--continuous", "--rate", "4", "--duration", "1",
                          "--new-tokens", "4"])
    text = buf.getvalue()
    print("\n".join(f"xlstm cli: {ln}" for ln in text.splitlines()))
    engine_lines = [ln for ln in text.splitlines()
                    if ln.startswith("engine ") and " prefill=" in ln]
    if out["rejected"] or not out["tokens"] or len(engine_lines) != 1 \
            or out["stats"].in_flight:
        raise AssertionError("xlstm cli: no engine line, a rejected "
                             "request or requests left in flight")
    print(f"xlstm cli: launch/serve.py --arch {FAM_XLSTM} --full --stream "
          f"--continuous --rate 4 --duration 1 --new-tokens 4: "
          f"{len(out['tokens'])} requests served in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    adapters.unregister(out["workload"])
    del params, out
    gc.collect()
    return counts


def jamba_phase(torch, dev):
    """(e) jamba-1.5-large at full width, cut to one group's first five
    layers: greedy ``generate`` at 4 x 1024 + 16, every K7 launch (the
    attention layer's prefill: 64/8 heads, d = 128, causal) held against
    its plain version, K7 and K8 on their tensor-core entries, K8's
    launches per prefill and per step; the tokens against the plain
    path under the margin rule; the decode steps' gap to the forward's
    logits (printed), its mamba layer's full and decode forms against
    each other in f32 (the reference's tolerance); K7's row at the
    prefill shape beside SDPA and K8's at C =
    640 and C = 4 on the model's expert weights beside ``torch.bmm``.
    Returns (the generate call's launch counts, the rows)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import blocks, model_zoo
    from repro_torch.models.param import count_params, param_bytes
    from repro_torch.serve.plain_check import (MARGIN, check_tokens,
                                               greedy_with_gaps,
                                               plain_kernels)
    from repro_torch.serve.serve_step import (generate, make_prefill_step,
                                              make_serve_step)

    cfg = registry.get(FAM_JAMBA).replace(n_layers=JAMBA_LAYERS,
                                          attn_every=JAMBA_LAYERS)
    kinds, moe_flags, n_groups = blocks.group_layout(cfg)
    n_attn, n_moe = kinds.count("attn") * n_groups, sum(moe_flags) * n_groups
    m = cfg.moe
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    g = params["stack"]["groups"][0]
    parts = {"experts": sum(count_params({k: g[f"l{i}"]["ffn"][k]
                                          for k in ("w_up", "w_gate",
                                                    "w_down")})
                            for i, f in enumerate(moe_flags) if f),
             "dense_mlps": sum(count_params(g[f"l{i}"]["ffn"])
                               for i, f in enumerate(moe_flags) if not f),
             "mamba": sum(count_params(g[f"l{i}"]["mix"])
                          for i, k in enumerate(kinds) if k == "mamba"),
             "attention": sum(count_params(g[f"l{i}"]["mix"])
                              for i, k in enumerate(kinds) if k == "attn"),
             "embed_unembed": count_params(params["embed"])
             + count_params(params["unembed"])}
    print(f"jamba: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads}x{cfg.head_dim} experts={m.n_routed} "
          f"top{m.top_k} d_ff={m.d_ff}/{cfg.d_ff} mamba d_inner="
          f"{cfg.ssm.expand * cfg.d_model} d_state={cfg.ssm.d_state} "
          f"layers={cfg.n_layers} {kinds} moe={moe_flags} (of 72: one "
          f"group's first {JAMBA_LAYERS}) params={count_params(params)} "
          f"{parts} weights_bytes={param_bytes(params)} init_s="
          f"{time.perf_counter() - t0!r}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)

    held = {}
    real, held_sdpa = _held_sdpa(torch, held, "jamba")
    torch.cuda.reset_peak_memory_stats()
    flash_ops.sdpa = held_sdpa
    try:
        common.reset_launches()
        t0 = time.perf_counter()
        toks = generate(cfg, params, prompt, LM_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, entries = common.launch_counts(), common.entry_counts()
    finally:
        flash_ops.sdpa = real
    peak = torch.cuda.max_memory_allocated()
    passes = 1 + m.overflow_passes
    want = {"flash_attention": n_attn,
            "gmm": 3 * passes * n_moe * (1 + LM_NEW)}
    want_held = {(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LM_PROMPT,
                  LM_PROMPT, True): n_attn}
    print(f"jamba generate: batch={LM_BATCH} prompt={LM_PROMPT} "
          f"new={LM_NEW} wall_s={wall!r} peak_bytes={peak} launches="
          f"{counts} predicted={want}; by entry " + ", ".join(
              f"{e}={entries[e]}" for pair in LM_ENTRY.values()
              for e in pair) + f"; K7 held against its plain version "
          f"(heads, kv heads, d, T, S, causal): launches, max err {held}",
          flush=True)
    for name, n in want.items():
        tensor_core, cuda_core = LM_ENTRY[name]
        if counts[name] != n or entries[tensor_core] != n \
                or entries[cuda_core]:
            raise AssertionError(f"jamba generate: {name} launched "
                                 f"{counts[name]} times ({entries}), "
                                 f"predicted {n} on {tensor_core}")
    if {k: n for k, (n, _) in held.items()} != want_held:
        raise AssertionError(f"jamba generate: K7 at {held}, predicted "
                             f"{want_held}")
    if toks.shape != (LM_BATCH, LM_NEW + 1) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"jamba generate: bad tokens {toks}")

    L = LM_PROMPT + LM_NEW
    with torch.inference_mode():
        prefill = make_prefill_step(cfg, cache_len=L)
        step = make_serve_step(cfg)
        common.reset_launches()
        t0 = time.perf_counter()
        tok, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per = {"prefill": common.launch_counts()}
        tok = tok.to(torch.int32)
        step_s = []
        for t in range(LM_NEW):
            common.reset_launches()
            t0 = time.perf_counter()
            tok, caches = step(params, tok, caches, LM_PROMPT + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per["decode step"] = common.launch_counts()
        profile_window(torch, "jamba decode profiled",
                       lambda: step(params, tok, caches, L - 1))
        del caches
        profile_window(torch, "jamba prefill profiled",
                       lambda: prefill(params, {"tokens": prompt}), top=12)
    decode_s = statistics.median(step_s)
    print(f"jamba prefill: ms={prefill_s * 1e3!r} tokens_per_s="
          f"{LM_BATCH * LM_PROMPT / prefill_s!r} launches={per['prefill']}")
    print(f"jamba decode: median_step_ms={decode_s * 1e3!r} min_step_ms="
          f"{min(step_s) * 1e3!r} tokens_per_s={LM_BATCH / decode_s!r} "
          f"launches_per_step={per['decode step']}", flush=True)
    if per["prefill"]["gmm"] <= 0 or per["decode step"]["gmm"] <= 0 \
            or per["prefill"]["flash_attention"] != n_attn:
        raise AssertionError(f"jamba: K7/K8 per prefill / step {per}")

    common.reset_launches()
    with plain_kernels():
        plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, LM_NEW)
    if common.launch_counts()["gmm"] or \
            common.launch_counts()["flash_attention"]:
        raise AssertionError("jamba plain path launched K7 or K8")
    try:
        differed = check_tokens(toks, plain, gaps)
    except AssertionError as e:
        raise AssertionError(f"jamba check: {e}") from None
    for b, t, gap in differed:
        print(f"jamba: row {b} differs first at token {t}, plain "
              f"top-1/top-2 gap {gap!r}")
    print(f"jamba check: {LM_BATCH - len(differed)} of {LM_BATCH} rows "
          f"equal to the plain path's tokens; the others pass the margin "
          f"rule (gap < {MARGIN}); min gap {gaps.min().item()!r}",
          flush=True)
    _decode_gap(torch, "jamba", cfg, params, prompt, toks)
    _mamba_cells(torch, dev, g["l0"]["mix"], cfg)
    print(f"jamba: peak_bytes over the phase "
          f"{torch.cuda.max_memory_allocated()}", flush=True)

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    B, H, Kv, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = [_k7_row(torch, flush, "jamba prefill", randn(B * H, LM_PROMPT, d),
                    randn(B * Kv, LM_PROMPT, d), randn(B * Kv, LM_PROMPT, d),
                    True)]
    w_up = g[f"l{moe_flags.index(True)}"]["ffn"]["w_up"]
    C = max(1, int(LM_PROMPT * m.top_k / m.n_routed * m.capacity_factor))
    for label, c in (("jamba prefill up", LM_BATCH * C),
                     ("jamba decode up", LM_BATCH)):
        rows.append(_k8_row(torch, flush, label,
                            randn(m.n_routed, c, cfg.d_model), w_up))
    for r in rows:
        r.update(path="jamba generate",
                 launches_per_prefill=per["prefill"][r["name"]],
                 launches_per_decode_step=per["decode step"][r["name"]])
    del params, flush, g, w_up
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rows


# the fleet (router + transport): the serve phase's Table-1
# stream at its sizes and rate through 2 workers behind the router
FLEET_WORKERS = 2
FLEET_INPROC_S, FLEET_PROC_S = 6.0, 8.0
# the proc fleet's chaos: SIGSTOP, then SIGKILL the worker that owns the
# most of the mix's keys at this share of the trace (the kill waits for
# a request on it), restart it at the second
FLEET_KILL_AT, FLEET_RESTART_AT = 0.4, 0.7
# the reference's fleet gate (serving_bench.run_fleet): goodput through
# the death at least this share of a no-fault run's; the no-fault fleet
# (a) serves every request of the stream, so it is a share of the sent
FLEET_GOODPUT_FLOOR = 0.6
# the cold-join check's mix: one workload (two_process_check's payload),
# so that worker A's probes cover both lanes of every key it persists
FLEET_COLD_MIX = [("conv", {"size": 128, "ksize": 5})]


def _check_value(torch, label, wl, payload, value, refs):
    """A fleet result against the serve phase's reference value.  Results
    cross the transport on the host: a CPU tensor (sort's, host-native, a
    numpy array), never a CUDA one."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        raise AssertionError(f"{label} {wl}: result on {value.device}")
    value = _as_cpu(torch, value)
    ref, tol = refs[(wl, payload["density"]) if wl == "spmv" else wl]
    if tol == 0:
        if not torch.equal(value, ref):
            raise AssertionError(f"{label} {wl}: value differs")
    else:
        torch.testing.assert_close(value, ref, rtol=tol, atol=tol,
                                   msg=lambda m: f"{label} {wl}: {m}")


def _fleet_stream(np, router, seconds, on_done):
    """The serve phase's open-loop Poisson stream of ``SERVE_MIX`` (6
    req/s, seed 0) through ``router`` for ``seconds``; returns
    [(workload, payload, t_submit, future)] and the completion stamps."""
    rng = np.random.default_rng(0)
    futs, done_at = [], {}
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        wl, payload = SERVE_MIX[int(rng.integers(len(SERVE_MIX)))]
        f = router.submit(wl, dict(payload))
        f.add_done_callback(on_done)
        f.add_done_callback(
            lambda f_: done_at.__setitem__(id(f_), time.perf_counter()))
        futs.append((wl, payload, time.perf_counter(), f))
        time.sleep(float(rng.exponential(1.0 / SERVE_RATE)))
    return futs, done_at


def _fleet_latency(np, futs, done_at):
    lat = [done_at[id(f)] - t for _, _, t, f in futs if id(f) in done_at]
    return tuple(float(v) * 1e3 for v in np.percentile(lat, [50, 95, 99]))


def fleet_inproc_phase(torch, np):
    """(a) Two ``InProcWorker``s, each a ``Scheduler()`` on the real pair
    (accel cuda:0, host the CPU) sharing this process's calibration
    store (warm from the serve phase, as a fleet's shared store is),
    behind the ``Router``: every payload once on each worker, one at a
    time, then the serve phase's stream for ``FLEET_INPROC_S`` under
    ``torch.profiler``; every result against the serve phase's
    references.  Returns the launch counts by kernel and by C entry of
    the run (counts set to 0 just before the workers are made, read
    after the drain)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks.serving_bench import _broadcast_warm
    from repro_torch.kernels import common
    from repro_torch.serve.router import Router
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.transport import InProcWorker

    refs = _serve_checks(torch, np)
    resolved = {}

    def on_done(f):
        resolved[id(f)] = resolved.get(id(f), 0) + 1

    made = []

    def make_scheduler():
        made.append(Scheduler(max_batch=SERVE_BURST_N, batch_window_s=0.005,
                              explore_every=8))
        return made[-1]

    common.reset_launches()
    workers = [InProcWorker(f"iw{i}", sched_factory=make_scheduler,
                            hb_interval_s=0.2)
               for i in range(FLEET_WORKERS)]
    router = Router(workers).start()
    try:
        groups = {g.name: str(g.devices[0]) for g in made[0].groups}
        if groups != {"accel": "cuda:0", "host": "cpu"}:
            raise AssertionError(f"fleet inproc: expected accel=cuda:0 "
                                 f"host=cpu, got {groups}")
        t0 = time.perf_counter()
        _broadcast_warm(router, SERVE_MIX, timeout_s=600.0)
        t_warm = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_start = time.perf_counter()
            futs, done_at = _fleet_stream(np, router, FLEET_INPROC_S,
                                          on_done)
            if not router.drain(timeout=600):
                raise AssertionError("fleet inproc: drain() timed out")
            wall = time.perf_counter() - t_start
        gpu_busy = _union_s([(e.time_range.start, e.time_range.end)
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and not getattr(e, "is_user_annotation",
                                             False)])
        counts, entries = common.launch_counts(), common.entry_counts()
        per_worker = {n: s.get("completed", 0) for n, s in
                      router.refresh_stats(timeout=10.0).items()}
        st = router.stats
        if st.in_flight != 0 or st.completed != st.submitted:
            raise AssertionError(f"fleet inproc: submitted={st.submitted} "
                                 f"completed={st.completed} failed="
                                 f"{st.failed} in_flight={st.in_flight}")
        if any(resolved.get(id(f), 0) != 1 for _, _, _, f in futs):
            raise AssertionError("fleet inproc: a future did not resolve "
                                 "exactly once")
        for wl, payload, _, f in futs:
            _check_value(torch, "fleet inproc", wl, payload,
                         f.result(timeout=0), refs)
    finally:
        router.shutdown(timeout=120)
    p50, p95, p99 = _fleet_latency(np, futs, done_at)
    print(f"fleet inproc: workers={FLEET_WORKERS} (InProcWorker, "
          f"Scheduler() on accel=cuda:0 host=cpu) warm_s={t_warm!r} "
          f"stream {len(futs)} requests in {FLEET_INPROC_S} s at "
          f"{SERVE_RATE}/s wall_s={wall!r} throughput="
          f"{len(futs) / wall!r} req/s latency_ms p50={p50!r} p95={p95!r} "
          f"p99={p99!r} requests_per_worker={per_worker} (warm included) "
          f"gpu_busy_s={gpu_busy!r} gpu_idle_share={1.0 - gpu_busy / wall!r}"
          f" (torch.profiler over the stream) resubmits={st.resubmits} "
          f"spills={st.spills}", flush=True)
    print("fleet inproc: launches by entry: " + ", ".join(
        f"{e}={entries[e]}" for e in SERVE_ENTRY.values()))
    print(f"fleet inproc: every value ok (the serve phase's tolerances), "
          f"each on the host; every future resolved once", flush=True)
    return counts, entries


class _KillWhenBusy:
    """The scripted faults of a ``ChaosInjector``, each kill9 held back
    from its scripted time until its worker holds an unresolved request,
    so that the death has work to fail over, and each restart until the
    router has found its worker dead (the faults after a held one wait
    behind it); the router applies them from its monitor tick like the
    injector itself."""

    def __init__(self, inj, router):
        self._inj, self._router = inj, router
        self._held = []
        self._t0 = None
        # (kind, seconds after arm()) of each fault applied
        self.fired = []
        # each killed worker's last heartbeat stats (its launch counts)
        self.last_stats = {}

    def arm(self) -> None:
        self._t0 = time.perf_counter()
        self._inj.arm()

    def at_time_proc(self):
        self._held += self._inj.at_time_proc()
        out = []
        while self._held:
            f = self._held[0]
            if f.kind == "kill9":
                if self._router.pending_on(f.worker) == 0:
                    break
                self.last_stats[f.worker] = \
                    self._router.worker_stats()[f.worker]
            if f.kind == "restart" and \
                    self._router.worker_states()[f.worker] != "dead":
                break
            out.append(self._held.pop(0))
            self.fired.append((f.kind, time.perf_counter() - self._t0))
        return out


def _gpu_apps(label):
    """The compute processes on the card as nvidia-smi lists them
    ([(pid, used_memory)]), and the card's memory.used in MiB."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=30).stdout
    print(f"fleet proc: {label}: nvidia-smi compute apps {out!r}, "
          f"memory.used {used.strip()} MiB")
    apps = [tuple(x.strip() for x in line.split(","))
            for line in out.splitlines() if line.strip()]
    return apps, float(used.strip().splitlines()[0])


def fleet_proc_phase(torch, np):
    """(b) Two ``ProcWorker`` children on cuda:0 behind the ``Router``,
    sharing one calibration store: each child's CUDA memory, every
    payload once on each, one at a time, then the stream for
    ``FLEET_PROC_S`` with a scripted ``ChaosInjector``: SIGSTOP then
    SIGKILL of the worker
    that owns the most of the mix's keys at ``FLEET_KILL_AT`` of the
    trace (the kill held until a request waits on the stopped worker:
    a death with nothing in flight fails nothing over) and its restart
    at ``FLEET_RESTART_AT``.  Every future resolves exactly once, none
    is dropped, the death is detected and its requests are resubmitted,
    ``FLEET_GOODPUT_FLOOR`` of the stream is served, every completed
    value equals the reference; then the cold-join
    check (a worker joining on a warm shared store probes nothing).
    Returns the children's launch counts by kernel and by C entry, from
    their heartbeats (the killed child's last one before its death)."""
    import tempfile
    from collections import Counter

    from repro_torch.benchmarks import serving_bench as sb
    from repro_torch.ft.failure import ChaosInjector, ProcFault
    from repro_torch.serve.request_queue import RequestRejected
    from repro_torch.serve.router import Router, default_bucket
    from repro_torch.serve.transport import ProcWorker

    refs = _serve_checks(torch, np)
    root = os.path.join(SRC, "repro_torch", "build", "fleet")
    os.makedirs(root, exist_ok=True)
    store = tempfile.mkdtemp(prefix="store-", dir=root)
    resolved = {}

    def on_done(f):
        resolved[id(f)] = resolved.get(id(f), 0) + 1

    workers = [ProcWorker(f"fw{i}", env=sb._fleet_env(store),
                          hb_interval_s=0.2)
               for i in range(FLEET_WORKERS)]
    apps0, used0 = _gpu_apps("before the children")
    t0 = time.perf_counter()
    router = Router(workers).start()
    try:
        t_start = time.perf_counter() - t0
        if router.worker_states() != {w.name: "alive" for w in workers}:
            raise AssertionError(f"fleet proc: workers did not start: "
                                 f"{router.worker_states()}")
        # warm: every payload once on each child (inputs made and kept
        # per device, the kernel library loaded): process state, not the
        # stream's cost
        t0 = time.perf_counter()
        sb._broadcast_warm(router, SERVE_MIX, timeout_s=600.0)
        t_warm = time.perf_counter() - t0
        # each child's CUDA memory: nvidia-smi lists one compute process
        # more per child (in this container it cannot name their pids),
        # and each child reports its own allocator's reservation
        apps1, used1 = _gpu_apps("children started and warm")
        reserved = {n: s.get("cuda_memory_reserved", 0.0) for n, s in
                    router.refresh_stats(timeout=10.0).items()}
        print(f"fleet proc: child pids "
              f"{ {w.name: w.pid for w in workers} }, parent pid "
              f"{os.getpid()}; compute processes on the card "
              f"{len(apps0)} -> {len(apps1)}, memory.used {used0!r} -> "
              f"{used1!r} MiB (+{used1 - used0!r}); each child's reserved "
              f"CUDA memory (MiB) " + ", ".join(
                  f"{n}={v / 2**20!r}" for n, v in sorted(reserved.items())),
              flush=True)
        if len(apps0) < 1 or len(apps1) != len(apps0) + FLEET_WORKERS \
                or any(v <= 0 for v in reserved.values()):
            raise AssertionError(f"fleet proc: the children do not each "
                                 f"hold memory on cuda:0 beside the "
                                 f"parent ({len(apps0)} -> {len(apps1)} "
                                 f"processes, reserved {reserved})")
        owners = Counter(router.owner(f"{wl}|{default_bucket(p)}")
                         for wl, p in SERVE_MIX)
        victim = owners.most_common(1)[0][0]
        chaos = _KillWhenBusy(ChaosInjector([
            ProcFault(t=FLEET_KILL_AT * FLEET_PROC_S, worker=victim,
                      kind="stall"),
            ProcFault(t=FLEET_KILL_AT * FLEET_PROC_S, worker=victim,
                      kind="kill9"),
            ProcFault(t=FLEET_RESTART_AT * FLEET_PROC_S, worker=victim,
                      kind="restart")]), router)
        results_before = router.results_by_worker()
        chaos.arm()
        router.chaos = chaos
        t_trace = time.perf_counter()
        futs, done_at = _fleet_stream(np, router, FLEET_PROC_S, on_done)
        if not router.drain(timeout=600):
            raise AssertionError("fleet proc: drain() timed out")
        wall = time.perf_counter() - t_trace
        # the restarted child needs seconds (imports, a CUDA context) to
        # beat again: wait past the trace's end for its rejoin
        deadline = time.monotonic() + 120.0
        while router.stats.worker_rejoins < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        fired = dict(chaos.fired)
        results_by = {n: k - results_before.get(n, 0)
                      for n, k in router.results_by_worker().items()}
        t_rejoin = (time.perf_counter() - t_trace
                    - fired.get("restart", float("nan")))
        st = router.stats
        # the children's launches, from their heartbeats: the survivors'
        # and the restarted child's now, the killed child's last report
        reports = list(router.refresh_stats(timeout=10.0).values()) + \
            list(chaos.last_stats.values())
        hung = [f for _, _, _, f in futs if not f.done()]
        once = all(resolved.get(id(f), 0) == 1 for _, _, _, f in futs)
        served = rejected = 0
        for wl, payload, _, f in futs:
            try:
                value = f.result(timeout=0)
            except RequestRejected:
                rejected += 1
                continue
            served += 1
            _check_value(torch, "fleet proc", wl, payload, value, refs)
    finally:
        router.shutdown(timeout=120)
        # the children are gone: their shared store goes with them
        shutil.rmtree(store, ignore_errors=True)
    p50, p95, p99 = _fleet_latency(np, futs, done_at)
    print(f"fleet proc: workers={FLEET_WORKERS} (ProcWorker children on "
          f"cuda:0) start_s={t_start!r} warm_s={t_warm!r} stream "
          f"{len(futs)} requests in {FLEET_PROC_S} s at {SERVE_RATE}/s, "
          f"stall then kill9 {victim} (owner of {owners[victim]} of "
          f"{len(SERVE_MIX)} mix keys; scripted at "
          f"{FLEET_KILL_AT * FLEET_PROC_S} s, stalled at "
          f"{fired.get('stall')!r} s, killed at {fired.get('kill9')!r} s "
          f"with a request on it), restart at "
          f"{fired.get('restart')!r} s; wall_s={wall!r} served="
          f"{served} rejected={rejected} latency_ms p50={p50!r} p95={p95!r}"
          f" p99={p99!r} deaths={st.worker_deaths} resubmits="
          f"{st.resubmits} duplicates={st.duplicate_results} rejoins="
          f"{st.worker_rejoins} rejoin_after_restart_s={t_rejoin!r} "
          f"dropped_without_rejection={st.in_flight} results_returned="
          f"{dict(sorted(results_by.items()))}", flush=True)
    if hung or not once:
        raise AssertionError(f"fleet proc: {len(hung)} hung, exactly once "
                             f"{once}")
    if st.in_flight != 0:
        raise AssertionError(f"fleet proc: {st.in_flight} dropped without "
                             f"a rejection")
    if st.worker_deaths < 1 or st.resubmits < 1 or st.worker_rejoins < 1:
        raise AssertionError(f"fleet proc: deaths={st.worker_deaths} "
                             f"resubmits={st.resubmits} rejoins="
                             f"{st.worker_rejoins}")
    if served < FLEET_GOODPUT_FLOOR * len(futs):
        raise AssertionError(f"fleet proc: served {served} of {len(futs)} "
                             f"({rejected} rejected), under the "
                             f"{FLEET_GOODPUT_FLOOR} goodput floor")
    t0 = time.perf_counter()
    probes_a, probes_b = sb.fleet_cold_join_check(
        FLEET_COLD_MIX, verbose=False, root=root)
    print(f"fleet proc: cold join ({FLEET_COLD_MIX}) worker A "
          f"probe_runs={probes_a} cold worker B probe_runs={probes_b} in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    if probes_b != 0:
        raise AssertionError(f"fleet proc: the cold worker paid {probes_b} "
                             f"probe run(s)")
    counts = {k: int(sum(r.get(f"launches.{k}", 0) for r in reports))
              for k in SOURCE}
    entries = {e: int(sum(r.get(f"entry_launches.{e}", 0)
                          for r in reports)) for e in SERVE_ENTRY.values()}
    print("fleet proc: the children's launches by entry (heartbeats; the "
          "killed child's last one): " + ", ".join(
              f"{e}={n}" for e, n in entries.items()), flush=True)
    return counts, entries


def fleet_phase(torch, np):
    """(a) and (b); returns the launch counts of both: this process's
    workers' and the children's, from their heartbeats.  K1-K4, K6 and
    K7 (f32) must each launch, on their entries (K4 in a cold worker's
    calibration: the children's)."""
    t0 = time.perf_counter()
    counts, entries = fleet_inproc_phase(torch, np)
    child_counts, child_entries = fleet_proc_phase(torch, np)
    for k, n in child_counts.items():
        counts[k] += n
    for e, n in child_entries.items():
        entries[e] += n
    print("fleet: launches by entry (in-process workers + children): "
          + ", ".join(f"{e}={entries[e]}" for e in SERVE_ENTRY.values()))
    for name, entry in SERVE_ENTRY.items():
        if counts[name] <= 0 or entries[entry] != counts[name]:
            raise AssertionError(
                f"fleet: {name} launched {counts[name]} times, "
                f"{entries[entry]} through {entry}")
    print(f"fleet: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def scenarios_phase(torch, np):
    """The port's ``run_scenarios``: its six specs (copies of the
    reference's), each through a fresh ``Scheduler()`` on the real
    pair, after one warm run of every payload on each device; per spec
    p95 and goodput by SLO class, the counters and the trace digest,
    and the runner's checks: the accounting invariant, the chaos
    scenario's lane death, no closed-loop client left waiting.
    Returns the launch counts of the run."""
    from repro_torch.benchmarks.scenarios import run_scenarios as drv
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    common.reset_launches()
    ok, results = drv.run(print_rows=False)
    counts = common.launch_counts()
    for r in results:
        c = r["counters"]
        print(f"scenarios {r['scenario']}: mode={r['mode']} events="
              f"{r['n_events']} wall_s={r['wall_s']!r} submitted="
              f"{c['submitted']} completed={c['completed']} failed="
              f"{c['failed']} shed_deadline={c['shed_deadline']} "
              f"shed_brownout={c['shed_brownout']} rejected_full="
              f"{c['rejected_full']} lane_deaths={c.get('lane_deaths', 0)}"
              f" retries={c.get('retries', 0)} dropped_without_rejection="
              f"{r['dropped_without_rejection']} trace_digest={r['digest']}")
        for cls, cm in sorted(r["classes"].items()):
            print(f"scenarios {r['scenario']} {cls}: completed="
                  f"{cm['completed']} rejected={cm['rejected']} failed="
                  f"{cm['failed']} p50_ms={cm['p50_s'] * 1e3!r} p95_ms="
                  f"{cm['p95_s'] * 1e3!r} goodput_rps="
                  f"{cm['goodput_rps']!r}")
        if r["mode"] == "closed":
            answered = sum(cm["completed"] + cm["rejected"] + cm["failed"]
                           for cm in r["classes"].values())
            if answered != r["n_events"] or c["submitted"] != r["n_events"]:
                raise AssertionError(f"scenarios {r['scenario']}: "
                                     f"{answered} of {r['n_events']} "
                                     f"closed-loop requests answered")
    if not ok or len(results) != 6:
        raise AssertionError(f"scenarios: runner checks failed ({len(results)}"
                             f" scenarios; see above)")
    print(f"scenarios: launches={counts}")
    print(f"scenarios: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# training: the work-shared trainer, the optimizer, the checkpointer
# ---------------------------------------------------------------------------
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_SEQ, TRAIN_MB, TRAIN_ACCUM, TRAIN_STEPS = 1024, 2, 4, 4
# lm-100m (examples/train_lm.py's full_cfg): seq, micro-batch, accum
LM100_SEQ, LM100_MB, LM100_ACCUM = 512, 4, 8
LM100_GEN_BATCH, LM100_GEN_PROMPT, LM100_GEN_NEW = 4, 64, 16
# the CPU parity tests' tolerances (tests/torch_train_parity.py)
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, TRAIN_GRAD_COS, TRAIN_NOISE = (
    0.01, 0.1, 0.99, 1e-4)
TRAIN_ROUTER_TIE = 0.01


def _train_steps(label, history, tokens_per_step):
    """Print each step's record; every loss and grad norm finite."""
    for r in history:
        print(f"{label} step {r.step}: loss={r.loss!r} grad_norm="
              f"{r.grad_norm!r} units={r.units} executed={r.executed_units}"
              f" replanned={r.replanned} steals={r.steals} wall_s="
              f"{r.wall_s!r} tokens_per_s={tokens_per_step / r.wall_s!r}",
              flush=True)
        if not (math.isfinite(r.loss) and math.isfinite(r.grad_norm)):
            raise AssertionError(f"{label} step {r.step}: loss {r.loss} "
                                 f"grad norm {r.grad_norm}")


def _train_h2o(torch):
    """(a) h2o-danube-1.8b at full width and depth through
    ``launch/train.py``: four steps with the host group killed at step 1
    and revived at step 2, then one more step profiled.  K7 and K8 must
    not launch: a differentiated layer takes the reference's
    differentiable formulations (and h2o's sliding window keeps its
    attention on the grouped einsum anyway)."""
    import dataclasses

    from repro_torch.kernels import common
    from repro_torch.launch import train as train_launch
    from repro_torch.models.param import count_params

    args = ["--arch", TRAIN_ARCH, "--full", "--seq", str(TRAIN_SEQ),
            "--micro-batch", str(TRAIN_MB), "--accum", str(TRAIN_ACCUM),
            "--steps", str(TRAIN_STEPS), "--inject-failure"]
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    trainer, out = train_launch.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    h = out["history"]
    tokens = TRAIN_ACCUM * TRAIN_MB * TRAIN_SEQ
    cfg = trainer.cfg
    print(f"train h2o: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} vocab="
          f"{cfg.vocab_size} window={cfg.sliding_window} remat="
          f"{cfg.parallel.remat} params={count_params(out['params'])} "
          f"(f32) seq={TRAIN_SEQ} micro_batch={TRAIN_MB} accum="
          f"{TRAIN_ACCUM} tokens_per_step={tokens} wall_s={wall!r} "
          f"peak_bytes={peak} launches={counts}", flush=True)
    _train_steps("train h2o", h, tokens)
    kill, revive = TRAIN_STEPS // 3, 2 * TRAIN_STEPS // 3
    if h[kill].units != [TRAIN_ACCUM, 0] or h[revive].units[1] <= 0 \
            or not (h[kill].replanned and h[revive].replanned):
        raise AssertionError(f"train h2o: kill at {kill} / revive at "
                             f"{revive}: units {[r.units for r in h]}")
    print(f"train h2o: the host group killed at step {kill} (units "
          f"{h[kill].units}) and rejoined at step {revive} (units "
          f"{h[revive].units})")
    if counts["flash_attention"] or counts["gmm"]:
        raise AssertionError(f"train h2o: K7/K8 launched in training "
                             f"{counts}")
    print("train h2o: K7 and K8 launched 0 times in training: under "
          "autograd a layer takes the reference's differentiable "
          "formulation (the grouped-einsum attention, the einsum grouped "
          "matmul); K7 and K8, like the reference's kernels, have no "
          "backward")
    steps = [r.wall_s for r in h[1:]]
    med = statistics.median(steps)
    print(f"train h2o: median_step_s={med!r} (steps 1-{TRAIN_STEPS - 1}) "
          f"tokens_per_s={tokens / med!r} peak_gb={peak / 1e9!r}")
    # one more step, profiled
    trainer.tcfg = dataclasses.replace(trainer.tcfg,
                                       steps=TRAIN_STEPS + 1)
    state = {"params": out["params"], "opt": out["opt"]}
    profile_idle(torch, "train h2o step profiled",
                 lambda: trainer.run(state, start_step=TRAIN_STEPS,
                                     warmup=False))
    del trainer, out, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _lm100(steps, ckpt=None, kind="synthetic", opt=None):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.examples.train_lm import full_cfg
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = full_cfg()
    return Trainer(
        cfg, opt or OptConfig(lr=3e-4, warmup_steps=10, total_steps=100),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=LM100_SEQ,
                   micro_batch=LM100_MB, kind=kind),
        TrainerConfig(accum_units=LM100_ACCUM, steps=steps,
                      ckpt_dir=ckpt, ckpt_every=3,
                      time_model=lambda g, k: k * (
                          0.001 if g == "accel" else 0.004)))


def _train_lm100(torch, dev, flush):
    """(b) lm-100m: nine steps with a checkpoint every three; a fresh
    trainer on that directory resumes at step 9 and runs to 12, against
    the first trainer trained on, uninterrupted, to 12; twelve steps on
    zipf data at the reference test's optimizer; ``generate`` on the
    trained f32 weights, launching K7.  Returns (the generate call's
    launch counts, K7's row at its prefill shape)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.kernels import common
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.serve.serve_step import generate

    tokens = LM100_ACCUM * LM100_MB * LM100_SEQ
    build = os.path.join(SRC, "repro_torch", "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train-ckpt-", dir=build)
    try:
        t0 = time.perf_counter()
        first = _lm100(9, ckpt=tmp)
        out = first.run()
        # a fresh trainer on the same directory resumes at step 9 ...
        resumed = _lm100(12, ckpt=tmp).run()["history"]
        # ... and the first one, uninterrupted (its own state and
        # tracker, nothing read back), trains on to step 12
        first.ckpt = None
        first.tcfg = dataclasses.replace(first.tcfg, steps=12)
        whole = first.run({"params": out["params"], "opt": out["opt"]},
                          start_step=9, warmup=False)["history"]
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del out, first
    _train_steps("train lm-100m", whole, tokens)
    if [r.step for r in resumed] != [9, 10, 11]:
        raise AssertionError(f"train lm-100m: the restart ran steps "
                             f"{[r.step for r in resumed]}, not 9-11")
    rel = [abs(a.loss - b.loss) / abs(b.loss)
           for a, b in zip(resumed, whole[9:])]
    bitwise = all(a.loss == b.loss for a, b in zip(resumed, whole[9:]))
    print(f"train lm-100m restart: 9 steps with a checkpoint every 3, a "
          f"fresh trainer resumed at step {resumed[0].step}; losses "
          f"{[r.loss for r in resumed]} vs the uninterrupted run's "
          f"{[r.loss for r in whole[9:]]}: max_rel_diff={max(rel)!r} "
          f"bitwise={bitwise} units resumed={[r.units for r in resumed]} "
          f"uninterrupted={[r.units for r in whole[9:]]} wall_s={wall!r}",
          flush=True)
    if max(rel) > 1e-5:
        raise AssertionError(f"train lm-100m restart: losses differ by "
                             f"{max(rel)} relative")

    t0 = time.perf_counter()
    tr = _lm100(12, kind="zipf",
                opt=OptConfig(lr=3e-3, warmup_steps=2, total_steps=100))
    out = tr.run()
    zipf_wall = time.perf_counter() - t0
    losses = [r.loss for r in out["history"]]
    print(f"train lm-100m zipf: losses={losses} drop={losses[0] - losses[-1]!r}"
          f" wall_s={zipf_wall!r}", flush=True)
    if not losses[-1] < losses[0] - 0.3:
        raise AssertionError(f"train lm-100m zipf: loss {losses[0]} -> "
                             f"{losses[-1]}, not down by 0.3")

    cfg = tr.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size,
                           (LM100_GEN_BATCH, LM100_GEN_PROMPT),
                           generator=gen, device=dev)
    common.reset_launches()
    t0 = time.perf_counter()
    toks = generate(cfg, out["params"], prompt, LM100_GEN_NEW)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts, entries = common.launch_counts(), common.entry_counts()
    print(f"train lm-100m generate: f32 trained weights, batch="
          f"{LM100_GEN_BATCH} prompt={LM100_GEN_PROMPT} new="
          f"{LM100_GEN_NEW} wall_s={gen_wall!r} launches={counts} "
          f"flash_attention_wgmma_bf16="
          f"{entries['flash_attention_wgmma_bf16']}", flush=True)
    if counts["flash_attention"] <= 0 or entries[
            "flash_attention_wgmma_bf16"] != counts["flash_attention"]:
        raise AssertionError(f"train lm-100m generate: K7 launches "
                             f"{counts} {entries}")
    if toks.shape != (LM100_GEN_BATCH, LM100_GEN_NEW + 1) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"train lm-100m generate: bad tokens {toks}")
    # K7 at the generate call's prefill shape
    B, T, H, Kv, d = (LM100_GEN_BATCH, LM100_GEN_PROMPT, cfg.n_heads,
                      cfg.n_kv_heads, cfg.head_dim_())
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((B * h_, T, d), generator=g, device=dev)
               .to(torch.bfloat16) for h_ in (H, Kv, Kv))
    row = _k7_row(torch, flush, "lm-100m prefill", q, k, v, True)
    row["path"] = "train lm-100m generate"
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts, row


def _pin_top_k(torch, moe, record=None, forced=None):
    """Replace the MoE's top-k: record its choices, or take ``forced``'s
    (call by call) and record its own.  Returns (restore, own choices,
    probabilities)."""
    orig, own, probs_seen = moe._top_k, [], []

    def top_k(probs, k):
        vals, idx = orig(probs, k)
        own.append(idx.cpu())
        probs_seen.append(probs.detach().float().cpu())
        if forced is None:
            return vals, idx
        idx = forced[len(own) - 1].to(probs.device)
        return torch.gather(probs, -1, idx), idx

    moe._top_k = top_k

    def restore():
        moe._top_k = orig
    return restore, own, probs_seen


def _train_route(torch, np, dev):
    """(c) the route and the gradients on the card at kimi-k2 and h2o
    ``reduced()``: ``loss_fn``'s value and gradients on cuda:0 against
    the CPU's from the same f32 weights (the card's MoE layers on the
    CPU's experts, its own choices differing only at near-ties), at the
    CPU parity tests' tolerances; a ``no_grad`` forward launching K7 and
    K8 (kimi); both wrappers raising on inputs that require grad.
    Returns the no_grad forwards' launch counts."""
    from repro_torch.configs import registry
    from repro_torch.core.tree import flatten_with_path, leaves, unflatten
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.gmm.gmm import gmm_cuda
    from repro_torch.models import model_zoo, moe
    from repro_torch.train.train_step import to_batch, value_and_grad

    total_counts = {}
    for arch in ("kimi-k2-1t-a32b", TRAIN_ARCH):
        cfg = registry.get(arch).reduced()
        cpu = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
        gpu = unflatten(cpu, [p.to(dev) for p in leaves(cpu)])
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 64),
                                                 dtype=np.int32)
        b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        restore, ref_idx, probs = _pin_top_k(torch, moe)
        try:
            loss_c, _, g_c = value_and_grad(cpu, to_batch(b, "cpu"), cfg)
        finally:
            restore()
        restore, own, _ = _pin_top_k(torch, moe, forced=ref_idx)
        try:
            common.reset_launches()
            loss_g, _, g_g = value_and_grad(gpu, to_batch(b, dev), cfg)
            torch.cuda.synchronize()
            grad_counts = common.launch_counts()
        finally:
            restore()
        flips = 0
        for r, o, p in zip(ref_idx, own, probs):
            k = r.shape[-1]
            for at in np.argwhere((np.sort(r.numpy(), -1)
                                   != np.sort(o.numpy(), -1)).any(-1)):
                srt = np.sort(p[tuple(at)].numpy())[::-1]
                if srt[k - 1] - srt[k] >= TRAIN_ROUTER_TIE:
                    raise AssertionError(f"train route {arch}: the card "
                                         f"chose other experts at {at}, "
                                         f"probabilities {srt[:k + 1]}")
                flips += 1
        d_loss = abs(float(loss_g) - float(loss_c))
        total = float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                     for x in leaves(g_c))))
        worst_rel, worst_cos, noise = 0.0, 1.0, 0
        for (path, a), c in zip(flatten_with_path(g_g), leaves(g_c)):
            a, c = a.double().cpu().flatten(), c.double().flatten()
            nc, err = float(c.norm()), float((a - c).norm())
            if nc < TRAIN_NOISE * total:
                noise += 1
                if err > TRAIN_NOISE * total:
                    raise AssertionError(f"train route {arch}: {path} "
                                         f"err {err}")
                continue
            cos = float(a @ c) / max(float(a.norm()) * nc, 1e-30)
            worst_rel, worst_cos = max(worst_rel, err / nc), min(worst_cos,
                                                                 cos)
        print(f"train route {arch}: loss cuda={float(loss_g)!r} cpu="
              f"{float(loss_c)!r} |diff|={d_loss!r} grads: worst leaf "
              f"rel_l2={worst_rel!r} min cos={worst_cos!r} ({noise} "
              f"noise-size leaves held absolutely) near-tie route flips="
              f"{flips} launches under grad={grad_counts}", flush=True)
        if d_loss > TRAIN_LOSS_ATOL or worst_rel > TRAIN_GRAD_REL \
                or worst_cos < TRAIN_GRAD_COS:
            raise AssertionError(f"train route {arch}: outside the CPU "
                                 f"parity tolerances")
        if grad_counts["flash_attention"] or grad_counts["gmm"]:
            raise AssertionError(f"train route {arch}: K7/K8 under grad "
                                 f"{grad_counts}")
        common.reset_launches()
        with torch.no_grad():
            logits, _ = model_zoo.forward(cfg, gpu, to_batch(b, dev))
        torch.cuda.synchronize()
        counts = common.launch_counts()
        for name, n in counts.items():
            total_counts[name] = total_counts.get(name, 0) + n
        want_k8 = cfg.moe is not None
        # h2o's sliding window keeps its attention on the grouped einsum
        want_k7 = not cfg.sliding_window
        print(f"train route {arch}: no_grad forward launches={counts}",
              flush=True)
        if (counts["gmm"] > 0) != want_k8 or \
                (counts["flash_attention"] > 0) != want_k7 or \
                not torch.isfinite(logits.float()).all():
            raise AssertionError(f"train route {arch}: no_grad forward "
                                 f"launches {counts}")
    q = torch.randn((4, 64, 64), device=dev, dtype=torch.bfloat16)
    x = torch.randn((2, 64, 64), device=dev, dtype=torch.bfloat16)
    w = torch.randn((2, 64, 64), device=dev, dtype=torch.bfloat16)
    for label, call in (
            ("flash_attention_cuda", lambda: flash_attention_cuda(
                q.requires_grad_(), q, q)),
            ("gmm_cuda", lambda: gmm_cuda(x, w.requires_grad_()))):
        try:
            call()
        except NotImplementedError as e:
            print(f"train route: {label} on inputs that require grad "
                  f"raises: {e}")
        else:
            raise AssertionError(f"train route: {label} ran on inputs "
                                 f"that require grad")
    return total_counts


def train_phase(torch, np, dev):
    """The training slice on the card: (a) h2o-danube-1.8b at full width
    and depth, (b) lm-100m's checkpoint, restart, zipf and train ->
    serve, (c) the route and the gradients at ``reduced()``.  Returns
    (the phase's launch counts, K7's row at lm-100m's prefill shape)."""
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    counts = dict(_train_h2o(torch))
    t1 = time.perf_counter()
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    gen_counts, row = _train_lm100(torch, dev, flush)
    del flush
    t2 = time.perf_counter()
    route_counts = _train_route(torch, np, dev)
    print(f"train: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s")
    for c in (gen_counts, route_counts):
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
    common.reset_launches()
    print(f"train: launches={counts}")
    print(f"train: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts, [row]


# ---------------------------------------------------------------------------
# the mesh tools: the dry-run, the probe, the hill-climb, the roofline
# ---------------------------------------------------------------------------
# (label, module, arguments): each a child process of its own
MESH_TOOL_RUNS = (
    ("dryrun whisper-tiny decode_32k", "repro_torch.launch.dryrun",
     ["--arch", "whisper-tiny", "--shape", "decode_32k"]),
    ("dryrun h2o-danube-1.8b train_4k", "repro_torch.launch.dryrun",
     ["--arch", "h2o-danube-1.8b", "--shape", "train_4k"]),
    ("hillclimb deepseek-v2-lite-16b train_4k baseline",
     "repro_torch.launch.hillclimb",
     ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k"]),
    ("hillclimb deepseek-v2-lite-16b train_4k smap",
     "repro_torch.launch.hillclimb",
     ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k", "--set",
      "moe.shard_mode=smap"]),
)
MESH_TOOLS_MAX_S = 60.0
MESH_TOOLS_CHILD_TIMEOUT_S = 300


def mesh_tools_phase(torch):
    """The dry-run and the hill-climb's probe on the fake 16x16 mesh, in
    child processes started together: whisper-tiny's decode_32k and
    h2o-danube-1.8b's train_4k at full depth, deepseek-v2-lite-16b's
    train_4k as the baseline and with the shard_map MoE.  Each child's
    record and wall time; each reports CUDA uninitialised at its end,
    and this process's allocated bytes and kernel launches do not move.
    Then the roofline rows of those cells on the H100 SXM's data-sheet
    constants.  Returns the phase's launch counts (all 0)."""
    from repro_torch.benchmarks import roofline
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.cost_model import h100_sxm_profile
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    common.reset_launches()
    allocated = torch.cuda.memory_allocated()
    out_dir = os.path.join(SRC, "repro_torch", "build", "mesh_tools")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = []
    try:
        for i, (label, module, args) in enumerate(MESH_TOOL_RUNS):
            out = os.path.join(out_dir, f"{i}.jsonl")
            log = open(os.path.join(out_dir, f"{i}.log"), "w")
            procs.append((label, out, log, time.perf_counter(),
                          subprocess.Popen(
                              [sys.executable, "-m", module, *args, "--out",
                               out], stdout=log, stderr=subprocess.STDOUT,
                              env=env, cwd=ROOT)))
        records = {}
        for label, out, log, start, proc in procs:
            rc = proc.wait(timeout=MESH_TOOLS_CHILD_TIMEOUT_S)
            wall = time.perf_counter() - start
            log.close()
            with open(log.name) as f:
                text = f.read()
            with open(out) as f:
                rec = json.loads(f.readlines()[-1])
            shown = {k: v for k, v in rec.items() if k != "traceback"}
            print(f"mesh tools {label}: wall_s={wall!r} rc={rc} "
                  f"record={json.dumps(shown)}")
            if rc != 0 or rec["status"] != "OK":
                raise AssertionError(f"mesh tools {label}: rc={rc} "
                                     f"status={rec['status']}: "
                                     f"{rec.get('traceback', text[-2000:])}")
            if "cuda initialized: False" not in text:
                raise AssertionError(f"mesh tools {label}: the child did "
                                     f"not report CUDA uninitialised")
            records[label] = rec
    finally:
        for _, _, log, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    smap = records["hillclimb deepseek-v2-lite-16b train_4k smap"]
    if not smap["coll_by_op"].get("all-to-all", 0) > 0:
        raise AssertionError(f"mesh tools: the smap MoE's probe counts no "
                             f"all-to-all: {smap['coll_by_op']}")
    counts = common.launch_counts()
    if any(counts.values()) or torch.cuda.memory_allocated() != allocated:
        raise AssertionError(f"mesh tools: the card was used: launches "
                             f"{counts}, allocated {allocated} -> "
                             f"{torch.cuda.memory_allocated()}")
    print(f"mesh tools: children report CUDA uninitialised; this "
          f"process's allocated bytes {allocated} unchanged, launches "
          f"{counts}")
    # the roofline of each cell: the probe's totals, and a full-depth
    # dry-run's numbers, which equal them
    p = h100_sxm_profile()
    print(f"mesh tools roofline: constants (data sheet, not measured) "
          f"peak={p.matmul_flops!r} FLOP/s hbm={p.mem_bw!r} B/s "
          f"link={p.link_bw!r} B/s chips={roofline.CHIPS} on {card_line()}")
    for label, rec in records.items():
        if "flops_total" not in rec:
            rec = dict(rec, flops_total=rec["flops"],
                       coll_total=rec["collective_total"],
                       coll_by_op=rec["collective_bytes"])
        cell = next(c for c in SHAPES if c.name == rec["shape"])
        row = roofline.roofline_row(
            rec["arch"], cell, {(rec["arch"], rec["shape"], "16x16"): rec})
        print(f"mesh tools roofline {label}: {json.dumps(row)}")
    wall = time.perf_counter() - t0
    print(f"mesh tools: phase {wall:.1f} s", flush=True)
    if wall > MESH_TOOLS_MAX_S:
        raise AssertionError(f"mesh tools: phase {wall:.1f} s > "
                             f"{MESH_TOOLS_MAX_S} s")
    return counts


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
    # every phase but the autotune phase runs the routes' defaults
    os.environ["REPRO_AUTOTUNE"] = "0"
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
    del flush
    # the serving scheduler: the Table-1 stream on the real pair, the
    # LM stream on the accel group (the LM phase's weights) and
    # launch/serve.py --hybrid
    t0 = time.perf_counter()
    per_call["serve stream"] = serve_stream_phase(torch, np)
    per_call["serve lm"] = serve_lm_phase(torch, lm_cfg, lm_params)
    per_call["serve hybrid"] = serve_hybrid_phase(torch)
    print(f"serve: phase {time.perf_counter() - t0:.1f} s")
    # the continuous-batching engine, the LM phase's weights still on
    # the card
    per_call["serve continuous"] = serve_continuous_phase(
        torch, np, lm_cfg, lm_params)
    # tp = 16 (the repeated K/V heads) and the model layers' pins and
    # tune-cache hits, the LM phase's weights still on the card
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    per_call["lm tuned"], tuned_row = lm_tuned_phase(torch, dev, lm_cfg,
                                                     lm_params, flush)
    rows.append(tuned_row)
    del lm_params, flush
    gc.collect()            # the weights' last holders may sit in cycles
    # the model families: MLA (deepseek on K8, minicpm3 through the
    # engine) and the encoder-decoder (whisper on K7's full route)
    t0 = time.perf_counter()
    per_call["deepseek generate"], per_call["deepseek mesh"], fam_rows = \
        deepseek_phase(torch, dev)
    per_call["minicpm3 continuous"] = minicpm_phase(torch, np)
    per_call["whisper"], whisper_rows = whisper_phase(torch, dev)
    rows += fam_rows + whisper_rows
    print(f"families: phase {time.perf_counter() - t0:.1f} s", flush=True)
    # the recurrent families: xLSTM through the engine, jamba's mamba,
    # attention (K7 at d = 128) and MoE (K8 at its expert width)
    t0 = time.perf_counter()
    per_call["xlstm generate"] = xlstm_phase(torch, np)
    per_call["jamba generate"], jamba_rows = jamba_phase(torch, dev)
    rows += jamba_rows
    print(f"recurrent: phase {time.perf_counter() - t0:.1f} s", flush=True)
    # the fleet (router, transport) and the scenario engine, jamba's
    # weights freed: two workers in this process, then two children on
    # the card; then the six replayable scenarios
    per_call["fleet"] = fleet_phase(torch, np)
    per_call["scenarios"] = scenarios_phase(torch, np)
    # training: h2o-danube-1.8b at full width, lm-100m's checkpoints and
    # train -> serve, the route under autograd
    per_call["train"], train_rows = train_phase(torch, np, dev)
    rows += train_rows
    # the mesh tools in child processes, which touch no card: the
    # dry-run, the probe and the hill-climb on the fake 16x16 mesh
    per_call["mesh tools"] = mesh_tools_phase(torch)
    # after the LM, so that the inputs these phases keep on the card
    # (montecarlo's 512 MB stream among them) stay out of its peak
    per_call["table2"] = table2_phase(torch)
    per_call["figures"] = figures_phase(torch)
    table1_phase(torch, np)
    per_call.update(autotune_phase(torch, np, dev))
    for r in rows:
        if r.get("entry") == K7_F32_ENTRY:
            r["launches_per_serve_stream"] = \
                PHASE_ENTRIES["serve stream"][K7_F32_ENTRY]
        if r["name"] in LM_ENTRY and "path" not in r:
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
