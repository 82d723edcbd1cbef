"""Benchmark entry point of the port — one section per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--json] [--out DIR]

Prints ``name,us_per_call,derived`` CSV rows:
  table2/*   — Table 2 (13 workloads x 2 platforms, gain/idle/eff,
               measured vs analytic-model makespan)
  fig3/*     — Fig. 3 scaling over input sizes
  fig4/*     — Fig. 4 Conv overlap timeline (measured vs model)
  fig5/*     — Fig. 5 LR task assignment
  split_sweep/* — §5.4.3 work-split sweep, executed splits vs model
  kernels/*  — per-kernel microbenches (``kernels_bench``)
  roofline/* — the 40 (arch x shape) cells' compute / memory /
               collective terms on the H100 SXM's data-sheet constants
               (``roofline``; the collective term reads the probe's
               ``results/probe.jsonl`` where it exists, else 0)

``--json`` additionally writes machine-readable results into ``--out``
(default: the current directory), never the reference's ``BENCH_*``
files:
  BENCH_torch_kernels.json  — kernels/*, roofline/*, cold_start/* rows
  BENCH_torch_hybrid.json   — table2/fig3/fig4/fig5/split_sweep rows
  BENCH_torch_history.jsonl — one timestamped line per kernel,
                              cold-start AND serving row per run, keyed
                              by the backend (``torch:cuda`` /
                              ``torch:cpu``); ``regress.py`` gates on it

The cold_start and serving sections (fresh-process first-call latency;
scheduler-vs-FIFO latency percentiles + the two-process zero-probe
check, ``serving_bench.run(smoke=True)``) only run under ``--json`` —
they spawn subprocesses and are the slowest sections.  Every section
runs on the first GPU and raises without one; ``--device cpu`` (or
``main(argv, device="cpu")``) runs them on the CPU.
"""
import argparse
import datetime
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

from repro_torch.benchmarks import serving_bench

_ROW = re.compile(r"^([A-Za-z0-9_./+-]+/[^,]*),([-\d.]+),(.*)$")

# section name -> (kind, the bench's module under repro_torch.benchmarks)
SECTIONS = {
    "table2": ("hybrid", "table2_hybrid"),
    "fig3": ("hybrid", "fig3_scaling"),
    "fig4": ("hybrid", "fig4_overlap"),
    "fig5": ("hybrid", "fig5_tasks"),
    "split_sweep": ("hybrid", "split_sweep"),
    "kernels": ("kernels", "kernels_bench"),
    "roofline": ("kernels", "roofline"),
}


def _cold_start(device) -> bool:
    from repro_torch.benchmarks import cold_start
    cold_start.run(device=device)
    return True


def _serving(device) -> bool:
    # json_out=False: the smoke trace must not clobber a full
    # measurement stored in BENCH_torch_serving.json; the trajectory
    # still lands in the history file
    ok, _ = serving_bench.run(smoke=True, json_out=False, device=device)
    return ok


# the sections that spawn subprocesses, run only under --json:
# name -> (title, fn(device) -> whether its invariants held)
JSON_SECTIONS = {
    "cold_start": ("cold start (fresh-process first-call latency)",
                   _cold_start),
    "serving": ("serving (scheduler vs FIFO, smoke trace)", _serving),
}


def _capture(fn):
    """Run a section, tee its stdout, return parsed CSV rows."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    text = buf.getvalue()
    sys.stdout.write(text)
    rows = []
    for line in text.splitlines():
        m = _ROW.match(line.strip())
        if m:
            rows.append({"name": m.group(1), "us": float(m.group(2)),
                         "derived": m.group(3)})
    return rows


def main(argv=None, device=None) -> int:
    import importlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true",
                    help="write BENCH_torch_kernels.json / "
                         "BENCH_torch_hybrid.json / "
                         "BENCH_torch_history.jsonl into --out")
    ap.add_argument("--out", default=".",
                    help="directory for the result files")
    ap.add_argument("--device", default=None,
                    help="device (default: the first GPU; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = args.device if args.device is not None else device

    hybrid_rows, kernel_rows = [], []
    for name, (kind, mod_name) in SECTIONS.items():
        mod = importlib.import_module(f"repro_torch.benchmarks.{mod_name}")
        print(f"# === {name} ===")
        rows = _capture(lambda: mod.run(device=device))
        (hybrid_rows if kind == "hybrid" else kernel_rows).extend(rows)
    serving_ok = True
    for title, fn in (JSON_SECTIONS.values() if args.json else ()):
        print(f"# === {title} ===")
        state = {}
        kernel_rows += _capture(lambda: state.update(ok=fn(device)))
        serving_ok = serving_ok and state.get("ok", False)

    if args.json:
        meta = serving_bench.meta(device)
        meta.pop("smoke")
        backend = f"torch:{meta['device'].split(':')[0]}"
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "BENCH_torch_kernels.json"),
                  "w") as f:
            json.dump({"meta": meta, "rows": kernel_rows}, f, indent=1)
        with open(os.path.join(args.out, "BENCH_torch_hybrid.json"),
                  "w") as f:
            json.dump({"meta": meta, "rows": hybrid_rows}, f, indent=1)
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds")
        n_hist = 0
        with open(os.path.join(args.out, "BENCH_torch_history.jsonl"),
                  "a") as f:
            for row in kernel_rows:
                if not row["name"].startswith(("kernels/", "cold_start/",
                                               "serving/")):
                    continue
                f.write(json.dumps({"ts": ts, "backend": backend,
                                    **row}) + "\n")
                n_hist += 1
        print(f"# wrote BENCH_torch_kernels.json ({len(kernel_rows)} rows),"
              f" BENCH_torch_hybrid.json ({len(hybrid_rows)} rows), "
              f"BENCH_torch_history.jsonl (+{n_hist} rows) in {args.out}")
    if not serving_ok:
        # hard serving invariants (dropped-without-rejection, nonzero
        # cold probes) must not pass silently through a bench run
        print("# serving invariants FAILED — see serving section above")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
