"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name (``BENCHMARK.json``,
``bench/configs``, ``bench/traffic``, ``bench/cells``,
``bench/metrics``).  Set-up draws the weights and the prompts from the
seed, builds the program's serving path and warms the cell's shapes;
the window then offers the traffic for ``--seconds`` seconds; after it
the served tokens are checked against the plain reference.  With
``--trace 1`` the program's spans are on and a stretch of the window
runs under ``torch.profiler``, and the per-layer metrics are reported
instead of the end-to-end ones.

Exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), where the program's package is not in
the checkout, where a width differs from the configuration file, and
where JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STATE = ROOT / "bench" / ".state"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment(trace: bool) -> None:
    """The program's settings for a run, whatever the caller's
    environment holds: no autotune search, no calibration or tune cache
    outside the checkout, build and kernel caches at fixed paths inside
    it, the program's spans on only in a traced run."""
    os.environ.update({
        "REPRO_AUTOTUNE": "0",
        "REPRO_CALIB_CACHE": "off",
        "REPRO_TUNE_CACHE": str(STATE / "tune.json"),
        "TORCH_EXTENSIONS_DIR": str(STATE / "torch_extensions"),
        "TRITON_CACHE_DIR": str(STATE / "triton"),
        "USE_FLAX": "0",
        "REPRO_TRACE": "1" if trace else "0",
    })
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))


def _fail(code: int, msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))

    import torch

    from bench.harness import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        _fail(3, f"{args.workload} needs {cell['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count()}")
    try:
        import repro_torch
    except ImportError as exc:
        _fail(2, f"the program's package is not in this checkout: {exc}")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        _fail(2, f"repro_torch loaded from {repro_torch.__file__}, not "
                 f"from this checkout")

    from bench.harness import cellrun

    result, check_lines = cellrun.run(
        bench, cell, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_start=T_START, note=print_note)
    found = _loaded_forbidden()
    if found:
        _fail(5, f"the process loaded {found} (JAX or the JAX package)")
    print(f"bench: card {_power_limit()}", file=sys.stderr)
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def print_note(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
