"""Find a configuration's knee on the card: the cell's configuration
served by closed-loop clients (``docqa-closed``), then open-loop
(``docqa-open``) windows at the given rates, all in one process.  Prints
one ``sweep`` line per window with its result object.

    python3 bench/sweep.py --cell minicpm3.docqa-batch --rates 0.45,0.6,0.75 --closed

Each window's seed is ``--seed`` plus its index; the check samples
``--check-requests`` requests.  A tool for setting the cells' rates,
never run by the benchmark itself.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.run import _environment, print_note  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--closed", action="store_true")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--check-requests", type=int, default=8)
    args = ap.parse_args()
    _environment(False)
    import torch

    from bench.harness import cellrun, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.cell)
    runs = []
    if args.closed:
        runs.append(("closed", spec.traffic("docqa-closed"), {}))
    for r in filter(None, args.rates.split(",")):
        runs.append((f"open@{r}", spec.traffic("docqa-open"),
                     {"rate_rps": float(r)}))
    t_start = T_START
    for i, (label, mix, extra) in enumerate(runs):
        over = cellrun.Overrides(traffic=mix, cell=dict(
            extra, check_requests=args.check_requests))
        res, lines = cellrun.run(
            bench, cell, seed=args.seed + i, seconds=args.seconds,
            trace=False, device=torch.device("cuda", 0), t_start=t_start,
            note=print_note, over=over)
        print(f"sweep {args.cell} {label}: {json.dumps(res)}", flush=True)
        t_start = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
