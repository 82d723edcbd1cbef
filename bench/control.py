"""The correctness check's two readings for a cell on the card, in one
process: the program's widest gap on each of ``--seeds``, and on each
of ``--control-seeds`` also the gap of the tokens the fp8 control (the
float32 reference with every linear layer's operands rounded to fp8
e4m3) puts first.  Each seed runs a window of ``--seconds`` at the
cell's own load and checks the same number of requests a benchmark run
does.  Prints one ``control`` line per seed.

    python3 bench/control.py --cell minicpm3.docqa-batch --seeds 1,2,3 --control-seeds 1,2,3

A tool for setting the cells' ``gap_limit``, never run by the benchmark.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    _environment(False)
    import torch

    from bench.harness import cellrun, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.cell)
    ctl = {int(s) for s in filter(None, args.control_seeds.split(","))}
    t_start = T_START
    for s in (int(x) for x in args.seeds.split(",")):
        res, _ = cellrun.run(bench, cell, seed=s, seconds=args.seconds,
                             trace=False, device=torch.device("cuda", 0),
                             t_start=t_start, note=print_note,
                             control=s in ctl)
        print(f"control {args.cell} seed={s}: program="
              f"{res['check']['widest_gap']['value']!r} control="
              f"{res.get('control_widest_gap')!r} correct={res['correct']} "
              f"attempted={res['attempted']} failed={res['failed']} "
              f"metrics={json.dumps(res['metrics'])}", flush=True)
        t_start = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
