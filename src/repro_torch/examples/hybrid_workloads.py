"""Run the paper's 13 workloads hybrid vs single-device (Table 2 style).

    PYTHONPATH=src python -m repro_torch.examples.hybrid_workloads \
        [--only conv] [--no-steal]

Runs on the pair ``detect_platform`` finds and says which: on a GPU
host the real pair (the GPU and the CPU), where ``--ratio`` does not
apply; ``main(argv, device="cpu")`` simulates the pair on the CPU at
``--ratio``, as the reference does on one device.
"""
from __future__ import annotations

import argparse
import importlib

from repro_torch.core.hybrid_executor import HybridExecutor, detect_platform
from repro_torch.core.metrics import summarize
from repro_torch.workloads import ALL_WORKLOADS

QUICK = dict(sort=dict(n=1 << 16), hist=dict(n=1 << 20), spmv=dict(n=2048),
             spgemm=dict(n=512), raycast=dict(n_rays=1 << 15, d=32),
             bilateral=dict(size=192), conv=dict(size=512, ksize=9),
             montecarlo=dict(n_photons=1 << 16, unit=1 << 12),
             listrank=dict(n=1 << 17), concomp=dict(n=1 << 13),
             lbm=dict(d=32, n_steps=3), dither=dict(h=96, w=96),
             bundle=dict(n_cams=4, n_pts=128))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratio", type=float, default=3.9,
                    help="simulated accel:host throughput ratio")
    ap.add_argument("--only", default=None, choices=ALL_WORKLOADS,
                    metavar="WORKLOAD")
    ap.add_argument("--chunks", type=int, default=16,
                    help="chunk-grid granularity per work-shared call")
    ap.add_argument("--no-steal", action="store_true",
                    help="disable work stealing")
    ap.add_argument("--repeat", type=int, default=1,
                    help="repeat each workload (steady-state timing: "
                         "later runs hit the calibration cache)")
    args = ap.parse_args(argv)
    groups, simulated = detect_platform(args.ratio, device)
    pair = " + ".join(f"{g.name}={g.devices[0]}" for g in groups)
    if simulated:
        print(f"pair: simulated on {groups[0].devices[0]} at ratio "
              f"{args.ratio:g} ({pair})", flush=True)
    else:
        print(f"pair: real ({pair}); --ratio does not apply", flush=True)
    results = []
    for name in ALL_WORKLOADS:
        if args.only and name != args.only:
            continue
        mod = importlib.import_module(f"repro_torch.workloads.{name}")
        for _ in range(max(args.repeat, 1)):
            ex = HybridExecutor(groups=detect_platform(args.ratio,
                                                       device)[0],
                                n_chunks=args.chunks,
                                steal=not args.no_steal)
            out = mod.run_hybrid(ex, **QUICK.get(name, {}))
        results.append(out.result)
        print(out.result.row(), flush=True)
    print("\n" + summarize(results))
    return results


if __name__ == "__main__":
    main()
