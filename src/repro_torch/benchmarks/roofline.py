"""Roofline analysis: three terms per (arch x shape) on the single-pod
mesh, from the dry-run's layer-differencing probe and the analytic
model, on the H100 SXM's data-sheet constants
(``core.cost_model.h100_sxm_profile``; none is a measurement).

  compute    = FLOPs / (chips * 989.4e12)   [dense BF16 tensor-core peak]
  memory     = HBM bytes / (chips * 3.35e12)
  collective = collective bytes / (chips * 50e9)   [one NDR port a GPU]

FLOPs: the analytic engineering model (``launch.analytic``),
cross-checked with the probe's traced FLOPs.  Bytes: the analytic HBM
traffic model.  Collectives: the probe's per-device result bytes
(``launch.probe``), times the chips.  The reference's formulas and keys
on its TPU-v5e constants; ``CHIPS`` is the 16x16 mesh's 256.

  python -m repro_torch.benchmarks.roofline
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.cost_model import h100_sxm_profile
from repro_torch.launch import analytic

_H100 = h100_sxm_profile()
PEAK = _H100.matmul_flops
HBM = _H100.mem_bw
LINK = _H100.link_bw
CHIPS = 256


def load_jsonl(path: str) -> Dict:
    """{(arch, shape, mesh): record} of a probe or dry-run JSONL file
    ({} if there is none)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            out[(r["arch"], r["shape"], r.get("mesh", "16x16"))] = r
    return out


def roofline_row(arch_id: str, cell, probe: Dict) -> Optional[Dict]:
    cfg = registry.get(arch_id)
    ok, why = shape_applicable(cfg, cell)
    if not ok:
        return {"arch": arch_id, "shape": cell.name, "status": "SKIP",
                "reason": why}
    flops = analytic.hlo_flops(cfg, cell)
    mflops = analytic.model_flops(cfg, cell)
    hbm_b = analytic.hbm_bytes(cfg, cell)
    pr = probe.get((arch_id, cell.name, "16x16"), {})
    # probe numbers are per device -> multiply by chips
    hlo_flops_probe = pr.get("flops_total", 0) * CHIPS
    coll = pr.get("coll_total", 0) * CHIPS
    t_compute = flops / (CHIPS * PEAK)
    t_memory = hbm_b / (CHIPS * HBM)
    t_coll = coll / (CHIPS * LINK)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = t_compute / bound if bound > 0 else 0.0
    return {
        "arch": arch_id, "shape": cell.name, "status": "OK",
        "flops": flops, "model_flops": mflops,
        "hlo_flops_probe": hlo_flops_probe,
        "hbm_bytes": hbm_b, "coll_bytes": coll,
        "t_compute": t_compute, "t_memory": t_memory,
        "t_collective": t_coll, "dominant": dominant,
        "roofline_time": bound,
        "compute_fraction": frac,
        "model_over_hlo": (mflops / flops if flops else 0.0),
        "coll_by_op": {k: v * CHIPS
                       for k, v in pr.get("coll_by_op", {}).items()},
    }


def run(probe_path: str = "results/probe.jsonl", csv: bool = True,
        device=None):
    """One row per (arch, shape) cell of the registry (40), printed as
    ``roofline/<arch>/<shape>,<us>,<terms>`` CSV rows; a cell with no
    probe record has a collective term of 0.  Nothing is measured:
    ``device`` is taken, as by every section of ``benchmarks.run``, and
    unused."""
    probe = load_jsonl(probe_path)
    rows = []
    for aid in registry.ARCH_IDS:
        for cell in SHAPES:
            r = roofline_row(aid, cell, probe)
            rows.append(r)
            if csv:
                if r["status"] == "SKIP":
                    print(f"roofline/{r['arch']}/{r['shape']},0,SKIP")
                else:
                    print(
                        f"roofline/{r['arch']}/{r['shape']},"
                        f"{r['roofline_time'] * 1e6:.1f},"
                        f"dom={r['dominant']}|"
                        f"comp={r['t_compute'] * 1e3:.3f}ms|"
                        f"mem={r['t_memory'] * 1e3:.3f}ms|"
                        f"coll={r['t_collective'] * 1e3:.3f}ms|"
                        f"frac={100 * r['compute_fraction']:.0f}%|"
                        f"mf/hlo={r['model_over_hlo']:.2f}")
    return rows


if __name__ == "__main__":
    run()
