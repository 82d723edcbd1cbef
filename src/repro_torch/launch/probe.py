"""Layer-differencing probe: a cell's whole-model roofline terms from
traces at one and two layer groups.

Every (arch x shape) cell is traced (``launch.dryrun``) at depth = 1
group and 2 groups on the production mesh; the difference is the
per-group contribution and

    total = base + (n_groups - 1) * delta

gives whole-model FLOPs and collective bytes.  The reference probes
because XLA's cost analysis counts a ``lax.scan`` body once; the port
unrolls its layers, so a full-depth trace counts every layer already,
and the probe's totals equal that trace's exactly (every group is the
same work).  The probe stays because two shallow traces are far
cheaper than a deep one.  A trace has no ``bytes accessed``: the
``bytes_*`` keys are absent (``benchmarks.roofline`` takes HBM bytes
from ``launch.analytic``, as the reference's does).

Usage: python -m repro_torch.launch.probe [--arch A] [--shape S] [--out F]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.dryrun import check_accounting, trace_cell
from repro_torch.models import blocks


def probe_depths(cfg):
    """(cfg_1group, cfg_2group, n_groups): the config cut to one and to
    two layer groups (after the dense prefix), and the full depth's
    group count."""
    kinds, _, n_groups = blocks.group_layout(cfg)
    g = len(kinds)
    n_dense = cfg.moe.n_dense_layers if (cfg.moe and
                                         cfg.block_pattern == "attn") else 0
    par = dataclasses.replace(cfg.parallel, scan_layers=False)
    kw1 = dict(n_layers=n_dense + g, parallel=par)
    kw2 = dict(n_layers=n_dense + 2 * g, parallel=par)
    if cfg.is_encoder_decoder:
        kw1.update(n_enc_layers=1, n_layers=1)
        kw2.update(n_enc_layers=2, n_layers=2)
        n_groups = cfg.n_layers
    return cfg.replace(**kw1), cfg.replace(**kw2), n_groups


def measure(cfg, cell, mesh):
    """One trace's per-device FLOPs and collective bytes."""
    r = trace_cell(cfg, cell, mesh)
    coll = r["collective_bytes"]
    return {"flops": r["flops"], "coll": float(sum(coll.values())),
            "coll_by_op": coll}


def probe_cell(arch_id, cell, cfg=None, multi_pod: bool = False):
    """The probe's record of one cell; ``cfg`` (default: the registry's
    config of ``arch_id``) is the config traced."""
    cfg = cfg or registry.get(arch_id)
    ok, why = shape_applicable(cfg, cell)
    rec = {"arch": arch_id, "shape": cell.name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    try:
        check_accounting(mesh)
        c1, c2, n_groups = probe_depths(cfg)
        t0 = time.time()
        m1 = measure(c1, cell, mesh)
        m2 = measure(c2, cell, mesh)
        out = {}
        for k in ("flops", "coll"):
            delta = m2[k] - m1[k]
            out[k + "_total"] = m1[k] + (n_groups - 1) * delta
            out[k + "_per_group"] = delta
            out[k + "_base"] = m1[k] - delta
        coll_ops = {op: (m2["coll_by_op"].get(op, 0)
                         - m1["coll_by_op"].get(op, 0)) * (n_groups - 1)
                    + m1["coll_by_op"].get(op, 0)
                    for op in set(m1["coll_by_op"]) | set(m2["coll_by_op"])}
        rec.update(status="OK", n_groups=n_groups, probe_s=round(
            time.time() - t0, 1), coll_by_op=coll_ops, **out)
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-1500:])
    finally:
        mesh_mod.release()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/probe.jsonl")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else registry.ARCH_IDS
    cells = [c for c in SHAPES if (not args.shape or c.name == args.shape)]
    fh = _open_out(args.out)
    n_fail = 0
    for aid in archs:
        for cell in cells:
            rec = probe_cell(aid, cell)
            n_fail += rec["status"] == "FAIL"
            print(f"[probe] {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['status']}"
                  + (f" flops={rec['flops_total']:.3e} "
                     f"coll={rec['coll_total']:.3e}"
                     if rec["status"] == "OK" else
                     f" ({rec.get('reason', rec.get('error'))[:80]})"),
                  flush=True)
            if fh:
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
    if fh:
        fh.close()
    return 1 if n_fail else 0


def _open_out(path):
    """``path`` opened for appending, its directory made; None for no
    path."""
    import os
    if not path:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "a")


if __name__ == "__main__":
    sys.exit(main())
