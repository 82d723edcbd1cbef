"""Perf-iteration tool (§Perf): measure one (arch x shape) cell's
roofline terms under config overrides, via the layer-differencing probe.

    python -m repro_torch.launch.hillclimb --arch deepseek-v2-lite-16b \
        --shape train_4k --set moe.dispatch=onehot moe.shard_dispatch=1

The overridden config reaches the probe as an argument
(``probe_cell(arch, cell, cfg=...)``); the registry is not patched.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES


def apply_overrides(cfg, sets):
    """``cfg`` with each ``path=value`` of ``sets`` applied: ``path`` a
    field of the config or ``sub.field`` of one of its sub-configs;
    ``value`` an int, a float, ``true`` / ``false`` or a string."""
    for kv in sets:
        path, val = kv.split("=", 1)
        parts = path.split(".")
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if val in ("true", "false"):
            val = val == "true"
        obj_path = parts[:-1]
        leaf = parts[-1]
        if not obj_path:
            cfg = cfg.replace(**{leaf: val})
        else:
            sub = getattr(cfg, obj_path[0])
            sub = dataclasses.replace(sub, **{leaf: val})
            cfg = cfg.replace(**{obj_path[0]: sub})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)

    from repro_torch.launch import probe as probe_mod
    cfg = apply_overrides(registry.get(args.arch), args.set)
    cell = next(c for c in SHAPES if c.name == args.shape)
    rec = probe_mod.probe_cell(args.arch, cell, cfg=cfg)
    rec["label"] = args.label or ",".join(args.set) or "baseline"
    rec["overrides"] = args.set
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "status", "label") if k in rec}))
    if rec["status"] == "OK":
        print(f"flops/dev={rec['flops_total']:.4e}  "
              f"coll/dev={rec['coll_total'] / 1e9:.1f}GB")
        print("coll by op:",
              {k: f"{v / 1e9:.1f}GB" for k, v in rec["coll_by_op"].items()})
    else:
        print(rec.get("error"))
    import torch
    print(f"cuda initialized: {torch.cuda.is_initialized()}")
    fh = probe_mod._open_out(args.out)
    if fh:
        with fh:
            fh.write(json.dumps(rec) + "\n")
    return 0 if rec["status"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
