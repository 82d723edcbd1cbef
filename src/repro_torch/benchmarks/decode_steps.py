"""Decode-step times of the port's serve step at full width, one JSON line
a model, for holding one checkout's per-step host work against
another's on the same card.

    PYTHONPATH=src python src/repro_torch/benchmarks/decode_steps.py \\
        [--steps 32] [--label NAME]

Each model gets random weights (seed 0) on cuda:0, a 4 x 1024 prompt
through ``make_prefill_step`` and then ``--steps`` one-token steps of
``make_serve_step``, each synchronised; its line gives the median and
the least step time in ms and the kernels' launches in the last step.
The models are the ones ``chip_smoke.py`` serves: kimi-k2-1t-a32b at 2
layers, deepseek-v2-lite-16b whole, jamba-1.5-large-398b at its first 5
layers and xlstm-350m at its 24.  Only ``registry.get``,
``model_zoo.init``, the two step builders and the launch counters are
used, so with another checkout's ``src`` first on ``PYTHONPATH`` the
same file runs the same measurement on that checkout's code.
"""
import argparse
import gc
import json
import statistics
import time

import torch

BATCH, PROMPT = 4, 1024
MODELS = (("kimi-k2-1t-a32b", {"n_layers": 2}),
          ("deepseek-v2-lite-16b", {}),
          ("jamba-1.5-large-398b", {"n_layers": 5, "attn_every": 5}),
          ("xlstm-350m", {"n_layers": 24}))


def time_steps(arch: str, cut: dict, steps: int, dev) -> dict:
    from repro_torch.configs import registry
    from repro_torch.kernels import common
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import (make_prefill_step,
                                              make_serve_step)
    cfg = registry.get(arch).replace(**cut)
    params = model_zoo.init(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=dev)
    step_s = []
    with torch.inference_mode():
        prefill = make_prefill_step(cfg, cache_len=PROMPT + steps)
        step = make_serve_step(cfg)
        tok, caches = prefill(params, {"tokens": prompt})
        tok = tok.to(torch.int32)
        torch.cuda.synchronize()
        for t in range(steps):
            common.reset_launches()
            t0 = time.perf_counter()
            tok, caches = step(params, tok, caches, PROMPT + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    launches = {k: v for k, v in common.launch_counts().items() if v}
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "steps": steps,
            "median_step_ms": 1e3 * statistics.median(step_s),
            "min_step_ms": 1e3 * min(step_s), "launches_per_step": launches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_steps: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    for arch, cut in MODELS:
        rec = time_steps(arch, cut, args.steps, dev)
        rec["label"] = args.label
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
