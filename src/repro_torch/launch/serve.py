"""Serving entry point: batched prefill+decode over a (reduced or full)
assigned architecture, the inference-side counterpart of
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --requests 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.device import resolve
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--full", action="store_true",
                    help="published widths (random weights)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    dev = resolve(args.device)
    params = model_api.init_params(cfg, args.seed, dev)
    engine = ServeEngine(cfg, params, batch_size=args.batch_size, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab,
                                   size=rng.integers(4, args.prompt_len + 1)),
                      max_new=args.max_new)
    done = engine.run()
    wall = time.perf_counter() - t0
    s = engine.stats
    out_toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {out_toks} tokens in {wall:.2f}s "
          f"({out_toks / wall:.1f} tok/s end-to-end)")
    print(f"prefill: {s['prefill_tokens']} tok {s['prefill_s']:.2f}s | "
          f"decode: {s['decode_steps']} steps {s['decode_s']:.2f}s")


if __name__ == "__main__":
    main()
