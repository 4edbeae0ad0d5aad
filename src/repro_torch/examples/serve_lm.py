"""Batched serving of a (reduced) assigned architecture on one device:
prefill + decode with a KV cache (or the recurrent state), the same
functions ``launch/serve.py`` drives.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.device import resolve
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_arch(args.arch))
    dev = resolve(args.device)
    params = model_api.init_params(cfg, 0, dev)
    engine = ServeEngine(cfg, params, batch_size=4, device=dev)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab, size=rng.integers(4, 12)),
                      max_new=args.max_new)
    done = engine.run()
    for r in done:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    s = engine.stats
    print(f"prefill {s['prefill_tokens']} tok in {s['prefill_s']:.2f}s | "
          f"decode {s['decode_steps']} steps in {s['decode_s']:.2f}s | "
          f"{s['decode_steps'] * 4 / max(s['decode_s'], 1e-9):.1f} tok/s")


if __name__ == "__main__":
    main()
