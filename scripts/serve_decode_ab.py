"""Single-card serving's decode time of two checkouts of this repo, in
alternating pairs on one card.

Each checkout runs in a worker process of its own that holds its engines
(``ServeEngine`` at batch 4 on bf16 weights at published widths and depth,
drawn from seed 0 by that checkout's own init).  The parent asks the
workers in turn, A B then B A, for one batch of the SERVE cells' traffic:
the first 4 of ``chip_smoke.py``'s 8 prompts (1536-2048 tokens from
``numpy`` seed 0), 32 new tokens each.  A batch's decode ms a step is the
engine's own ``stats`` over it (``decode_s / decode_steps``, as
``chip_smoke.phase_serve`` reports it); one batch a model is run first in
each worker and not counted.  Only one worker runs at a time.

    python3 scripts/serve_decode_ab.py A_DIR B_DIR [--pairs 10]
        [--arch qwen2-7b --arch hymba-1.5b]

Prints a JSON line a batch, then one summary line a model (each
checkout's median, min and max, the median of the pairs' B - A and in how
many pairs B was slower), then the card's name and power limit.  Needs a
CUDA card; the weights of the two checkouts differ where their init
does, which a dense model's decode time does not see.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, MAX_NEW, PROMPT = 4, 32, (1536, 2048)


def _prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT[0], PROMPT[1] + 1, 2 * BATCH)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in lens][:BATCH]


def worker(root: Path, archs: list) -> None:
    """Holds one engine a model of the checkout at ``root``; for each
    model name read on stdin, serves one batch and prints its times."""
    sys.path[:0] = [str(root / "src")]
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model_api
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    engines = {}

    def batch(arch):
        eng = engines[arch]
        before = dict(eng.stats)
        for p in _prompts(eng.cfg.vocab):
            eng.submit(p, MAX_NEW)
        eng.run()
        d = {k: eng.stats[k] - before[k] for k in ("decode_s", "prefill_s",
                                                    "decode_steps")}
        return {"decode_ms": d["decode_s"] / d["decode_steps"] * 1e3,
                "prefill_s": d["prefill_s"]}

    for arch in archs:
        cfg = get_arch(arch)
        engines[arch] = ServeEngine(cfg, model_api.init_params(cfg, 0, dev),
                                    batch_size=BATCH,
                                    max_seq=PROMPT[1] + MAX_NEW + 1,
                                    device=dev)
        batch(arch)                                     # warm, not counted
    print("ready", flush=True)
    for line in sys.stdin:
        arch = line.strip()
        if arch == "quit":
            break
        print(json.dumps(batch(arch)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path, help="A_DIR B_DIR")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--arch", action="append")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.arch or ["qwen2-7b", "hymba-1.5b"]
    if args.worker:
        worker(args.worker.resolve(), archs)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A_DIR and B_DIR")
    procs = {}
    try:
        for tag, root in zip("AB", args.trees):
            cmd = [sys.executable, __file__, "--worker", str(root.resolve())
                   ] + [x for a in archs for x in ("--arch", a)]
            procs[tag] = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                          stdout=subprocess.PIPE, text=True)
        for tag, p in procs.items():
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"worker {tag} did not start")
        rows = {a: {"A": [], "B": []} for a in archs}
        for i in range(args.pairs):
            for arch in archs:
                for tag in ("AB" if i % 2 == 0 else "BA"):
                    p = procs[tag]
                    t0 = time.perf_counter()
                    p.stdin.write(arch + "\n")
                    p.stdin.flush()
                    r = json.loads(p.stdout.readline())
                    rows[arch][tag].append(r["decode_ms"])
                    print(json.dumps({"pair": i, "arch": arch, "tree": tag,
                                      "wall_s": time.perf_counter() - t0,
                                      **r}), flush=True)
        for arch in archs:
            a, b = rows[arch]["A"], rows[arch]["B"]
            diff = [y - x for x, y in zip(a, b)]
            print(json.dumps({
                "summary": arch, "pairs": len(diff),
                "A": {"median": statistics.median(a), "min": min(a),
                      "max": max(a)},
                "B": {"median": statistics.median(b), "min": min(b),
                      "max": max(b)},
                "b_minus_a_median_ms": statistics.median(diff),
                "b_slower_pairs": sum(d > 0 for d in diff)}), flush=True)
        for p in procs.values():
            p.stdin.write("quit\n")
            p.stdin.flush()
            p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
