"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison read
beside its limit.  The same checks are the last lines on standard error.
Exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where the program is missing, or where the process
has loaded JAX or the JAX package.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CACHE = ROOT / "build" / "fedbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fedbench import cells, harness
    cell = cells.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fedbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fedbench: the process loaded {bad}", file=sys.stderr)
        return 4
    print(json.dumps(out["extra"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    del out["extra"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
