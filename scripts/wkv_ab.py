"""The WKV kernel's time at its path shapes in two checkouts of this repo,
in alternating order on one card.

Each run is a fresh process in one checkout that calls that checkout's
``chip_smoke.phase_wkv`` on the named cases of its ``WKV_CASES`` (the
kernel against its plain version, then timed: the median of 10 calls of
the wrapper, allocation of its outputs and scratch included).  Runs go
A B, B A, ... for ``--pairs`` pairs; both kernel libraries are built
first, in parallel, and not timed.

    python3 scripts/wkv_ab.py A_DIR B_DIR [--pairs 3]
        [--case path_hymba --case path_rwkv6]

Prints a JSON line a run and case (the kernel's ms), then a summary a
case (each checkout's ms, the median of the pairs' B - A and in how many
pairs B was slower), then the card's name and power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def _env(root: Path) -> dict:
    return dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'src'}")


def run_once(root: Path, cases: list) -> None:
    """One call of the checkout's ``phase_wkv`` on ``cases``; prints each
    case's kernel ms."""
    sys.path[:0] = [str(root), str(root / "src")]
    os.chdir(root)
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    chosen = [c for c in cs.WKV_CASES if c[0] in cases]
    with contextlib.redirect_stdout(io.StringIO()):    # its own lines
        rows = cs.phase_wkv(torch, torch.device("cuda", 0), cases=chosen)
    print(json.dumps({n: r["kernel_ms"] for n, r in rows.items()}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path, help="A_DIR B_DIR")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--case", action="append")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = args.case or ["path_hymba", "path_rwkv6"]
    if args.run:
        run_once(args.run.resolve(), cases)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A_DIR and B_DIR")
    roots = dict(zip("AB", (t.resolve() for t in args.trees)))
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import _build; "
         "_build.build()"], cwd=root, env=_env(root))
        for root in roots.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a kernel build failed")
    got = {"A": [], "B": []}
    for i in range(args.pairs):
        for tag in ("AB" if i % 2 == 0 else "BA"):
            out = subprocess.run(
                [sys.executable, __file__, "--run", str(roots[tag])]
                + [x for c in cases for x in ("--case", c)],
                env=_env(roots[tag]), stdout=subprocess.PIPE, text=True,
                check=True)
            row = json.loads(out.stdout.strip().splitlines()[-1])
            got[tag].append(row)
            print(json.dumps({"pair": i, "tree": tag, **row}), flush=True)
    for case in cases:
        a = [r[case] for r in got["A"]]
        b = [r[case] for r in got["B"]]
        diff = [y - x for x, y in zip(a, b)]
        print(json.dumps({"summary": case, "A_ms": a, "B_ms": b,
                          "b_minus_a_median_ms": statistics.median(diff),
                          "b_slower_pairs": sum(d > 0 for d in diff)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
