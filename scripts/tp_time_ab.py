"""Model-axis training round time of two checkouts of this repo, in
alternating order on four cards: ``chip_smoke.py``'s ``tp_time`` leg.

Each run is one fresh (1, 4) mesh spawned from one checkout, with that
checkout's own ``chip_smoke._tp_rank`` and package: two rounds of qwen2-7b
at 28 layers, one client (K = D = 1), batch 1 of 2048 tokens, under
``--schedule``, weights from seed 0.  Round 0 carries the first calls'
set-up; round 1 is the one ``chip_smoke.py`` reports.  Runs go A B, B A,
A B, ... for ``--pairs`` pairs; both checkouts' kernel libraries are built
first, in parallel, and not timed.

    python3 scripts/tp_time_ab.py A_DIR B_DIR [--pairs 2]
        [--schedule tree]

Prints a JSON line a run (rank 0's round times, every rank's, rank 0's
round-1 peak and model-collective ms), then a summary (each checkout's
round-1 times, rank 0 and the slowest rank), then the card's name and
power limit.  Needs four CUDA cards.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _env(root: Path) -> dict:
    return dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'src'}")


def run_once(root: Path, sched: str) -> None:
    """One spawn of the leg from the checkout at ``root``; prints its
    rows."""
    sys.path[:0] = [str(root), str(root / "src")]
    os.chdir(root)
    import chip_smoke as cs
    from repro_torch.launch import mesh as mesh_lib
    leg = f"tp_time:{sched}"
    ranks = mesh_lib.spawn(cs._tp_rank, 1, ([leg],), model=4,
                           device="cuda", timeout_s=cs.TP_TIMEOUT_S)
    rows = [r[leg] for r in ranks]
    print(json.dumps({
        "round_s": rows[0]["round_s"],
        "round_s_rank": [r["round_s"] for r in rows],
        "init_s_rank": [r["init_s"] for r in rows],
        "round1_max_memory_allocated": rows[0].get(
            "round1_max_memory_allocated"),
        "model_collectives_ms_rank": rows[0]["model_collectives_ms_rank"],
        "leg_s": ranks[0]["leg_s"][leg]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path, help="A_DIR B_DIR")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--schedule", default="tree")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_once(args.run.resolve(), args.schedule)
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
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, __file__, "--run", str(roots[tag]),
                 "--schedule", args.schedule], env=_env(roots[tag]),
                stdout=subprocess.PIPE, text=True, check=True)
            row = json.loads(out.stdout.strip().splitlines()[-1])
            got[tag].append(row)
            print(json.dumps({"pair": i, "tree": tag,
                              "wall_s": time.perf_counter() - t0, **row}),
                  flush=True)
    summary = {}
    for tag, rows in got.items():
        r0 = [r["round_s"][1] for r in rows]
        slow = [max(s[1] for s in r["round_s_rank"]) for r in rows]
        summary[tag] = {"round1_s_rank0": r0,
                        "round1_s_rank0_median": statistics.median(r0),
                        "round1_s_slowest_rank": slow,
                        "round0_s_rank0": [r["round_s"][0] for r in rows]}
    print(json.dumps({"summary": args.schedule, "mesh": [1, 4], **summary}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
