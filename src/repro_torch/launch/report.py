"""Render EXPERIMENTS.md tables from the dry-run JSON records."""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(out_dir: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(recs, mesh: str) -> str:
    rows = ["| arch | shape | status | bytes/dev GiB | flops/dev | "
            "coll GB | HLO collectives |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skipped ({r['reason'][:40]}...) | | | | |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | |")
            continue
        rf = r["roofline"]
        counts = ", ".join(f"{k}:{int(v)}" for k, v in
                           sorted(rf["collective_counts"].items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{fmt_bytes(r['memory'].get('total_per_device', 0))} | "
            f"{rf['flops_per_dev']:.2e} | "
            f"{rf['collective_bytes'] / 1e9:.2f} | {counts} |")
    return "\n".join(rows)


def roofline_table(recs) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL_FLOPS | useful ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != "pod" or r["status"] != "ok":
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} | "
            f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
            f"**{rf['dominant']}** | {rf['model_flops_total']:.2e} | "
            f"{rf['useful_flops_ratio']:.3f} | {rf['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def worst_cells(recs, k=6):
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "pod"
          and r["shape"] == "train_4k"]
    ok.sort(key=lambda r: r["roofline"]["roofline_fraction"])
    return [(r["arch"], r["shape"], round(r["roofline"]["roofline_fraction"], 4),
             r["roofline"]["dominant"]) for r in ok[:k]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--what", default="all",
                    choices=["all", "dryrun", "roofline", "worst"])
    args = ap.parse_args()
    recs = load(args.dir)
    if args.what in ("all", "dryrun"):
        print("### Single-pod (16x16)\n")
        print(dryrun_table(recs, "pod"))
        print("\n### Multi-pod (2x16x16)\n")
        print(dryrun_table(recs, "multipod"))
    if args.what in ("all", "roofline"):
        print("\n### Roofline (single-pod)\n")
        print(roofline_table(recs))
    if args.what in ("all", "worst"):
        print("\nworst train cells:", worst_cells(recs))


if __name__ == "__main__":
    main()
