"""The readings that a cell's limits are set from, in one process: the
program's numbers on many seeds (the lower readings), the control's (the
reference one precision step below, fp8 products, against the reference),
a planted fault's (the reference with half of the clients left out of
every mean, against the reference) and, where the traffic sends int8
payloads, the plain control's (the reference with the int8 codec left
out, against the reference).  Each reading is one JSON line on standard
output.  A seed given to several of the last three reads the reference
once for all of them.

    python3 fedbench/calibrate.py --workload <cell> --program 1,2,3 \
        --control 4,5,6 --fault 4,5,6 [--plain 4,5,6]

The benchmark's own runs never run this; it needs a CUDA card, as they do.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class RefReadings:
    """A reference run's readings in the place of the program's."""

    def __init__(self, ref: dict, rounds: int, dtype):
        b = ref["inputs"]["batches"]
        self.rounds, self.slots_differ = rounds, 0
        self.inputs = [({key: [c[key] for c in b[r]] for key in b[r][0]},
                        ref["inputs"]["weights"]) for r in range(rounds)]
        for batch, _ in self.inputs:
            for key in batch:
                batch[key] = np.stack(batch[key])
        self.grad_norms = ref["grad_norms"]
        self.p1 = {n: t.to(dtype) for n, t in ref["p1"].items()}
        self.change_norms = ref["change_norms"]
        self._loss = ref["loss"]

    def losses(self):
        return self._loss


def _seeds(text):
    return [int(s) for s in text.split(",") if s] if text else []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--plain", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    from fedbench import cells, harness
    from fedbench.reference import fl as ref_fl
    cell = cells.resolve(args.workload)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes, traffic, R = cell.config, cell.traffic, harness.CHECK_ROUNDS
    dtype = getattr(torch, sizes["param_dtype"])

    def emit(kind, seed, prog, ref, t0, **extra):
        gaps = harness.leaf_gaps(prog, ref, dev)
        worst = {k: sorted(v.items(), key=lambda x: -x[1])[:3]
                 for k, v in gaps.items() if isinstance(v, dict)}
        print(json.dumps({"kind": kind, "seed": seed,
                          "numbers": harness.compare(prog, ref, dev, gaps),
                          "worst_leaves": worst,
                          "change_gaps": gaps["change"],
                          "s": time.perf_counter() - t0, **extra}),
              flush=True)

    for seed in _seeds(args.program):
        t0 = time.perf_counter()
        trainer, _, readings = harness.program_setup(cell, sizes, seed, dev)
        cuda = dev.type == "cuda"
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        losses = readings.losses()
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        ref = ref_fl.run(sizes, traffic, seed, dev, R)
        emit("program", seed, readings, ref, t0,
             ref_s=time.perf_counter() - t1, peak=peak,
             ref_peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
             losses=losses, ref_losses=ref["loss"],
             ref_dropped=ref["dropped"])
        del readings, ref
        gc.collect()
        torch.cuda.empty_cache()
    plain = dict(traffic, schedule="tree")
    others = {}
    for kind, seeds, kw in (
            ("control", args.control, {"precision": "fp8"}),
            ("fault_half", args.fault, {"fault": "half"}),
            ("plain", args.plain, {"traffic": plain})):
        for seed in _seeds(seeds):
            others.setdefault(seed, []).append((kind, kw))
    for seed, todo in others.items():
        ref = ref_fl.run(sizes, traffic, seed, dev, R)
        for kind, kw in todo:
            t0 = time.perf_counter()
            kw = dict(kw)
            other = RefReadings(ref_fl.run(
                sizes, kw.pop("traffic", traffic), seed, dev, R, **kw),
                R, dtype)
            emit(kind, seed, other, ref, t0,
                 losses=other.losses(), ref_losses=ref["loss"])
            del other
            gc.collect()
            torch.cuda.empty_cache()
        del ref


if __name__ == "__main__":
    main()
