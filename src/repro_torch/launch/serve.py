"""Serving entry point: batched prefill+decode over a (reduced or full)
assigned architecture, the inference-side counterpart of
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --requests 16 [--device cpu]

On ranks (``--data-mesh D --model-mesh M``: D x M processes started here,
rank r on cuda:r, or gloo with ``--device cpu``; or from torchrun, whose
WORLD_SIZE is D x M), each rank holds its blocks of the parameters and
the cache (``serve/engine.py``), and rank 0 prints:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --model-mesh 2 [--data-mesh 2]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu --model-mesh 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.device import resolve
from repro_torch.launch import mesh as mesh_lib
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
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="the mesh's data axis: a batch's rows split over "
                         "its ranks (0: one device)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="the mesh's model axis: the layers and the cache "
                         "split over its ranks; data x model ranks in all")
    args = ap.parse_args(argv)
    M = args.model_mesh
    mesh_lib.check_axes(M)
    if args.data_mesh or M > 1 or mesh_lib.in_torchrun():
        world = int(os.environ.get("WORLD_SIZE",
                                   max(args.data_mesh, 1) * M))
        if world % M or args.data_mesh not in (0, world // M):
            raise ValueError(f"--data-mesh {args.data_mesh} and "
                             f"--model-mesh {M} on {world} ranks")
        if mesh_lib.in_torchrun():
            mesh = mesh_lib.mesh_from_env(M, device=args.device)
            _run(mesh, args)
            mesh.close()
        else:
            mesh_lib.spawn(_run, world // M, (args,), model=M,
                           device=args.device)
        return
    _run(None, args)


def _config(args):
    cfg = get_arch(args.arch)
    return cfg if args.full else smoke_config(cfg)


def _run(mesh, args):
    """The CLI's engine, on one device or as one rank; rank 0 prints."""
    cfg = _config(args)
    dev = mesh.device if mesh is not None else resolve(args.device)
    params = model_api.init_params(cfg, args.seed, dev, mesh=mesh)
    engine = ServeEngine(cfg, params, batch_size=args.batch_size, device=dev,
                         mesh=mesh)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab,
                                   size=rng.integers(4, args.prompt_len + 1)),
                      max_new=args.max_new)
    done = engine.run()
    wall = time.perf_counter() - t0
    if mesh is not None and mesh.rank:
        return
    s = engine.stats
    out_toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {out_toks} tokens in {wall:.2f}s "
          f"({out_toks / wall:.1f} tok/s end-to-end)")
    print(f"prefill: {s['prefill_tokens']} tok {s['prefill_s']:.2f}s | "
          f"decode: {s['decode_steps']} steps {s['decode_s']:.2f}s")
    for r in done:
        print(f"req {r.rid}: {r.out}")


if __name__ == "__main__":
    main()
