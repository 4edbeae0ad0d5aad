"""Federated LM training end-to-end on one device: the FL round step (every
client's local steps, then the chosen aggregation) driven by the SDFLMQ
control plane.

Trains a reduced Qwen2-family model across simulated clients (non-IID
token streams), with checkpointing and a mid-run client failure that
triggers role rearrangement.

    PYTHONPATH=src python -m repro_torch.examples.federated_lm [--rounds 12]
    PYTHONPATH=src python -m repro_torch.examples.federated_lm --device cpu \\
        --rounds 4 --clients 4 --seq 32 --batch-per-client 2

Scale knobs: --model-dim/--layers size the reduced model; --full uses the
published qwen2-7b widths, with --layers to cut its depth (28 layers do not
fit K client banks and their AdamW moments on one card).  --full runs
without a checkpoint: the client-stacked embedding's f32 moments exceed
the 4 GiB a leaf that the checkpoint format holds once K >= 2.
"""
import argparse
import tempfile

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch.train import SDFLMQTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--model-dim", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--strategy", default="fedavg",
                    help="aggregation strategy: fedavg | fedprox | "
                         "trimmed_mean | coordinate_median | krum | ...")
    ap.add_argument("--update-filter", default=None,
                    help="partial-update glob spec, e.g. '*/lora_A,*/lora_B'")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch("qwen2-7b")
    if not args.full:
        cfg = smoke_config(cfg)
        if args.model_dim:
            cfg = cfg.replace(d_model=args.model_dim,
                              head_dim=args.model_dim // 4)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    # the format holds at most 4 GiB a leaf, which full width exceeds
    ckpt = None if args.full else tempfile.mkdtemp(prefix="fedlm_ckpt_")
    plan = FailurePlan(fail_at={args.rounds // 2: [f"c{args.clients - 1}"]})
    tr = SDFLMQTrainer(cfg, args.clients, args.rounds,
                       args.batch_per_client, args.seq, ckpt_dir=ckpt,
                       failure_plan=plan, strategy=args.strategy,
                       update_filter=args.update_filter, device=args.device)
    print(f"clients={args.clients} rounds={args.rounds} "
          f"strategy={args.strategy} ckpt={ckpt}")
    for m in tr.run():
        print(f"round {m['round']:3d} loss {m['loss']:.4f} "
              f"({m['time_s']:.2f}s, {m['n_clients']} clients, "
              f"schedule {m['schedule']})")
    print("rearrangement messages:", tr.coord.rearrangement_messages)


if __name__ == "__main__":
    main()
