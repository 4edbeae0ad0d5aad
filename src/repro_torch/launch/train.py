"""End-to-end SDFLMQ trainer on one device.

Wires the whole stack together:
  control plane — SimBroker + Coordinator + SDFLMQClients + ParameterServer
                  run the paper's session protocol (create/join, clustering,
                  role (re)arrangement via topics, readiness/stats updates);
  data plane    — the coordinator's cluster tree is compiled to an
                  AggSchedule and one fl_round_step runs per round (local
                  steps of every client, then per leaf the fedavg kernel,
                  or for ``compressed`` an int8 quantize and the qagg
                  kernel);
  substrate     — federated token streams (non-IID), checkpoint manager
                  (resume-exact), failure injection -> LWT -> role
                  rearrangement, straggler demotion.

Round steps are cached per schedule signature, as the reference caches its
compiled steps.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --smoke --rounds 8 --local-steps 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.api.federation import Federation
from repro_torch.ckpt.checkpoint import check_leaf_sizes
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step, init_state
from repro_torch.core.stats import StatsSimulator
from repro_torch.core.topology import AggSchedule, compile_tree
from repro_torch.data.federated import FederatedTokens
from repro_torch.device import resolve
from repro_torch.ft.failures import FailurePlan


class SDFLMQTrainer:
    def __init__(self, cfg, n_clients: int, rounds: int,
                 batch_per_client: int, seq: int, ckpt_dir: str | None = None,
                 schedule_kind: str = "tree", seed: int = 0,
                 failure_plan: FailurePlan | None = None,
                 strategy: str = "fedavg",
                 update_filter=None, device="cuda"):
        self.device = resolve(device)
        self.cfg, self.rounds = cfg, rounds
        self.n = n_clients
        self.batch_per_client, self.seq = batch_per_client, seq
        self.schedule_kind = schedule_kind
        self.strategy = strategy
        self.update_filter = update_filter
        self.failures = failure_plan or FailurePlan()

        # ---- control plane (via the repro_torch.api facade) ------------
        self.fed = Federation(role_policy=cfg.fl.role_policy,
                              aggregator_ratio=cfg.fl.aggregator_ratio,
                              levels=cfg.fl.levels)
        self.broker = self.fed.transport
        self.coord = self.fed.coordinator
        self.ps = self.fed.param_server
        self.sim = StatsSimulator([f"c{i}" for i in range(n_clients)],
                                  seed=seed)
        sid = self.sid = "train_session"
        members = [self.fed.client(f"c{i}",
                                   preferred_role="aggregator" if i % 3 == 0
                                   else "trainer",
                                   stats=self.sim.sample(f"c{i}", 0))
                   for i in range(n_clients)]
        self.session = self.fed.create_session(
            sid, cfg.name, rounds, participants=members, strategy=strategy)
        self.clients = self.session.participants
        assert self.session.state == "running"

        # ---- data plane ----------------------------------------------
        self.data = FederatedTokens(cfg.vocab, n_clients, seed=seed)
        self.state = init_state(cfg, n_clients, seed, self.device,
                                total_steps=rounds * cfg.fl.local_steps,
                                update_filter=update_filter)
        self._steps = {}
        self.ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        self.start_round = 0
        if self.ckpt:
            check_leaf_sizes(self.state)      # raise before round 0
            restored, meta = self.ckpt.restore_latest(self.state)
            if restored is not None:
                self.start_round = int(meta["step"])
        self.metrics: list[dict] = []
        self.latencies: dict[str, float] = {}
        self.weights: np.ndarray | None = None
        # optional hook: on_round_end(round_idx, state) after each round
        # (after its checkpoint is saved)
        self.on_round_end = None

    # ------------------------------------------------------------------
    def _schedule(self):
        if self.schedule_kind != "tree":
            return AggSchedule(self.schedule_kind, self.n)
        tree = self.coord.tree_of(self.sid)
        # clients keep their original bank row; dead rows ride zero-weighted
        index_of = {cid: int(cid[1:]) for cid in tree.client_order}
        return compile_tree(tree, axis_size=self.n, index_of=index_of)

    def _step_for(self, schedule):
        key = schedule.signature()
        if key not in self._steps:
            self._steps[key] = build_fl_round_step(
                self.cfg, self.n, schedule, self.device,
                total_steps=self.rounds * self.cfg.fl.local_steps,
                strategy=self.strategy, update_filter=self.update_filter)
        return self._steps[key]

    def run(self) -> list[dict]:
        sid = self.sid
        weights_np = np.array(
            [self.clients[f"c{i}"].stats.samples or 1.0
             for i in range(self.n)], np.float32)
        self.weights = weights_np
        cuda = self.device.type == "cuda"
        for r in range(self.start_round, self.rounds):
            t0 = time.perf_counter()
            # failure injection -> LWT -> coordinator rearranges; the dead
            # client's bank row gets zero FedAvg weight (sums unaffected)
            for dead in self.failures.fail_at.get(r, []):
                if dead in self.clients:
                    self.session.fail(dead)
                    weights_np[int(dead[1:])] = 0.0
            schedule = self._schedule()
            step = self._step_for(schedule)
            with record_function("train/batch"):
                batch = self.data.global_batch(
                    self.n, self.batch_per_client, self.seq, r)
            self.state, m = step(self.state, batch, weights_np)
            loss = float(m["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            # device ms of the round's spans (aggregate, ref), card only
            span_ms = {f"{k}_ms": a.elapsed_time(b)
                       for k, (a, b) in m["spans"].items()}
            tokens = self.n * self.batch_per_client * self.seq \
                * self.cfg.fl.local_steps
            self.metrics.append({
                "round": r, "loss": loss, "time_s": dt,
                "tokens_per_s": tokens / dt,
                "schedule": schedule.signature(),
                "level_groups": schedule.level_groups,
                "n_clients": len(self.clients), **span_ms,
                "max_memory_allocated": (torch.cuda.max_memory_allocated(
                    self.device) if cuda else None)})
            if self.ckpt and self.ckpt.should_save(r + 1):
                self.ckpt.save(r + 1, self.state, {"loss": loss})
            if self.on_round_end is not None:
                self.on_round_end(r, self.state)
            # round-status updates: stats + readiness -> role optimization
            slow = self.failures.straggle_at.get(r, {})
            for cid, cl in list(self.clients.items()):
                st = self.sim.sample(cid, r + 1)
                st.last_round_s = dt * slow.get(cid, 1.0)
                st.samples = int(weights_np[int(cid[1:])])
                self.latencies[cid] = st.last_round_s
                cl.signal_ready(sid, stats=st)
        return self.metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--schedule", default="tree",
                    choices=["tree", "flat", "rs_ag", "compressed"])
    ap.add_argument("--strategy", default="fedavg",
                    help="aggregation strategy (repro_torch.api.strategies)")
    ap.add_argument("--update-filter", default=None,
                    help="partial-update ParamFilter patterns "
                         "(comma-separated globs, ! prefix excludes); only "
                         "matching leaves train and aggregate")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.replace(fl=cfg.fl.__class__(
        mode="replica", local_steps=args.local_steps,
        aggregator_ratio=cfg.fl.aggregator_ratio, levels=cfg.fl.levels,
        schedule=args.schedule, role_policy=cfg.fl.role_policy))
    trainer = SDFLMQTrainer(cfg, args.clients, args.rounds,
                            args.batch_per_client, args.seq,
                            ckpt_dir=args.ckpt_dir,
                            schedule_kind=args.schedule,
                            strategy=args.strategy,
                            update_filter=args.update_filter,
                            device=args.device)
    for m in trainer.run():
        print(f"round {m['round']:3d} loss {m['loss']:.4f} "
              f"{m['time_s']:.2f}s sched={m['schedule']} "
              f"clients={m['n_clients']}")


if __name__ == "__main__":
    main()
