"""End-to-end SDFLMQ trainer, on one device or over a client mesh of
ranks.

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
compiled steps.  A round runs under the profiler ranges ``train/schedule``
(failures, schedule, the step's lookup), ``train/batch``, ``train/step``,
``train/wait`` (the loss read: a sync, where the host waits) and
``train/round_end`` (metrics, checkpoint, status updates).

On a mesh (``mesh=``, ``--data-mesh D [--model-mesh M]``: client d on
ranks ``d*M .. d*M + M - 1``, rank r on ``cuda:r``) rank 0 alone runs the
control plane, since its stats (the round's wall-clock time among them)
drive the role optimizer, and each round broadcasts the schedule and the
weights to the other ranks.  Every rank of client d trains on
``FederatedTokens.client_batch(d, ...)``, row d of the global batch; with
M > 1 the client's layers are split over its ranks (tensor parallelism,
``dist/tensor_parallel.py``: an MoE family's experts split or each
expert's width), under the config's optimizer, Adafactor included.  The
trainer feeds tokens only, as the reference's does; the encoder-decoder
and VLM families take frames or patches through ``fl_step`` directly.
In ``shared`` mode (``--pod-mesh P``, the MoE configs' declared mode) a
client is a pod of D x M ranks (rank ``(p*D + d)*M + m``): K = P clients,
each fully sharded over its D data ranks (its parameters' ``embed`` dim
split, its batch's rows where they divide D) and tensor-parallel over M;
without a pod axis the whole mesh is one client.
Checkpoints keep the single-device format: rank 0 gathers every rank's
block of every leaf on save and assembles the whole state, and scatters
each rank's block back on restore.  Adafactor's factors over a split dim
are whole and equal on a client's ranks, so their blocks assemble the
single device's factors.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --smoke --rounds 8 --local-steps 2 [--device cpu]
    # 2 ranks on this host (gloo on the CPU, NCCL on two cards)
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --data-mesh 2 \
        [--device cpu]
    # or one process a rank under torchrun
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --data-mesh 4
    # 2 clients, each split over 2 ranks (4 processes; WORLD_SIZE = D x M
    # under torchrun)
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --data-mesh 2 \
        --model-mesh 2 [--device cpu]
    # an MoE config under Adafactor: its experts split over the ranks
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --arch mixtral-8x22b --data-mesh 2 --model-mesh 2 [--device cpu]
    # shared mode: 2 clients (pods), each FSDP over 2 data ranks
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --arch mixtral-8x22b --pod-mesh 2 --data-mesh 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import tree as T
from repro_torch.api.federation import Federation
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.aggregation import _chunks
from repro_torch.core.fl_step import (abstract_state, build_fl_round_step,
                                      client_axis_for, init_state,
                                      n_clients_for, state_specs)
from repro_torch.core.stats import StatsSimulator
from repro_torch.core.topology import AggSchedule, compile_tree
from repro_torch.data.federated import FederatedTokens
from repro_torch.device import resolve
from repro_torch.dist.sharding import local_block
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs.spans import span_ms
from repro_torch.optim.api import make_optimizer


class SDFLMQTrainer:
    def __init__(self, cfg, n_clients: int, rounds: int,
                 batch_per_client: int, seq: int, ckpt_dir: str | None = None,
                 schedule_kind: str = "tree", seed: int = 0,
                 failure_plan: FailurePlan | None = None,
                 strategy: str = "fedavg",
                 update_filter=None, device="cuda", mesh=None):
        if mesh is not None and n_clients != n_clients_for(cfg, mesh):
            raise ValueError(f"{n_clients} clients on a mesh of shape "
                             f"{mesh.shape} in {cfg.fl.mode} mode: one "
                             "client a row of its data axis (replica) or a "
                             "pod (shared)")
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0   # runs the control plane
        self.device = mesh.device if mesh is not None else resolve(device)
        self.cfg, self.rounds = cfg, rounds
        self.n = n_clients
        self.batch_per_client, self.seq = batch_per_client, seq
        self.schedule_kind = schedule_kind
        self.strategy = strategy
        self.update_filter = update_filter
        self.failures = failure_plan or FailurePlan()

        # ---- control plane (via the repro_torch.api facade) ------------
        if self.lead:
            self._control_plane(cfg, n_clients, rounds, seed, strategy)

        # ---- data plane ----------------------------------------------
        self.data = FederatedTokens(cfg.vocab, n_clients, seed=seed)
        self.state = init_state(cfg, mesh or n_clients, seed, self.device,
                                total_steps=rounds * cfg.fl.local_steps,
                                update_filter=update_filter)
        self._steps = {}
        self.ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        self.start_round = 0
        if self.ckpt:
            if mesh is not None:
                self.start_round = self._restore_mesh()
            else:
                restored, meta = self.ckpt.restore_latest(self.state)
                if restored is not None:
                    self.start_round = int(meta["step"])
        self.metrics: list[dict] = []
        self.latencies: dict[str, float] = {}
        self.weights: np.ndarray | None = None
        # optional hook: on_round_end(round_idx, state) after each round
        # (after its checkpoint is saved)
        self.on_round_end = None

    def _control_plane(self, cfg, n_clients, rounds, seed, strategy):
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

    # ---- checkpoints on a mesh: every block through rank 0 -------------
    def _leaves(self):
        """Every leaf of this rank's state beside the whole state's (meta)
        and its spec."""
        specs = state_specs(self.cfg, self.mesh,
                            make_optimizer(self.cfg).name)
        return zip(T.leaves(self.state),
                   T.leaves(abstract_state(self.cfg, self.n)),
                   T.leaves(specs))

    def _gathered_state(self):
        """On rank 0, the single-device state on the host: every rank's
        block of every leaf, gathered chunk by chunk and put in its place
        (``local_block`` of the whole leaf); None on the others."""
        mesh, lead = self.mesh, self.mesh.rank == 0
        out = []
        for t, whole, spec in self._leaves():
            if not torch.is_tensor(t):
                out.append(t)
                continue
            flat = t.view(-1)
            blocks = [torch.empty(flat.shape, dtype=t.dtype)
                      for _ in range(mesh.world)] if lead else None
            for c0, c1 in _chunks(flat.numel()):
                piece = flat[c0:c1].contiguous()
                parts = [torch.empty_like(piece) for _ in range(mesh.world)] \
                    if lead else None
                dist.gather(piece, parts, dst=0)
                for blk, p in zip(blocks or [], parts or []):
                    blk[c0:c1].copy_(p)
            if lead:
                host = torch.empty(whole.shape, dtype=t.dtype)
                for r, blk in enumerate(blocks):
                    local_block(host, spec, mesh, r).copy_(blk.view(t.shape))
            out.append(host if lead else None)
        return T.unflatten_like(self.state, out) if lead else None

    def _restore_mesh(self) -> int:
        """Rank 0 reads the newest checkpoint and scatters each rank's
        block of every leaf to it; returns the round to start from."""
        mesh, K = self.mesh, self.n
        host = found = None
        if mesh.rank == 0:
            host = T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                              if torch.is_tensor(t) else t,
                              abstract_state(self.cfg, K))
            restored, meta = self.ckpt.restore_latest(host)
            found = (meta, host["step"]) if restored is not None else None
        found = mesh.broadcast(found)
        if found is None:
            return 0
        meta, self.state["step"] = found
        src = T.leaves(host) if mesh.rank == 0 else None
        for i, (t, _, spec) in enumerate(self._leaves()):
            if not torch.is_tensor(t):
                continue
            flat = t.view(-1)
            # contiguous: a block whose split dim is its last, of length 1
            # (a factor of kv heads split one a rank), flattens to a strided
            # view, and the collectives send from the data pointer
            blocks = [local_block(src[i], spec, mesh, r).contiguous()
                      .view(-1) for r in range(mesh.world)] if src else None
            for c0, c1 in _chunks(flat.numel()):
                piece = torch.empty_like(flat[c0:c1])
                parts = [b[c0:c1].to(t.device) for b in blocks] \
                    if blocks else None
                dist.scatter(piece, parts, src=0)
                flat[c0:c1].copy_(piece)
        return int(meta["step"])

    def _save(self, step: int, loss: float):
        state = self._gathered_state() if self.mesh is not None \
            else self.state
        if self.lead:
            self.ckpt.save(step, state, {"loss": loss})

    # ------------------------------------------------------------------
    def _schedule(self):
        if self.schedule_kind != "tree":
            return AggSchedule(self.schedule_kind, self.n)
        tree = self.coord.tree_of(self.sid)
        # clients keep their original bank row; dead rows ride zero-weighted
        index_of = {cid: int(cid[1:]) for cid in tree.client_order}
        return compile_tree(tree, axis_size=self.n, index_of=index_of)

    def _client(self) -> int:
        """This rank's client: its index on the client axis (0 where the
        whole mesh is one client)."""
        axis = client_axis_for(self.cfg, self.mesh)
        return self.mesh.coord(axis) if axis else 0

    def _step_for(self, schedule):
        key = schedule.signature()
        if key not in self._steps:
            self._steps[key] = build_fl_round_step(
                self.cfg, self.mesh or self.n, schedule, self.device,
                total_steps=self.rounds * self.cfg.fl.local_steps,
                strategy=self.strategy, update_filter=self.update_filter)
        return self._steps[key]

    def run(self) -> list[dict]:
        sid = self.sid if self.lead else None
        weights_np = np.array(
            [self.clients[f"c{i}"].stats.samples or 1.0
             for i in range(self.n)], np.float32) if self.lead else None
        self.weights = weights_np
        cuda = self.device.type == "cuda"
        mesh = self.mesh
        for r in range(self.start_round, self.rounds):
            t0 = time.perf_counter()
            with record_function("train/schedule"):
                schedule = n_alive = None
                if self.lead:
                    # failure injection -> LWT -> coordinator rearranges; the
                    # dead client's row gets zero FedAvg weight (sums
                    # unaffected)
                    for dead in self.failures.fail_at.get(r, []):
                        if dead in self.clients:
                            self.session.fail(dead)
                            weights_np[int(dead[1:])] = 0.0
                    schedule = self._schedule()
                    n_alive = len(self.clients)
                if mesh is not None:
                    schedule, self.weights, n_alive = mesh.broadcast(
                        (schedule, self.weights, n_alive))
                step = self._step_for(schedule)
            with record_function("train/batch"):
                # one client on this device (a rank, or K = 1): its own
                # batch, with no client dim, as its state has none
                who = self._client() if mesh is not None else (
                    0 if self.n == 1 else None)
                batch = self.data.global_batch(
                    self.n, self.batch_per_client, self.seq, r) \
                    if who is None else self.data.client_batch(
                        who, self.batch_per_client, self.seq, r)
            with record_function("train/step"):
                self.state, m = step(self.state, batch, self.weights)
            # a sync, not host work: the device's idle under this range is
            # its own, between kernels the step has already queued
            with record_function("train/wait"):
                loss = float(m["loss"])
            dt = time.perf_counter() - t0
            with record_function("train/round_end"):
                # device ms of the round's spans (aggregate, ref, the model
                # group's collectives), card only; on a mesh the most any
                # rank took, and its peak memory
                spans = span_ms(m["spans"])
                peak = torch.cuda.max_memory_allocated(self.device) \
                    if cuda else None
                rank_ms = spans
                if mesh is not None and cuda:
                    spans = {k: mesh.all_max(v) for k, v in spans.items()}
                    peak = int(mesh.all_max(peak))
                # the MoE layers' buffer rows and kept assignments (this
                # rank's)
                moe = {"moe_rows": m["moe_rows"],
                       "moe_kept": int(m["moe_kept"])} \
                    if "moe_rows" in m else {}
                tokens = self.n * self.batch_per_client * self.seq \
                    * self.cfg.fl.local_steps
                self.metrics.append({
                    "round": r, "loss": loss, "time_s": dt,
                    "tokens_per_s": tokens / dt,
                    "schedule": schedule.signature(),
                    "level_groups": schedule.level_groups,
                    "n_clients": n_alive, **spans, **moe,
                    "max_memory_allocated": peak,
                    **({"rank_ms": rank_ms} if mesh is not None else {})})
                if self.ckpt and self.ckpt.should_save(r + 1):
                    self._save(r + 1, loss)
                if self.on_round_end is not None:
                    self.on_round_end(r, self.state)
                if not self.lead:
                    continue
                # round-status updates: stats + readiness -> role
                # optimization
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
    ap.add_argument("--clients", type=int, default=None,
                    help="FL clients (default 4; one a rank with "
                         "--data-mesh, which sets it)")
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
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="the mesh's data axis, one client a row, rank r "
                         "on cuda:r (gloo with --device cpu); 0 keeps "
                         "every client on one device")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="the mesh's model axis: ranks a client, its "
                         "layers split over them (tensor and "
                         "expert parallelism); data x model ranks in all")
    ap.add_argument("--pod-mesh", type=int, default=0,
                    help="the mesh's pod axis, one client a pod: the "
                         "shared (FSDP) mode, each client's parameters "
                         "split over its --data-mesh ranks; pod x data x "
                         "model ranks in all (0: no pod axis, replica "
                         "mode)")
    args = ap.parse_args(argv)
    M, P = args.model_mesh, args.pod_mesh
    mesh_lib.check_axes(M, P)
    if args.data_mesh or M > 1 or P or mesh_lib.in_torchrun():
        per = M * max(P, 1)
        world = int(os.environ.get(
            "WORLD_SIZE",
            (args.data_mesh or (1 if P else args.clients or 1)) * per))
        data = world // per
        K = P or data
        if world % per or args.clients not in (None, K) or \
                args.data_mesh not in (0, data):
            raise ValueError(f"--clients {args.clients}, --pod-mesh {P}, "
                             f"--data-mesh {args.data_mesh} and --model-mesh "
                             f"{M} on {world} ranks: one client a row of "
                             "the data axis, or with pods one a pod")
        args.clients = K
        if mesh_lib.in_torchrun():
            mesh = mesh_lib.mesh_from_env(M, device=args.device, pods=P)
            _run(mesh, args)
            mesh.close()
        else:
            mesh_lib.spawn(_run, data, (args,), model=M, pods=P,
                           device=args.device)
        return
    args.clients = args.clients or 4
    _run(None, args)


def _config(args):
    """The CLI's architecture config: ``shared`` mode with a pod axis,
    ``replica`` mode otherwise."""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return cfg.replace(fl=cfg.fl.__class__(
        mode="shared" if getattr(args, "pod_mesh", 0) else "replica",
        local_steps=args.local_steps,
        aggregator_ratio=cfg.fl.aggregator_ratio, levels=cfg.fl.levels,
        schedule=args.schedule, role_policy=cfg.fl.role_policy))


def _run(mesh, args):
    """The CLI's trainer, on one device or as one rank; rank 0 prints."""
    cfg = _config(args)
    trainer = SDFLMQTrainer(cfg, args.clients, args.rounds,
                            args.batch_per_client, args.seq,
                            ckpt_dir=args.ckpt_dir,
                            schedule_kind=args.schedule,
                            strategy=args.strategy,
                            update_filter=args.update_filter,
                            device=args.device, mesh=mesh)
    metrics = trainer.run()
    if mesh is not None and mesh.rank:
        return
    for m in metrics:
        print(f"round {m['round']:3d} loss {m['loss']:.4f} "
              f"{m['time_s']:.2f}s sched={m['schedule']} "
              f"clients={m['n_clients']}")


if __name__ == "__main__":
    main()
