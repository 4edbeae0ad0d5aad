"""One run of one cell: set-up, the measured window, an optional profiled
stretch, and the comparison with the plain reference.

The system under test is the port's trainer, ``SDFLMQTrainer``, driven
through its own round loop (``run``): each round the control plane's
schedule, the data layer's batch, one round step (every client's local
step, the optimizer, the aggregation) and the round-status updates.
Rounds run back to back, a closed loop.  The harness reaches into the loop
at one point only: the trainer's failure schedule, which it looks up at
the start of every round, is a ``Clock`` that fails no client and ends the
loop at a given round or once the window's time is up.  So the window
holds whole rounds, status updates included, and ends in a synchronize.

Set-up makes the trainer, writes each client's weights from the seed
(``weights.py``), and runs the rounds the comparison reads; they warm up
every shape the window runs.  The learning-rate schedule's horizon is the
traffic's ``lr_horizon_rounds``, whatever the window's length: in the
window the loop has no bound but the clock, and a step that the loop
rebuilds for a new schedule still takes that horizon (``unbounded``).

The comparison reads, from the rounds of the set-up, which go through the
window's own call and feed: the inputs the round step received, each
round's mean loss, each client's first gradient as its optimizer state
holds it after one step, the global model every slot holds after round 0
(leaf by leaf, against the reference's rounded to the leaf's dtype), and
its change from then to the last round read.  The reference works all
of them out again from the seed once the window has closed and the
trainer is freed (``reference/fl.py``).
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np

from fedbench import weights as W
from fedbench.cells import Cell
from fedbench.reference import fl as ref_fl

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
ADAMW_B1 = 0.9            # AdamW's m after one step is (1 - b1) * g
ADAFACTOR_EPS = 1e-30     # Adafactor's factors after one step: mean(g^2 + eps)
MOVED = 1e-3              # a leaf moves where its gradient is this share
                          # of the median leaf's, or more
CHUNK = 1 << 26
CHECK_ROUNDS = 3          # rounds of the set-up that the comparison reads
PROFILE_ROUNDS = 3        # rounds profiled after the window, --trace 1


# --------------------------------------------------------------------------
# the configuration as the trainer runs it
# --------------------------------------------------------------------------

FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "num_hidden_layers": "n_layers", "vocab_size": "vocab",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "qkv_bias": "qkv_bias", "sliding_window": "window",
          "tie_word_embeddings": "tie_embeddings",
          "optimizer": "optimizer", "param_dtype": "param_dtype",
          "remat": "remat"}
MOE_FIELDS = {"num_local_experts": "n_experts",
              "num_experts_per_tok": "top_k",
              "intermediate_size": "d_ff_expert",
              "capacity_factor": "capacity_factor",
              "router_aux_loss_coef": "aux_coef"}


def port_config(sizes: dict, traffic: dict):
    """The trainer's ``ArchConfig``: the port's registered architecture
    with every size of the configuration file put in."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    cfg = get_arch(sizes["port_arch"])
    kw = {f: sizes[k] for k, f in FIELDS.items() if k in sizes}
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, **{f: sizes[k] for k, f in MOE_FIELDS.items()
                        if k in sizes})
    kw["fl"] = cfg.fl.__class__(
        mode=sizes["fl_mode"], local_steps=traffic["local_steps"],
        aggregator_ratio=cfg.fl.aggregator_ratio, levels=cfg.fl.levels,
        schedule=traffic["schedule"], role_policy=cfg.fl.role_policy)
    return cfg.replace(**kw)


def flat(tree, prefix="") -> dict:
    """{'/'-joined path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# --------------------------------------------------------------------------
# driving the trainer's loop
# --------------------------------------------------------------------------

class _Stop(Exception):
    pass


class Clock(dict):
    """The trainer's failure schedule (round -> clients that fail), in
    which no client fails.  Its lookup at the start of each round ends the
    loop at ``stop_round``, or once ``deadline`` (``time.perf_counter``)
    has passed, after a synchronize; ``t_stop`` and ``stopped_at`` are
    then the time and the round."""

    def __init__(self, sync):
        super().__init__()
        self.sync = sync
        self.stop_round = self.deadline = None
        self.t_stop = self.stopped_at = None

    def get(self, r, default=None):
        if (self.stop_round is not None and r >= self.stop_round) or (
                self.deadline is not None
                and time.perf_counter() >= self.deadline):
            self.sync()
            self.t_stop, self.stopped_at = time.perf_counter(), r
            raise _Stop
        return super().get(r, default)


def unbounded(trainer) -> None:
    """Lets the trainer's loop run until the clock ends it, while every
    round step it builds keeps the learning-rate horizon the trainer was
    made with (the trainer reads both from ``rounds``)."""
    horizon, build = trainer.rounds, trainer._step_for

    def step_for(schedule):
        bound, trainer.rounds = trainer.rounds, horizon
        try:
            return build(schedule)
        finally:
            trainer.rounds = bound
    trainer._step_for = step_for
    trainer.rounds = sys.maxsize


def drive(trainer, clock: Clock, start: int, stop_round=None,
          deadline=None) -> int:
    """Runs the trainer's loop from round ``start`` until the clock ends
    it -> the round it ended at."""
    clock.stop_round, clock.deadline = stop_round, deadline
    trainer.start_round = start
    try:
        trainer.run()
    except _Stop:
        return clock.stopped_at
    raise RuntimeError(f"the trainer's loop ran out at round "
                       f"{trainer.rounds} before the clock ended it")


# --------------------------------------------------------------------------
# the program's readings
# --------------------------------------------------------------------------

def _sq_norm(t, other=None) -> float:
    """Squared L2 norm of ``t`` (minus ``other``), in f32 a chunk at a
    time, summed in double."""
    a = t.reshape(-1)
    b = None if other is None else other.reshape(-1)
    total = 0.0
    for c0 in range(0, a.numel(), CHUNK):
        x = a[c0:c0 + CHUNK].float()
        if b is not None:
            x = x - b[c0:c0 + CHUNK].to(x.device).float()
        total += float(x.square().sum())
    return total


def grad_norms_from_state(opt: dict, optimizer: str, n_clients: int):
    """Each client's first gradient norm per leaf, from its optimizer
    state after one step."""
    out = [dict() for _ in range(n_clients)]
    if optimizer == "adamw":
        for path, m in flat(opt["m"]).items():
            for k in range(n_clients):
                out[k][path] = math.sqrt(_sq_norm(m[k])) / (1 - ADAMW_B1)
        return out
    for path, f in flat(opt["f"], "").items():
        leaf, kind = path.rsplit("/", 1)
        if kind == "vc":
            continue
        for k in range(n_clients):
            s = f[k].double()
            if kind == "vr":           # mean over the last dim of g^2 + eps
                n = s.numel() * _last_dim(opt, leaf)
                sq = float(s.sum()) * _last_dim(opt, leaf)
            else:
                n, sq = s.numel(), float(s.sum())
            out[k][leaf] = math.sqrt(max(sq - ADAFACTOR_EPS * n, 0.0))
    return out


def _last_dim(opt: dict, leaf: str) -> int:
    return flat(opt["f"])[leaf + "/vc"].shape[-1]


class Readings:
    """The program's readings of the rounds the comparison reads, taken
    through ``on_round_end`` and the step the loop calls."""

    def __init__(self, trainer, sizes: dict, rounds: int):
        self.trainer, self.sizes, self.rounds = trainer, sizes, rounds
        self.inputs, self.slots_differ = [], 0
        self.grad_norms = self.p1 = self.change_norms = None

    def attach(self):
        self._step_for = self.trainer._step_for
        self.trainer._step_for = self._recording
        self.trainer.on_round_end = self._on_round_end

    def detach(self):
        """Gives the trainer back its own ``_step_for`` and drops every
        reference to it, so that freeing it frees its state."""
        del self.trainer._step_for          # the class's method again
        self.trainer.on_round_end = None
        self._losses = [m["loss"] for m in self.trainer.metrics[:self.rounds]]
        self.trainer = self._step_for = None

    def _recording(self, schedule):
        step = self._step_for(schedule)

        def recorded(state, batch, weights):
            self.inputs.append(({k: np.array(v) for k, v in batch.items()},
                                np.array(weights, np.float32)))
            return step(state, batch, weights)
        return recorded

    def _on_round_end(self, r, state):
        import torch
        bank = flat(state["params"])
        K = self.sizes["clients"]
        with torch.no_grad():
            self.slots_differ += sum(
                1 for t in bank.values() for k in range(1, K)
                if not torch.equal(t[k], t[0]))
            if r == 0:
                self.grad_norms = grad_norms_from_state(
                    state["opt"], self.sizes["optimizer"], K)
                self.p1 = {p: t[0].to("cpu", copy=True)
                           for p, t in bank.items()}
            if r == self.rounds - 1:
                self.change_norms = {
                    p: math.sqrt(_sq_norm(t[0], self.p1[p]))
                    for p, t in bank.items()}

    def losses(self):
        return self._losses


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(r, floor, 1e-30)


def _gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: gap of the norms}, each against the reference's norm or the
    median leaf's, whichever is larger."""
    med = float(np.median([ref[n] for n in ref]))
    return {n: _gap(prog[n], ref[n], med) for n in leaves}


def model_gaps(prog: dict, ref: dict, device) -> dict:
    """{leaf: the norm of the program's model minus the reference's,
    rounded to the program's dtype}, each against the reference's norm
    or the median leaf's, whichever is larger.  Both on the host; the
    sums are taken on ``device`` a chunk at a time."""
    diff, norm = {}, {}
    for n, a in prog.items():
        b = ref[n].reshape(-1)
        a = a.reshape(-1)
        d = q = 0.0
        for c0 in range(0, a.numel(), CHUNK):
            y = b[c0:c0 + CHUNK].to(device)
            x = a[c0:c0 + CHUNK].to(device).float()
            d += float((x - y.to(a.dtype).float()).square().sum())
            q += float(y.square().sum())
        diff[n], norm[n] = math.sqrt(d), math.sqrt(q)
    med = float(np.median(list(norm.values())))
    return {n: diff[n] / max(norm[n], med, 1e-30) for n in diff}


def leaf_gaps(prog, ref: dict, device) -> dict:
    """Per leaf, the gaps of the first gradients (the worst client), of
    the global model after round 0 (``model_gaps``), and of its change to
    the last round read, this last over the leaves that move: those whose
    reference gradient is at least ``MOVED`` of the median leaf's."""
    grad, each = {}, []
    for gp, gr in zip(prog.grad_norms, ref["grad_norms"]):
        for n, v in _gaps(gp, gr, gr).items():
            grad[n] = max(grad.get(n, 0.0), v)
            each.append(v)
    top = {n: max(g[n] for g in ref["grad_norms"]) for n in ref["p1"]}
    floor = MOVED * float(np.median(list(top.values())))
    moved = [n for n, v in top.items() if v >= floor]
    return {"grad": grad, "grad_each": each,
            "agg": model_gaps(prog.p1, ref["p1"], device),
            "change": _gaps(prog.change_norms, ref["change_norms"], moved)}


def compare(prog, ref: dict, device, gaps=None) -> dict:
    """The numbers a cell's limits may hold: exact counts of inputs and of
    slots that differ, the worst relative gap of a round's loss and the
    gap of round 0's (steadier: the bf16 rounding of the later rounds is
    not in it), the worst leaf's gap of each of ``leaf_gaps``, and the
    median over leaves of the first gradient's gap (and over clients) and
    of the change's: steadier readings where one leaf swings, as a
    router's gradient does with discrete choices, or an embedding's
    change with the sub-ulp updates that bf16 storage drops."""
    diff = 0
    for r, (batch, w) in enumerate(prog.inputs[:prog.rounds]):
        for k, want in enumerate(ref["inputs"]["batches"][r]):
            for key in ("tokens", "labels"):
                got = batch[key][k] if batch[key].ndim == 3 else batch[key]
                diff += int((got != want[key]).sum())
        diff += int((w != ref["inputs"]["weights"]).sum())
    diff += max(prog.rounds - len(prog.inputs), 0)
    losses = prog.losses()
    gaps = gaps or leaf_gaps(prog, ref, device)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])]
    return {
        "inputs_differ": float(diff),
        "slots_differ": float(prog.slots_differ),
        "loss_gap": max(loss),
        "loss0_gap": loss[0],
        "grad_gap": max(gaps["grad"].values()),
        "grad_gap_median": float(np.median(gaps["grad_each"])),
        "agg_gap": max(gaps["agg"].values()),
        "change_gap": max(gaps["change"].values()),
        "change_gap_median": float(np.median(list(gaps["change"].values()))),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number the cell's limits name, beside its limit."""
    checks = {n: {"value": numbers[n], "limit": lim["limit"]}
              for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def program_setup(cell: Cell, sizes: dict, seed: int, device):
    """-> (trainer, clock, readings) after the rounds the comparison reads."""
    import torch

    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch.train import SDFLMQTrainer
    tr_ = cell.traffic
    cuda = torch.device(device).type == "cuda"
    clock = Clock(torch.cuda.synchronize if cuda else (lambda: None))
    trainer = SDFLMQTrainer(
        port_config(sizes, tr_), sizes["clients"], tr_["lr_horizon_rounds"],
        tr_["batch_per_client"], tr_["seq_len"],
        schedule_kind=tr_["schedule"], seed=seed,
        failure_plan=FailurePlan(fail_at=clock), strategy=tr_["strategy"],
        device=device)
    W.load_into(flat(trainer.state["params"]), sizes, seed, sizes["clients"])
    readings = Readings(trainer, sizes, CHECK_ROUNDS)
    readings.attach()
    drive(trainer, clock, 0, stop_round=CHECK_ROUNDS)
    readings.detach()
    return trainer, clock, readings


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, sizes: dict | None = None) -> dict:
    """One run -> the result line's dict, with ``extra`` (diagnostics for
    standard error) beside it.  ``sizes`` overrides the configuration
    (the tests' small shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fedbench.trace import Trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = sizes or cell.config
    tr_ = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trainer, clock, readings = program_setup(cell, sizes, seed, dev)
    R = CHECK_ROUNDS

    # the window
    unbounded(trainer)
    clock.sync()
    t0 = time.perf_counter()
    end = drive(trainer, clock, R, deadline=t0 + seconds)
    window_s = clock.t_stop - t0
    window_rounds = trainer.metrics[R:end]
    tokens = sizes["clients"] * tr_["batch_per_client"] * tr_["seq_len"] \
        * tr_["local_steps"] * len(window_rounds)

    prof_trace = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function("fedbench/profiled"):
                drive(trainer, clock, end,
                      stop_round=end + PROFILE_ROUNDS)
        prof_trace = Trace.from_profiler(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sigs = [m["schedule"] for m in trainer.metrics]
    rebuilds = sum(a != b for a, b in zip(sigs, sigs[1:]))
    window_losses = [m["loss"] for m in window_rounds]

    ctx = Context(sizes=sizes, traffic=tr_, chips=cell.chips,
                  window_s=window_s, tokens=tokens,
                  setup_s=t0 - t_process, peak_bytes=peak,
                  window_rounds=window_rounds, trace=prof_trace,
                  profiled_rounds=PROFILE_ROUNDS)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.reader(m)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the reference, once the trainer is gone
    trainer_metrics = trainer.metrics
    del trainer, window_rounds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ref_fl.run(sizes, tr_, seed, dev, CHECK_ROUNDS)
    gaps = leaf_gaps(readings, ref, dev)
    numbers = compare(readings, ref, dev, gaps)
    ref_s = time.perf_counter() - t_ref
    correct, checks = judge(numbers, cell.limits)
    worst = {k: max(v.items(), key=lambda x: x[1])[0]
             for k, v in gaps.items()
             if isinstance(v, dict) and v}

    out = {"correct": correct, "attempted": len(window_losses),
           "failed": sum(not math.isfinite(x) for x in window_losses),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if prof_trace is not None:
        out["device"]["busy_s"] = prof_trace.busy_s()
        out["device"]["window_s"] = prof_trace.window_s()
        out["breakdown"] = prof_trace.breakdown()
    out["extra"] = {"window_rounds": len(window_losses),
                    "round_s": [m["time_s"] for m in trainer_metrics[R:end]],
                    "window_s": window_s, "schedule_changes": rebuilds,
                    "losses": readings.losses(), "ref_losses": ref["loss"],
                    "ref_dropped": ref["dropped"], "ref_s": ref_s,
                    "worst_leaves": worst}
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
