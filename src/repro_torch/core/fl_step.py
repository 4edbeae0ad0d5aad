"""The FL round step on one device — SDFLMQ's data plane.

One call = one federated round over all clients:
  1. per-client local training step(s),
  2. weighted aggregation (schedule from the coordinator's cluster tree via
     core/topology.py),
  3. implicit global broadcast (every client slot ends up with the
     identical global model).

The reference's ``jax.vmap`` over clients becomes a loop over k on views of
the client-stacked parameter bank: ``bank[leaf][k]`` is detached, takes its
gradient, and is updated in place under ``no_grad``.  Only one client's
activations and gradients are alive at a time, and no client's weights are
copied.  Client k owns index k of the bank; the coordinator's
``tree.client_order`` must be in the same order (launch/train.py keeps it).

``AdapterSpec`` and ``abstract_state`` wait for later slices.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregation import aggregate_params, check_strategy
from repro_torch.core.topology import AggSchedule
from repro_torch.device import resolve
from repro_torch.dist import sharding as shd
from repro_torch.models import model_api
from repro_torch.optim.api import apply_updates, make_optimizer


# --------------------------------------------------------------------------
# Partial updates: ParamFilter
# --------------------------------------------------------------------------

def leaf_path_names(tree):
    """'/'-joined key-path name for every leaf, in ``tree_flatten`` order."""
    return ["/".join(path) for path, _ in T.leaves_with_path(tree)]


@dataclass(frozen=True)
class ParamFilter:
    """Which parameter leaves are *trainable and shipped* in a federated
    round; everything else is the frozen base that never leaves the device.

    Patterns are ``fnmatch`` globs against the leaf's '/'-joined key path
    (e.g. ``"blocks/3/attn/wq"`` or a flat host-dict key).  A leaf is
    selected when it matches any ``include`` pattern and no ``exclude``
    pattern.  The string form accepted everywhere a knob is
    (``update_filter="*/lora_*,!*frozen*"``) separates patterns with commas
    and marks excludes with a leading ``!``.
    """
    include: tuple = ("*",)
    exclude: tuple = ()

    @staticmethod
    def parse(spec) -> Optional["ParamFilter"]:
        if spec is None or isinstance(spec, ParamFilter):
            return spec
        inc, exc = [], []
        for pat in str(spec).split(","):
            pat = pat.strip()
            if not pat:
                continue
            (exc if pat.startswith("!") else inc).append(pat.lstrip("!"))
        return ParamFilter(tuple(inc) or ("*",), tuple(exc))

    def matches(self, name: str) -> bool:
        if any(fnmatchcase(name, p) for p in self.exclude):
            return False
        return any(fnmatchcase(name, p) for p in self.include)

    def keep_list(self, tree):
        return [self.matches(n) for n in leaf_path_names(tree)]

    def mask(self, tree):
        """Same-structure tree of Python bools (True = trainable)."""
        return T.unflatten_like(tree, self.keep_list(tree))

    def extract(self, tree) -> dict:
        """Flat ``{path_name: leaf}`` of the selected leaves — the wire
        payload for a partial update."""
        out = {}
        for path, leaf in T.leaves_with_path(tree):
            name = "/".join(path)
            if self.matches(name):
                out[name] = leaf
        return out

    def merge(self, tree, update: dict):
        """Return ``tree`` with the leaves named in ``update`` replaced —
        the receive side of a partial update (frozen base kept local)."""
        new = [update.get("/".join(path), leaf)
               for path, leaf in T.leaves_with_path(tree)]
        return T.unflatten_like(tree, new)


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------

def fl_param_decls(cfg: ArchConfig, n_clients: int):
    decls = model_api.param_decls(cfg)
    if n_clients > 1:
        decls = shd.prepend_axis(decls, n_clients, "clients")
    return decls


def _frozen_mask(cfg: ArchConfig, update_filter):
    """Per-client tree of bools (True = frozen), or None when every leaf
    trains."""
    filt = ParamFilter.parse(update_filter)
    if filt is None:
        return None
    keep = filt.keep_list(model_api.param_decls(cfg))
    if all(keep):
        return None
    if not any(keep):
        raise ValueError(f"update_filter {update_filter!r} matches no parameter")
    return T.unflatten_like(model_api.param_decls(cfg), [not k for k in keep])


def init_opt_state(opt, params, n_clients: int):
    """Optimizer state for the client-stacked bank: each client's own
    slot's state, stacked on a leading client axis, as the reference vmaps
    ``opt.init`` over clients.  So Adafactor factors each client's leaf (a
    client's (D,) norm keeps a full ``v``), not the (K, ...) bank.  The
    structure comes from ``opt.init`` on the meta device; every
    optimizer's state starts at zeros."""
    if n_clients == 1:
        return opt.init(params)
    one = opt.init(T.tree_map(lambda t: torch.empty(
        t.shape[1:], dtype=t.dtype, device="meta"), params))
    dev = T.leaves(params)[0].device
    return T.tree_map(lambda s: torch.zeros(
        (n_clients,) + tuple(s.shape), dtype=s.dtype, device=dev), one)


def init_state(cfg: ArchConfig, n_clients: int, seed: int = 0,
               device="cuda", total_steps: int = 10000, update_filter=None):
    """Concrete train state on ``device``: the client-stacked parameter bank
    (each client drawn independently, as the reference does), each
    client's optimizer state (``init_opt_state``), and the step count.

    With ``update_filter`` set, frozen (non-matching) leaves are broadcast
    from client 0 so every client starts from the SAME frozen base."""
    dev = resolve(device)
    opt = make_optimizer(cfg, total_steps=total_steps)
    params = shd.materialize(fl_param_decls(cfg, n_clients), seed, dev)
    frozen = _frozen_mask(cfg, update_filter)
    if frozen is not None and n_clients > 1:
        for p, f in zip(T.leaves(params), T.leaves(frozen)):
            if f:
                p.copy_(p[0:1].expand_as(p))
    return {"params": params, "opt": init_opt_state(opt, params, n_clients),
            "step": 0}


# --------------------------------------------------------------------------
# Step builders
# --------------------------------------------------------------------------

def _make_client_fn(cfg: ArchConfig, opt, local_steps: int, frozen_mask=None):
    """One client's local training loop (E optimizer steps) on its slot of
    the bank.  ``params_c``/``opt_c`` are trees of tensors (views into the
    bank and the moments) and are updated in place.

    ``frozen_mask`` (same structure as params, bool leaves, True = frozen)
    turns on partial updates: frozen leaves get zero gradients and are
    restored bit-exactly after the loop, so weight decay / momentum cannot
    drift the base the client never ships."""
    frozen = T.leaves(frozen_mask) if frozen_mask is not None else None

    def local_step(params, opt_state, step, batch):
        with record_function("fl/forward_backward"):
            leaves = T.leaves(params)
            live = [p.detach().requires_grad_(not (frozen and frozen[i]))
                    for i, p in enumerate(leaves)]
            loss, _ = model_api.loss_fn(cfg, T.unflatten_like(params, live),
                                        batch)
            trainable = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(loss, trainable))
            grads = [next(got) if p.requires_grad else torch.zeros_like(p)
                     for p in live]
            del live, trainable, got
        with record_function("fl/optimizer"):
            updates, opt_state = opt.update(T.unflatten_like(params, grads),
                                            opt_state, params, step)
            del grads
            apply_updates(params, updates)
        return loss.detach()

    def client_fn(params_c, opt_c, step, batch_c):
        """-> the last step's loss; params_c/opt_c are updated in place."""
        base = None
        if frozen is not None:
            base = [p.clone() if f else None
                    for p, f in zip(T.leaves(params_c), frozen)]
        loss = None
        for _ in range(local_steps):
            loss = local_step(params_c, opt_c, step, batch_c)
            step = step + 1
        if base is not None:
            with torch.no_grad():
                for p, b in zip(T.leaves(params_c), base):
                    if b is not None:
                        p.copy_(b)
        return loss

    return client_fn


def _slot(tree, k: int):
    return T.tree_map(lambda x: x[k], tree)


def _local_round(client_fn, state, batch, n: int):
    """Every client's local steps, one after another on its slot of the
    bank (the reference vmaps them) -> mean loss over clients."""
    if n == 1:
        return client_fn(state["params"], state["opt"], state["step"], batch)
    losses = [client_fn(_slot(state["params"], k), _slot(state["opt"], k),
                        state["step"], _slot(batch, k)) for k in range(n)]
    return torch.stack(losses).mean()


def _on(x, dev, dtype=None):
    """numpy array or tensor -> tensor on ``dev``."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=dev, dtype=dtype)


def _to_device(batch, dev):
    return {key: _on(val, dev) for key, val in batch.items()}


def init_cohort_state(cfg: ArchConfig, n_cohort: int, seed: int = 0,
                      device="cuda", total_steps: int = 10000):
    """Struct-of-arrays bank for a host-path cohort: every parameter leaf
    gets a leading ``(n_cohort,)`` member axis and the optimizer state
    matches — no mesh, no per-member trees."""
    return init_state(cfg, n_cohort, seed, device, total_steps)


def build_cohort_local_step(cfg: ArchConfig, n_cohort: int,
                            total_steps: int = 10000,
                            local_steps: Optional[int] = None):
    """Host-path cohort data plane: trains all ``n_cohort`` members on
    their slots of the bank (no aggregation).

    Returns ``cohort_local_step(state, batch) -> (state, metrics)`` where
    every leaf of ``state["params"]``/``state["opt"]`` and ``batch`` is
    member-stacked (leading dim ``n_cohort``) when ``n_cohort > 1``."""
    opt = make_optimizer(cfg, total_steps=total_steps)
    E = local_steps if local_steps is not None else cfg.fl.local_steps
    client_fn = _make_client_fn(cfg, opt, E)

    def cohort_local_step(state, batch):
        dev = T.leaves(state["params"])[0].device
        loss = _local_round(client_fn, state, _to_device(batch, dev), n_cohort)
        state["step"] = state["step"] + E
        return state, {"loss": loss}

    return cohort_local_step


def pre_round_ref(bank):
    """The pre-round model that a ``needs_ref`` strategy premaps against,
    taken before the local steps update the bank in place.

    After any aggregation every client slot holds the same global, and the
    ref is one slot on the bank's device (leading dim 1).  Otherwise (round
    0: ``init_state`` draws each client independently) each client premaps
    against its own pre-round slot, as the reference does, and the ref is
    a copy of the whole bank on the host (pinned when the bank is on a
    card), brought back chunk by chunk during the aggregation."""
    leaves = T.leaves(bank)
    if all(torch.equal(t[k], t[0]) for t in leaves
           for k in range(1, t.shape[0])):
        return T.tree_map(lambda t: t[0:1].clone(), bank)

    def host(t):
        out = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=t.device.type == "cuda")
        return out.copy_(t)
    return T.tree_map(host, bank)


@contextmanager
def _span(spans: dict, name: str, dev: torch.device):
    """On the card, records a CUDA event pair around the block into
    ``spans[name]``: the block's device time, read once the round has been
    waited for, at no synchronization of its own."""
    if dev.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    spans[name] = (start, end)


def build_fl_round_step(cfg: ArchConfig, n_clients: int,
                        schedule: AggSchedule, device="cuda",
                        total_steps: int = 10000,
                        local_steps: Optional[int] = None,
                        strategy: str = "fedavg",
                        update_filter=None):
    """Returns fl_round_step(state, batch, weights) -> (state, metrics).

    batch: client-stacked when n_clients>1 (leading dim = clients), numpy
    or tensors; weights: (n_clients,) FedAvg weights (sample counts).
    ``state`` is updated in place and returned.  ``strategy`` is any
    ported aggregation strategy name (repro_torch.api.strategies).

    ``update_filter`` (ParamFilter or its comma string form) switches on
    partial updates: only matching leaves are trained and aggregated.

    A ``needs_ref`` strategy (fedprox, norm_clip, ...) premaps each client
    against the pre-round parameters, as the reference passes them
    (``pre_round_ref``)."""
    strat = check_strategy(strategy)
    dev = resolve(device)
    opt = make_optimizer(cfg, total_steps=total_steps)
    E = local_steps if local_steps is not None else cfg.fl.local_steps
    frozen_mask = _frozen_mask(cfg, update_filter)
    client_fn = _make_client_fn(cfg, opt, E, frozen_mask=frozen_mask)

    def _trainable(params):
        """The aggregated leaves: all, or under ``update_filter`` only the
        trainable ones (frozen leaves keep the post-restore client values,
        which equal the pre-round state)."""
        if frozen_mask is None:
            return params
        return {str(i): p for i, (p, f) in enumerate(
            zip(T.leaves(params), T.leaves(frozen_mask))) if not f}

    def fl_round_step(state, batch, weights):
        spans = {}           # name -> (start, end) CUDA events, card only
        ref = None
        if n_clients > 1 and strat.needs_ref:
            with record_function("fl/ref"), _span(spans, "ref", dev):
                ref = pre_round_ref(_trainable(state["params"]))
        loss = _local_round(client_fn, state, _to_device(batch, dev), n_clients)
        if n_clients > 1:
            with record_function("fl/aggregate"), \
                    _span(spans, "aggregate", dev):
                aggregate_params(_trainable(state["params"]),
                                 _on(weights, dev, torch.float32), schedule,
                                 strat, ref=ref)
        state["step"] = state["step"] + E
        return state, {"loss": loss, "spans": spans}

    return fl_round_step

