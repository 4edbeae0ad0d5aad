"""The FL round step, on one device or one rank of a client mesh —
SDFLMQ's data plane.

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

On a mesh (``launch.mesh``: a (pod, data, model) grid of
``torch.distributed`` ranks, the reference's mesh axes), each rank holds
its block of the bank: its client's slot (leading dim 1, where K > 1) and
its part of every dim the specs put on a mesh axis
(``sharding.local_block``), with the optimizer state of that block.  The
client axis is ``data`` in ``replica`` mode and ``pod`` in ``shared`` mode
(``client_axis_for``; without a pod axis the whole mesh is one client).
The round trains the client tensor-parallel over its M ranks
(``dist.tensor_parallel``: the dense and MoE families, under any
optimizer; Adafactor's factor means and RMS clip over a split dim sum over
the model group) and, in ``shared`` mode, fully sharded over its D data
ranks (``dist.fsdp``: each rank takes its rows of the client's batch where
the batch divides D, and the same sums run over the data group), averages
the loss over the client axis with one ``all_reduce``, and aggregates each
rank's block across the client axis
(``aggregation.aggregate_params(..., mesh=, axis=)``).  The spec
functions (``param_specs``, ``state_specs``, ...) are the reference's, as
tuples of mesh-axis names; ``abstract_state`` builds a state on the meta
device.

``AdapterSpec`` is the reference's LoRA adapter recipe (declarations, the
filter that trains and ships only the adapters, and the fold into the
base), and ``build_eval_step`` its evaluation step (the cross-entropy of
``model_api.loss_fn``); as in the reference, neither is wired into the
round step.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregation import aggregate_params, check_strategy
from repro_torch.core.topology import AggSchedule
from repro_torch.device import resolve
from repro_torch.dist import fsdp
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.models import inputs, model_api
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


@dataclass(frozen=True)
class AdapterSpec:
    """LoRA-style adapter recipe: every 2-D weight whose path matches
    ``match`` gets a rank-``rank`` adapter pair ``<name>/lora_A`` (fan-in
    init) and ``<name>/lora_B`` (zeros: adapters start as the identity).
    A leaf stacked over layers is 3-D or more and gets none.  ``filter()``
    is the matching ParamFilter, so only adapter tensors are trained and
    shipped while the frozen base stays local."""
    rank: int = 8
    alpha: float = 16.0
    match: tuple = ("*",)

    def _adapts(self, name: str, d) -> bool:
        return (len(d.shape) == 2
                and any(fnmatchcase(name, p) for p in self.match))

    def adapter_decls(self, decls) -> dict:
        """Flat decl dict for the adapter bank of a base decl tree:
        ``lora_A`` (din, rank) on (the weight's first axis, None), ``lora_B``
        (rank, dout) on (None, its second), both f32."""
        out = {}
        for path, d in T.leaves_with_path(decls):
            name = "/".join(path)
            if self._adapts(name, d):
                din, dout = d.shape
                out[f"{name}/lora_A"] = shd.decl(
                    (din, self.rank), (d.axes[0], None),
                    init="normal", dtype=torch.float32)
                out[f"{name}/lora_B"] = shd.decl(
                    (self.rank, dout), (None, d.axes[1]),
                    init="zeros", dtype=torch.float32)
        return out

    def filter(self) -> ParamFilter:
        return ParamFilter(include=("*/lora_A", "*/lora_B"))

    def apply(self, params, adapters: dict):
        """Fold the adapter bank into the base: W <- W + (alpha/r) A @ B
        for every adapted weight, in f32, cast back to W's dtype (a plain
        product, as the reference computes it outside any kernel).  A new
        tree; the others are ``params``' own leaves."""
        scale = self.alpha / float(self.rank)
        leaves = []
        for path, leaf in T.leaves_with_path(params):
            name = "/".join(path)
            a = adapters.get(f"{name}/lora_A")
            b = adapters.get(f"{name}/lora_B")
            if a is not None and b is not None:
                delta = a.float() @ b.float()
                leaf = (leaf.float() + scale * delta).to(leaf.dtype)
            leaves.append(leaf)
        return T.unflatten_like(params, leaves)


# --------------------------------------------------------------------------
# Meshes and specs
# --------------------------------------------------------------------------

def _is_count(n) -> bool:
    return isinstance(n, (int, np.integer))


def client_axis_for(cfg: ArchConfig, mesh) -> Optional[str]:
    ax = "data" if cfg.fl.mode == "replica" else "pod"
    return ax if ax in shd.mesh_shape(mesh) else None


def n_clients_for(cfg: ArchConfig, mesh) -> int:
    ax = client_axis_for(cfg, mesh)
    return int(shd.mesh_shape(mesh)[ax]) if ax else 1


def fl_param_decls(cfg: ArchConfig, n_clients: int):
    decls = model_api.param_decls(cfg)
    if n_clients > 1:
        decls = shd.prepend_axis(decls, n_clients, "clients")
    return decls


def fl_rules(cfg: ArchConfig, client_axis: Optional[str]):
    rules = shd.rules_for(cfg.fl.mode)
    rules["clients"] = client_axis
    return rules


def param_specs(cfg: ArchConfig, mesh):
    n = n_clients_for(cfg, mesh)
    return shd.specs_for(fl_param_decls(cfg, n),
                         fl_rules(cfg, client_axis_for(cfg, mesh)), mesh)


def opt_state_specs(cfg: ArchConfig, mesh, opt_name: str):
    """The optimizer state's specs; Adafactor factors each client's leaf,
    so its row and column factors take the spec of the per-client dims."""
    pspecs = param_specs(cfg, mesh)
    if opt_name == "sgdm":
        return {"mu": pspecs}
    if opt_name == "adamw":
        return {"m": pspecs, "v": pspecs}
    n = n_clients_for(cfg, mesh)
    lead = 1 if n > 1 else 0

    def f(d, s):
        parts = list(s) + [None] * (len(d.shape) - len(s))
        if len(d.shape) - lead >= 2:
            return {"vr": tuple(parts[:-1]),
                    "vc": tuple(parts[:-2] + [parts[-1]])}
        return {"v": tuple(parts)}
    return {"f": T.tree_map(f, fl_param_decls(cfg, n), pspecs)}


def state_specs(cfg: ArchConfig, mesh, opt_name: str):
    return {"params": param_specs(cfg, mesh),
            "opt": opt_state_specs(cfg, mesh, opt_name), "step": ()}


def abstract_state(cfg: ArchConfig, mesh):
    """A train state as meta tensors: shapes and dtypes, no storage.  For
    a client count or a mesh shape (a dict), the whole state (every
    client's slot), which ``state_specs`` splits; for a
    ``launch.mesh.Mesh``, this rank's: its block of every leaf
    (``sharding.local_block``) and that block's optimizer state."""
    n = mesh if _is_count(mesh) else n_clients_for(cfg, mesh)
    params = T.tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                              device="meta"),
                        fl_param_decls(cfg, n))
    opt = make_optimizer(cfg)
    if _is_count(mesh) or isinstance(mesh, dict):
        return {"params": params, "opt": init_opt_state(opt, params, n),
                "step": 0}
    params = T.tree_map(lambda t, s: torch.empty(
        shd.local_block(t, s, mesh).shape, dtype=t.dtype, device="meta"),
        params, param_specs(cfg, mesh))
    return {"params": params, "opt": (_per_client_opt_state(opt, params)
                                      if n > 1 else opt.init(params)),
            "step": 0}


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------


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
    return _per_client_opt_state(opt, params)


def _per_client_opt_state(opt, params):
    """Each client's own state, stacked on the leading client axis of
    ``params`` (K clients, or a rank's one slot)."""
    one = opt.init(T.tree_map(lambda t: torch.empty(
        t.shape[1:], dtype=t.dtype, device="meta"), params))
    lead = T.leaves(params)[0].shape[0]
    dev = T.leaves(params)[0].device
    return T.tree_map(lambda s: torch.zeros(
        (lead,) + tuple(s.shape), dtype=s.dtype, device=dev), one)


def init_state(cfg: ArchConfig, n_clients, seed: int = 0,
               device="cuda", total_steps: int = 10000, update_filter=None):
    """Concrete train state on ``device``: the client-stacked parameter bank
    (each client drawn independently, as the reference does), each
    client's optimizer state (``init_opt_state``), and the step count.

    With ``update_filter`` set, frozen (non-matching) leaves are broadcast
    from client 0 so every client starts from the SAME frozen base.

    ``n_clients`` may be a mesh (``launch.mesh.Mesh``): then the state is
    this rank's on the mesh's device, its block of the bank that
    ``init_state(cfg, K, seed)`` draws (its client's slot, leading dim 1
    when K > 1, and its part of each dim on the ``model`` axis; each leaf
    drawn whole and the block kept) and that block's optimizer state."""
    opt = make_optimizer(cfg, total_steps=total_steps)
    frozen = _frozen_mask(cfg, update_filter)
    if not _is_count(n_clients):
        return _init_rank_state(cfg, n_clients, seed, opt, frozen)
    dev = resolve(device)
    params = shd.materialize(fl_param_decls(cfg, n_clients), seed, dev)
    if frozen is not None and n_clients > 1:
        for p, f in zip(T.leaves(params), T.leaves(frozen)):
            if f:
                p.copy_(p[0:1].expand_as(p))
    return {"params": params, "opt": init_opt_state(opt, params, n_clients),
            "step": 0}


def client_specs(cfg: ArchConfig, mesh):
    """Per leaf of one client's parameters, its spec without the client
    dim: which dim each mesh axis splits inside a client."""
    lead = 1 if n_clients_for(cfg, mesh) > 1 else 0
    return T.tree_map(lambda s: tuple(s[lead:]), param_specs(cfg, mesh))


def split_dims(cfg: ArchConfig, mesh, axis: str):
    """Per leaf of one client's parameters (no client dim), the dims its
    spec puts on ``axis`` (``"model"`` or ``"data"``): what Adafactor's
    reductions over that axis span."""
    return T.tree_map(lambda s: tuple(i for i, ax in enumerate(s)
                                      if ax == axis),
                      client_specs(cfg, mesh))


def data_axis_for(cfg: ArchConfig, mesh) -> Optional[fsdp.DataAxis]:
    """The client's data axis of ``mesh`` in ``shared`` mode (FSDP over
    its D ranks), or None (``replica`` mode, or a data axis of 1)."""
    if cfg.fl.mode != "shared" or mesh.shape["data"] == 1:
        return None
    return fsdp.DataAxis(mesh.group("data"), mesh.shape["data"],
                         mesh.coord("data"),
                         fsdp.data_dims(client_specs(cfg, mesh)))


def _init_rank_state(cfg: ArchConfig, mesh, seed: int, opt, frozen):
    n = n_clients_for(cfg, mesh)
    specs = T.leaves(param_specs(cfg, mesh))
    fro = T.leaves(frozen) if frozen is not None and n > 1 else None

    def block(i, x):    # a frozen leaf: every client's rank takes slot 0
        if fro and fro[i]:
            return shd.local_block(x[0:1], (None,) + specs[i][1:], mesh)
        return shd.local_block(x, specs[i], mesh)
    params = shd.materialize(fl_param_decls(cfg, n), seed, mesh.device,
                             block)
    return {"params": params,
            "opt": (_per_client_opt_state(opt, params) if n > 1
                    else opt.init(params)), "step": 0}


# --------------------------------------------------------------------------
# Step builders
# --------------------------------------------------------------------------

def _make_client_fn(cfg: ArchConfig, opt, local_steps: int, frozen_mask=None,
                    tp=None):
    """One client's local training loop (E optimizer steps) on its slot of
    the bank.  ``params_c``/``opt_c`` are trees of tensors (views into the
    bank and the moments) and are updated in place.  With ``tp`` (a
    ``tensor_parallel.ModelAxis``) and/or the call's ``dp`` (a
    ``fsdp.DataAxis`` whose ``split`` says whether ``batch_c`` is this
    rank's rows) they are this rank's blocks of the client, and the step runs
    tensor-parallel and/or fully sharded; sgdm and AdamW are elementwise,
    so a block's update is the whole update's block, and Adafactor (built
    with the axes, ``make_optimizer``) reduces its means over the split
    dims.  Under a split batch the gradient of a leaf with no dim on
    ``data`` is averaged over the data group (``fsdp.reduce_replicated``).

    ``frozen_mask`` (same structure as params, bool leaves, True = frozen)
    turns on partial updates: frozen leaves get zero gradients and are
    restored bit-exactly after the loop, so weight decay / momentum cannot
    drift the base the client never ships."""
    frozen = T.leaves(frozen_mask) if frozen_mask is not None else None
    names = leaf_path_names(model_api.param_decls(cfg))

    def local_step(params, opt_state, step, batch, dp):
        with record_function("fl/forward_backward"):
            leaves = T.leaves(params)
            live = [p.detach().requires_grad_(not (frozen and frozen[i]))
                    for i, p in enumerate(leaves)]
            loss, _ = model_api.loss_fn(cfg, T.unflatten_like(params, live),
                                        batch, tp, dp)
            trainable = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(loss, trainable))
            grads = [next(got) if p.requires_grad else torch.zeros_like(p)
                     for p in live]
            del live, trainable, got
            if dp is not None:
                grads = fsdp.reduce_replicated(grads, names, dp)
        with record_function("fl/optimizer"):
            updates, opt_state = opt.update(T.unflatten_like(params, grads),
                                            opt_state, params, step)
            del grads
            apply_updates(params, updates)
        return loss.detach()

    def client_fn(params_c, opt_c, step, batch_c, dp=None):
        """-> the last step's loss; params_c/opt_c are updated in place."""
        base = None
        if frozen is not None:
            base = [p.clone() if f else None
                    for p, f in zip(T.leaves(params_c), frozen)]
        loss = None
        for _ in range(local_steps):
            loss = local_step(params_c, opt_c, step, batch_c, dp)
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


def _rank_round(client_fn, state, batch, n: int, mesh, axis, dp):
    """This rank's client's local steps on its slot -> the mean loss over
    the ``n`` clients (one ``all_reduce`` over the client axis ``axis``, as
    the reference's ``jnp.mean(losses)``; a client's M ranks hold one
    loss).  Under a batch split over ``dp``, the client's loss is first
    the mean of its D data ranks' losses (``model_api.loss_fn``)."""
    if n == 1:
        loss = client_fn(state["params"], state["opt"], state["step"], batch,
                         dp)
    else:
        loss = client_fn(_slot(state["params"], 0), _slot(state["opt"], 0),
                         state["step"], batch, dp)
    total = loss.detach().float().reshape(1).clone()
    if dp is not None and dp.split:
        dist.all_reduce(total, group=dp.group)
        total.div_(dp.size)
    if n > 1:
        dist.all_reduce(total, group=mesh.group(axis))
    return total[0] / n


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


def span_ms(spans: dict) -> dict:
    """``{name_ms: device ms}`` of a round's spans, once the round has been
    waited for; a span that is a list of event pairs (the model-group
    collectives) gives their sum."""
    out = {}
    for name, val in sorted(spans.items()):
        pairs = val if isinstance(val, list) else [val]
        out[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
    return out


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


def build_fl_round_step(cfg: ArchConfig, n_clients,
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
    (``pre_round_ref``).

    ``n_clients`` may be a mesh (``launch.mesh.Mesh``): the step is then
    this rank's, on the mesh's device, for a state from ``init_state(cfg,
    mesh, ...)``; ``batch`` is this rank's client's (no client dim; every
    rank of a client gets the whole client batch, and in ``shared`` mode
    the step takes the rank's rows of it, ``inputs.rank_rows``),
    ``weights`` all K clients'; the loss is the mean over the clients.  On
    a model axis above 1 the client trains tensor-parallel, on a data axis
    above 1 in ``shared`` mode fully sharded, and on the card the round's
    spans add ``model_collectives`` and ``data_collectives``, an event
    pair per collective inside the client on each axis.  Every rank builds the step, in the same
    order: a ``tree`` schedule's process groups are made here."""
    strat = check_strategy(strategy)
    mesh = None if _is_count(n_clients) else n_clients
    tp = dp = axis = None
    if mesh is not None:
        dev, n_clients = mesh.device, n_clients_for(cfg, mesh)
        axis = client_axis_for(cfg, mesh)
        tp = tpar.axis_for(cfg, mesh)
        dp = data_axis_for(cfg, mesh)
        if n_clients > 1 and schedule.kind == "tree":
            mesh.subgroups(schedule.level_groups, axis)
    else:
        dev = resolve(device)
    opt = make_optimizer(
        cfg, total_steps=total_steps, tp=tp, dp=dp,
        split=None if tp is None else split_dims(cfg, mesh, "model"),
        data_split=None if dp is None else split_dims(cfg, mesh, "data"))
    E = local_steps if local_steps is not None else cfg.fl.local_steps
    frozen_mask = _frozen_mask(cfg, update_filter)
    client_fn = _make_client_fn(cfg, opt, E, frozen_mask=frozen_mask, tp=tp)

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
                ref = (pre_round_ref(_trainable(state["params"]))
                       if mesh is None else      # the rank's own slot
                       T.tree_map(torch.clone, _trainable(state["params"])))
        batch = _to_device(batch, dev)
        if mesh is None:
            loss = _local_round(client_fn, state, batch, n_clients)
        else:
            inner = {"model": tp, "data": dp}
            inner = {k: a for k, a in inner.items() if a is not None}
            for k, a in inner.items():
                if dev.type == "cuda":
                    a.events = spans[f"{k}_collectives"] = []
            rows = dp
            if dp is not None:
                batch, split = inputs.rank_rows(batch, dp.size, dp.rank)
                rows = dp.with_split(split)
            loss = _rank_round(client_fn, state, batch, n_clients, mesh,
                               axis, rows)
            for a in inner.values():
                a.events = None
        if n_clients > 1:
            with record_function("fl/aggregate"), \
                    _span(spans, "aggregate", dev):
                aggregate_params(_trainable(state["params"]),
                                 _on(weights, dev, torch.float32), schedule,
                                 strat, ref=ref, mesh=mesh, axis=axis)
        state["step"] = state["step"] + E
        return state, {"loss": loss, "spans": spans}

    return fl_round_step


def build_eval_step(cfg: ArchConfig):
    """-> ``eval_step(params, batch)``: the batch's mean token
    cross-entropy (``model_api.loss_fn``'s ``ce``) on one device."""
    def eval_step(params, batch):
        _, parts = model_api.loss_fn(cfg, params, batch)
        return parts["ce"]
    return eval_step
