"""The federated rounds, plainly: every client's local steps from the
round's global model (round 0: from its own initial weights), its
optimizer state kept across rounds, and the next global model combined
by the traffic's strategy, which ``strategies/<strategy>.py`` gives.
Float32 throughout, TF32 off.  A strategy or schedule that the reference
does not model raises.

``run`` returns the readings the comparison needs: each round's mean
loss over the clients, each client's first gradient norm per leaf, the
global model after round 0 (on the host), and the norm per leaf of the
global model's change from round 0 to the last round read.  It also
returns the inputs (tokens and FedAvg weights) it worked them out from.

``fault="half"`` keeps only the first half of the clients in every mean,
the mean taken over the rest: a fault the comparison has to catch.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from fedbench import weights as W
from fedbench.reference import data, optim
from fedbench.reference.model import Model


def strategy(name: str):
    """The reference's module for the strategy ``name``."""
    try:
        return importlib.import_module(f"fedbench.reference.strategies.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"fedbench.reference.strategies.{name}":
            raise
        raise ValueError(f"the reference has no strategy {name!r}: it needs "
                         f"fedbench/reference/strategies/{name}.py") from None


def _norms(tree: dict) -> dict:
    return {n: float(t.norm()) for n, t in tree.items()}


def inputs(sizes: dict, traffic: dict, seed: int, rounds: int) -> dict:
    """{"batches": [round][client] {"tokens", "labels"}, "weights": (K,)}
    of the rounds that are read."""
    K = sizes["clients"]
    return {"batches": [[data.client_tokens(
        sizes["vocab_size"], seed, k, traffic["batch_per_client"],
        traffic["seq_len"], r) for k in range(K)] for r in range(rounds)],
        "weights": data.fedavg_weights(seed, K)}


def run(sizes: dict, traffic: dict, seed: int, device, rounds: int,
        precision="f32", fault=None) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strat = strategy(traffic["strategy"])
    penalty = getattr(strat, "penalty", None)
    K, E = sizes["clients"], traffic["local_steps"]
    horizon = traffic["lr_horizon_rounds"] * E
    got = inputs(sizes, traffic, seed, rounds)
    w = torch.tensor(got["weights"], device=device)
    if fault == "half":
        w[K // 2:] = 0
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    specs = W.leaf_specs(sizes)
    model = Model(sizes, precision)
    opts = [None] * K
    glob = p1 = None
    out = {"loss": [], "grad_norms": [], "dropped": 0, "inputs": got}
    for r in range(rounds):
        combine = strat.Combine(traffic["schedule"], w)
        losses = []
        for k in range(K):
            if r == 0:
                params = {n: W.make_leaf(n, s, seed, k, device).float()
                          for n, s in specs.items()}
            else:
                params = {n: t.clone() for n, t in glob.items()}
                if k == K - 1:
                    glob = None
            start = {n: t.clone() for n, t in params.items()} \
                if penalty is not None else None
            if opts[k] is None:
                opts[k] = optim.make(sizes["optimizer"], params)
            b = got["batches"][r][k]
            toks = torch.from_numpy(b["tokens"]).to(device)
            labels = torch.from_numpy(b["labels"]).to(device)
            step = r * E
            for _ in range(E):
                live = {n: p.detach().requires_grad_(True)
                        for n, p in params.items()}
                loss, parts = model.loss(live, toks, labels)
                if penalty is not None:
                    loss = loss + penalty(live, start)
                grads = dict(zip(live, torch.autograd.grad(
                    loss, list(live.values()))))
                del live
                out["dropped"] += parts["dropped"]
                if r == 0 and step == 0:
                    out["grad_norms"].append(_norms(grads))
                with torch.no_grad():
                    opts[k].step(params, grads, step, optim.lr_at(step,
                                                                  horizon))
                del grads
                step += 1
            losses.append(float(loss.detach()))
            with torch.no_grad():
                combine.add(k, params)
            del params, start
        glob = combine.result()
        del combine
        out["loss"].append(float(np.mean(losses)))
        if r == 0:
            p1 = {n: t.cpu() for n, t in glob.items()}
    out["p1"] = p1
    out["change_norms"] = {n: float((t - p1[n].to(device)).norm())
                           for n, t in glob.items()}
    return out
