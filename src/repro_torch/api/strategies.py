"""Pluggable aggregation strategies — ONE implementation surface consumed by
both SDFLMQ data paths:

  * the host-side accumulator path (core/client.py): weighted partial sums /
    stacked contributions travel up the cluster tree over MQTT;
  * the compiled tree-collective path (core/aggregation.py): the same math
    runs as grouped psums / all-gathers under shard_map on the mesh.

A strategy is three small hooks over parameter pytrees, written against an
array namespace ``xp`` (numpy on the host path, jax.numpy when compiled):

  * ``premap(params, ref, xp)``       — transform one client's raw model
    before weighting/summation (fedprox mixes toward the previous global).
    Applied exactly once, at the leaf; partial sums are never re-premapped.
  * ``finalize(mean, ref, state, xp)``— turn the weighted mean into the new
    global (+ new server state).  fedavg returns the mean untouched, so the
    fedavg fast path is bit-identical to plain weighted averaging.
  * ``combine(stacked, weights, xp)`` — for ``reduction == "stack"``
    strategies (trimmed mean, coordinate median): full client-stacked
    parameters (leading dim = contributors) -> global.  These are not
    decomposable into partial sums, so the tree forwards the stacked
    contributions unchanged; permutation invariance (sorting) makes the
    tree result bit-identical to the flat reference.

``reduction`` is "sum" (partial sums up the tree) or "stack" (gather up the
tree).  ``stateful`` strategies (fedadam) thread server state through
``finalize``; on the host path the root aggregator publishes the state with
the global model (retained), so whichever client becomes next round's root
resumes it — MQTT retained-message sync doubling as optimizer-state
replication.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np


def _live_mask(weights, xp):
    """(alive bool mask, live count) for churn-aware masked combines."""
    alive = xp.asarray(weights) > 0
    return alive, xp.sum(alive.astype(xp.int32))


def _sort_dead_last(s, alive, xp):
    """Sort rows ascending with dead rows pushed behind a +big sentinel —
    the shared scaffolding of the masked robust combines (static shapes:
    works identically for numpy and traced jax)."""
    s = xp.asarray(s, xp.float32)
    amask = alive.reshape((s.shape[0],) + (1,) * (s.ndim - 1))
    return xp.sort(xp.where(amask, s, xp.float32(3.0e38)), axis=0)


def _flat_sq_norm(params, xp):
    """Total squared L2 norm over a whole params pytree (scalar)."""
    total = None

    def add(v):
        nonlocal total
        v = xp.asarray(v, xp.float32)
        sq = xp.sum(v * v)
        total = sq if total is None else total + sq
        return v
    _tmap(add, params)
    return total if total is not None else xp.float32(0.0)


def _tmap(fn, *trees):
    """Map over matching pytrees of dict/list/tuple containers.  Pure
    Python: the host MQTT path (flat numpy dicts) must not pay the jax
    import; the compiled path's nested param dicts map the same way."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class AggregationStrategy:
    """Base: plain weighted FedAvg semantics."""

    name = "fedavg"
    reduction = "sum"          # "sum" | "stack"
    compiled = True            # supported by the compiled collective path
    stateful = False
    needs_ref = False          # premap/finalize reads the previous global

    # -- sum-reduction hooks ------------------------------------------------
    def premap(self, params, ref, xp):
        """One client's raw model -> contribution (pre-weighting).  ``ref``
        is the previous global model (None on the first round)."""
        return params

    def finalize(self, mean, ref, state, xp):
        """Weighted mean -> (global, new_server_state)."""
        return mean, None

    # -- stack-reduction hook ----------------------------------------------
    def combine(self, stacked, weights, xp):
        """Client-stacked params (leading dim = n) + weights (n,) -> global."""
        raise NotImplementedError(f"{self.name} is not a stack strategy")

    def combine_masked(self, stacked, weights, xp):
        """Churn-aware variant used by the compiled collective path: rows
        whose weight is <= 0 (dead/vacant mesh slots) must not shift the
        statistic.  The default delegates to ``combine`` (correct for
        weighted sums, overridden by the robust stack strategies)."""
        return self.combine(stacked, weights, xp)

    # -- asynchronous-FL hook ----------------------------------------------
    def staleness_discount(self, staleness: int) -> float:
        """Weight multiplier for a contribution trained ``staleness`` global
        versions ago (bounded-staleness FedBuff buffers, repro_torch.api.async_fl).
        The base semantics are *constant*: staleness does not change the
        weight — which keeps the async path bit-identical to the synchronous
        one when every contribution is fresh."""
        return 1.0

    def init_state(self, params):
        return None

    def describe(self) -> str:
        return (self.__doc__ or "").strip().split("\n")[0]


class FedAvg(AggregationStrategy):
    """Weighted federated averaging (McMahan et al.) — the paper's default."""


class FedProx(AggregationStrategy):
    """Proximal aggregation: each contribution is shrunk toward the previous
    global before averaging, damping client drift on non-IID data
    (aggregation-side analogue of the FedProx proximal term)."""

    name = "fedprox"
    needs_ref = True

    def __init__(self, mu: float = 0.1):
        assert 0.0 <= mu < 1.0, mu
        self.mu = float(mu)

    def premap(self, params, ref, xp):
        if ref is None:
            return params
        mu = self.mu
        return _tmap(lambda p, g: (1.0 - mu) * xp.asarray(p, xp.float32)
                     + mu * xp.asarray(g, xp.float32), params, ref)


class _PolyStaleness:
    """Mixin: polynomial staleness discount ``(1 + s) ** -a`` (Xie et al.,
    "Asynchronous Federated Optimization") for FedBuff-style buffers."""

    def __init__(self, a: float = 0.5, **kw):
        assert a >= 0.0, a
        self.staleness_a = float(a)
        super().__init__(**kw)

    def staleness_discount(self, staleness: int) -> float:
        return (1.0 + float(max(0, staleness))) ** (-self.staleness_a)


class FedAvgStaleness(_PolyStaleness, FedAvg):
    """FedAvg with polynomial staleness discounting: a contribution trained
    ``s`` global versions ago is admitted at weight ``w * (1+s)^-a``."""

    name = "fedavg_poly"


class FedProxStaleness(_PolyStaleness, FedProx):
    """FedProx proximal aggregation + polynomial staleness discounting."""

    name = "fedprox_poly"

    def __init__(self, a: float = 0.5, mu: float = 0.1):
        _PolyStaleness.__init__(self, a=a)
        FedProx.__init__(self, mu=mu)


class TrimmedMean(AggregationStrategy):
    """Byzantine-robust coordinate-wise trimmed mean: drop the k highest and
    k lowest values per coordinate (k = floor(beta * n)), average the rest.
    Ignores sample weights (standard for robust aggregation).

    ``beta`` is validated again at combine time against the *live* cohort:
    when ``2 * ceil(beta * n) >= n_live`` the requested trim would devour
    the whole cohort (tiny or heavily churned rounds), so the trim is
    clamped to the largest feasible ``k = (n_live - 1) // 2`` and the
    degeneration is counted in :attr:`trim_clamped` instead of silently
    producing a garbage mean.  (The counter is maintained on the host
    numpy path; under a jax trace the clamp applies but cannot count.)"""

    name = "trimmed_mean"
    reduction = "stack"

    def __init__(self, beta: float = 0.2):
        assert 0.0 <= beta < 0.5, beta
        self.beta = float(beta)
        #: times the requested trim degenerated and was clamped
        self.trim_clamped = 0

    def _note_clamp(self, n_live: int) -> None:
        import math
        if n_live >= 1 and 2 * math.ceil(self.beta * n_live) >= n_live:
            self.trim_clamped += 1

    def combine(self, stacked, weights, xp):
        counted = []                   # count once per combine, not per leaf

        def one(s):
            n = s.shape[0]
            if xp is np and not counted:
                counted.append(True)
                self._note_clamp(int(n))
            k = int(self.beta * n)
            if 2 * k >= n:
                k = (n - 1) // 2
            srt = xp.sort(xp.asarray(s, xp.float32), axis=0)
            if k:
                srt = srt[k:n - k]
            return xp.mean(srt, axis=0)
        return _tmap(one, stacked)

    def combine_masked(self, stacked, weights, xp):
        """Churn-aware trimmed mean with static shapes: dead rows (weight
        <= 0) are sorted to the top via a +big sentinel and the trim window
        ``[k, m-k)`` is computed over the *live* count ``m`` — so a departed
        client's stale row can never shift the statistic.  Reduces to
        ``combine`` when every row is live; all-dead yields zeros.  A trim
        that would degenerate on the live count is clamped (and counted on
        the host path, see :attr:`trim_clamped`)."""
        alive, m = _live_mask(weights, xp)
        if xp is np:
            self._note_clamp(int(m))

        def one(s):
            srt = _sort_dead_last(s, alive, xp)
            n = srt.shape[0]
            k = xp.floor(self.beta * m).astype(xp.int32)
            k = xp.maximum(xp.where(2 * k >= m, (m - 1) // 2, k), 0)
            idx = xp.arange(n).reshape((n,) + (1,) * (srt.ndim - 1))
            inc = (idx >= k) & (idx < m - k)
            cnt = xp.maximum(m - 2 * k, 1).astype(xp.float32)
            out = xp.sum(xp.where(inc, srt, xp.float32(0.0)), axis=0) / cnt
            return xp.where(m > 0, out, xp.zeros_like(out))
        return _tmap(one, stacked)


class CoordinateMedian(AggregationStrategy):
    """Byzantine-robust coordinate-wise median over all contributors."""

    name = "coordinate_median"
    reduction = "stack"

    def combine(self, stacked, weights, xp):
        return _tmap(lambda s: xp.median(xp.asarray(s, xp.float32), axis=0),
                     stacked)

    def combine_masked(self, stacked, weights, xp):
        """Churn-aware coordinate median: dead rows sort to the top behind a
        +big sentinel; the median indices are taken over the live count
        (all-dead yields zeros)."""
        alive, m = _live_mask(weights, xp)

        def one(s):
            srt = _sort_dead_last(s, alive, xp)
            lo = xp.take(srt, xp.maximum((m - 1) // 2, 0), axis=0)
            hi = xp.take(srt, m // 2, axis=0)
            # halve-then-add: two sentinel rows (all-dead) must not
            # overflow float32 before the m=0 guard zeroes them
            out = lo * xp.float32(0.5) + hi * xp.float32(0.5)
            return xp.where(m > 0, out, xp.zeros_like(out))
        return _tmap(one, stacked)


class _NormClip:
    """Mixin: norm-clipping premap (defense).  Each contribution's *update*
    (its delta from the previous global) is rescaled so its flat L2 norm
    never exceeds ``clip`` — a scaling/model-poisoning attacker can then
    inflate its update by at most ``clip / typical_norm`` no matter how
    large a λ it multiplies in.  Applied once at the leaf on both data
    paths (host MQTT aggregators and the compiled shard_map stack path).
    With no previous global yet (round 0) there is no update to measure,
    so the premap is the identity."""

    needs_ref = True

    def __init__(self, clip: float = 10.0, **kw):
        assert clip > 0.0, clip
        self.clip = float(clip)
        super().__init__(**kw)

    def premap(self, params, ref, xp):
        if ref is None:
            return params
        delta = _tmap(lambda p, g: xp.asarray(p, xp.float32)
                      - xp.asarray(g, xp.float32), params, ref)
        nrm = xp.sqrt(_flat_sq_norm(delta, xp))
        scale = xp.minimum(xp.float32(1.0),
                           self.clip / xp.maximum(nrm, xp.float32(1e-12)))
        return _tmap(lambda g, d: xp.asarray(g, xp.float32) + d * scale,
                     ref, delta)


class NormClipFedAvg(_NormClip, FedAvg):
    """FedAvg with norm-clipped updates: plain weighted averaging, but no
    single contribution can pull the mean further than ``clip`` (defends
    against update-scaling poisoning while keeping fedavg semantics for
    honest, small updates)."""

    name = "norm_clip"


def _weighted_value_sort(s, w, alive, xp):
    """Per-coordinate value sort carrying each row's weight along.  Dead
    rows (``alive`` False) are pushed behind a +big sentinel so zero-mass
    garbage can never sit inside a trim/median window.  Returns
    ``(vsorted, wsorted)`` of the same shape as ``s``."""
    s = xp.asarray(s, xp.float32)
    n = s.shape[0]
    amask = alive.reshape((n,) + (1,) * (s.ndim - 1))
    s = xp.where(amask, s, xp.float32(3.0e38))
    w = xp.where(alive, xp.asarray(w, xp.float32), xp.float32(0.0))
    order = xp.argsort(s, axis=0)
    vsorted = xp.take_along_axis(s, order, axis=0)
    wfull = xp.broadcast_to(w.reshape((n,) + (1,) * (s.ndim - 1)), s.shape)
    wsorted = xp.take_along_axis(wfull, order, axis=0)
    return vsorted, wsorted


class WeightedTrimmedMean(AggregationStrategy):
    """Weight-aware Byzantine-robust trimmed mean: per coordinate, sort the
    values and discard ``beta`` of the total *weight mass* from each end,
    then take the weighted average of the surviving mass (a boundary value
    keeps only the slice of its weight inside the window).  Unlike
    :class:`TrimmedMean` this honors FedAvg sample weights — and
    reputation-scaled weights: a client demoted to near-zero weight simply
    carries no mass.  Inherently churn-aware: rows with weight <= 0
    contribute nothing, so ``combine_masked`` and ``combine`` coincide."""

    name = "weighted_trimmed_mean"
    reduction = "stack"

    def __init__(self, beta: float = 0.2):
        assert 0.0 <= beta < 0.5, beta
        self.beta = float(beta)

    def combine(self, stacked, weights, xp):
        return self.combine_masked(stacked, weights, xp)

    def combine_masked(self, stacked, weights, xp):
        alive, m = _live_mask(weights, xp)
        beta = xp.float32(self.beta)

        def one(s):
            vsorted, wsorted = _weighted_value_sort(s, weights, alive, xp)
            cum = xp.cumsum(wsorted, axis=0)
            total = xp.sum(wsorted, axis=0, keepdims=True)
            lo, hi = beta * total, (xp.float32(1.0) - beta) * total
            # effective weight = the slice of each row's mass that falls
            # inside [beta*W, (1-beta)*W] of the cumulative distribution
            eff = xp.clip(xp.minimum(cum, hi)
                          - xp.maximum(cum - wsorted, lo), 0.0, None)
            denom = xp.sum(eff, axis=0)
            out = xp.sum(vsorted * eff, axis=0) \
                / xp.maximum(denom, xp.float32(1e-30))
            return xp.where(denom > 0, out, xp.zeros_like(out))
        return _tmap(one, stacked)


class WeightedMedian(AggregationStrategy):
    """Weight-aware coordinate-wise median: the 50%-of-total-mass point of
    the weight-cumulative value distribution (average of the lower and
    upper crossing values, reducing to :class:`CoordinateMedian` under
    equal weights).  Weight-zero (dead) rows carry no mass, so the combine
    is inherently churn-aware."""

    name = "weighted_median"
    reduction = "stack"

    def combine(self, stacked, weights, xp):
        return self.combine_masked(stacked, weights, xp)

    def combine_masked(self, stacked, weights, xp):
        alive, m = _live_mask(weights, xp)

        def one(s):
            vsorted, wsorted = _weighted_value_sort(s, weights, alive, xp)
            cum = xp.cumsum(wsorted, axis=0)
            total = xp.sum(wsorted, axis=0, keepdims=True)
            half = xp.float32(0.5) * total
            # first crossing >= half (lower median) / > half (upper median);
            # argmax over bool finds the first True per coordinate
            lo_i = xp.argmax(cum >= half, axis=0)
            hi_i = xp.argmax(cum > half, axis=0)
            lo = xp.take_along_axis(vsorted, lo_i[None], axis=0)[0]
            hi = xp.take_along_axis(vsorted, hi_i[None], axis=0)[0]
            out = lo * xp.float32(0.5) + hi * xp.float32(0.5)
            return xp.where(total[0] > 0, out, xp.zeros_like(out))
        return _tmap(one, stacked)


class MultiKrum(AggregationStrategy):
    """Multi-Krum (Blanchard et al., "Machine Learning with Adversaries"):
    score every contribution by its summed squared distance to its
    ``n_live - f - 2`` closest peers (flat, across all tensors), select the
    ``m`` best-scored rows and average them — geometric outliers (poisoned
    or scaled updates) score badly and are excluded entirely, unlike
    coordinate-wise trims.  Tolerates up to ``f`` Byzantine rows when
    ``n_live >= 2f + 3``; smaller live cohorts degrade gracefully (the
    neighbor count clamps at 1).  Selection ignores sample weights (rows
    with weight <= 0 are dead: excluded from distances and never
    selected); the selected rows are averaged unweighted, per the paper."""

    name = "multi_krum"
    reduction = "stack"

    def __init__(self, m: int = 3, f: int = 1):
        assert m >= 1 and f >= 0, (m, f)
        self.m_sel = int(m)
        self.f = int(f)

    def combine(self, stacked, weights, xp):
        return self.combine_masked(stacked, weights, xp)

    def combine_masked(self, stacked, weights, xp):
        alive, m_live = _live_mask(weights, xp)
        flats = []

        def grab(v):
            v = xp.asarray(v, xp.float32)
            flats.append(v.reshape((v.shape[0], -1)))
            return v
        _tmap(grab, stacked)
        X = xp.concatenate(flats, axis=1)          # (n, D) flat rows
        n = X.shape[0]
        sq = xp.sum(X * X, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
        BIG = xp.float32(1e30)
        dead = ~alive
        d2 = xp.where(dead[:, None] | dead[None, :], BIG, d2)
        d2 = d2 + BIG * xp.eye(n, dtype=xp.float32)      # exclude self
        dsort = xp.sort(d2, axis=1)
        kc = xp.clip(m_live - self.f - 2, 1, max(n - 1, 1))
        idx = xp.arange(n)[None, :]
        scores = xp.sum(xp.where(idx < kc, dsort, xp.float32(0.0)), axis=1)
        scores = xp.where(dead, xp.float32(xp.inf), scores)
        ranks = xp.argsort(xp.argsort(scores))     # rank of each row
        q = xp.clip(xp.minimum(m_live, self.m_sel), 1, n)
        sel = ranks < q                            # exactly q best rows
        qf = xp.maximum(xp.sum(sel.astype(xp.float32)), xp.float32(1.0))

        def one(s):
            s = xp.asarray(s, xp.float32)
            smask = sel.reshape((n,) + (1,) * (s.ndim - 1))
            out = xp.sum(xp.where(smask, s, xp.float32(0.0)), axis=0) / qf
            return xp.where(m_live > 0, out, xp.zeros_like(out))
        return _tmap(one, stacked)


class Krum(MultiKrum):
    """Krum: Multi-Krum with m=1 — emit the single best-scored contribution
    (strongest Byzantine resistance, highest variance)."""

    name = "krum"

    def __init__(self, f: int = 1):
        super().__init__(m=1, f=f)


class ClippedWeightedTrimmedMean(_NormClip, WeightedTrimmedMean):
    """Norm-clipped weighted trimmed mean: updates are norm-clipped at the
    leaf (bounding any single λ-scaled poison), then combined with the
    weight-mass trim — the belt-and-suspenders defense of the adversarial
    test wall."""

    name = "clipped_weighted_trimmed_mean"

    def __init__(self, beta: float = 0.2, clip: float = 10.0):
        _NormClip.__init__(self, clip=clip)
        WeightedTrimmedMean.__init__(self, beta=beta)


class FedAdam(AggregationStrategy):
    """Server-side Adam (Reddi et al., "Adaptive Federated Optimization"):
    the round's pseudo-gradient (weighted mean minus previous global) drives
    Adam moments kept at the aggregation root; state rides with the retained
    global-model publish so the root role can move between rounds."""

    name = "fedadam"
    stateful = True
    needs_ref = True
    compiled = False           # server state does not fit the pure-collective
                               # round step; host path + facade only

    def __init__(self, lr: float = 0.1, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-3):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def finalize(self, mean, ref, state, xp):
        if ref is None:
            # first round: no pseudo-gradient yet; emit the mean, zero state
            zeros = _tmap(lambda v: xp.zeros_like(xp.asarray(v, xp.float64)),
                          mean)
            return mean, {"m": zeros, "v": _tmap(xp.copy, zeros), "t": 0}
        t = int(state["t"]) + 1 if state else 1
        m0 = state["m"] if state else _tmap(
            lambda v: xp.zeros_like(xp.asarray(v, xp.float64)), mean)
        v0 = state["v"] if state else _tmap(xp.copy, m0)
        delta = _tmap(lambda a, b: xp.asarray(a, xp.float64)
                      - xp.asarray(b, xp.float64), mean, ref)
        m = _tmap(lambda mm, d: self.b1 * mm + (1 - self.b1) * d, m0, delta)
        v = _tmap(lambda vv, d: self.b2 * vv + (1 - self.b2) * d * d,
                  v0, delta)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        new = _tmap(
            lambda g, mm, vv: xp.asarray(g, xp.float64)
            + self.lr * (mm / bc1) / (xp.sqrt(vv / bc2) + self.eps),
            ref, m, v)
        return new, {"m": m, "v": v, "t": t}


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], AggregationStrategy]] = {}


def register_strategy(name: str, factory: Callable[[], AggregationStrategy]):
    """Register a strategy factory under ``name`` (overwrites allowed so
    users can re-tune hyperparameters, e.g. a different fedprox mu).

    >>> from repro_torch.api.strategies import (AggregationStrategy,
    ...                                   get_strategy, register_strategy)
    >>> class Halving(AggregationStrategy):
    ...     name = "halving"
    ...     def finalize(self, mean, ref, state, xp):
    ...         return {k: v / 2 for k, v in mean.items()}, state
    >>> _ = register_strategy("halving", Halving)
    >>> get_strategy("halving").name
    'halving'
    """
    _REGISTRY[name] = factory
    return factory


def get_strategy(s: Union[str, AggregationStrategy]) -> AggregationStrategy:
    """Resolve a name (or pass through an instance) from the registry.

    >>> from repro_torch.api.strategies import get_strategy
    >>> get_strategy("fedavg").reduction           # decomposable: sums
    'sum'
    >>> get_strategy("trimmed_mean").reduction     # robust: full stacks
    'stack'
    >>> import numpy as np
    >>> mean = {"w": np.array([2.0, 4.0])}
    >>> new_global, state = get_strategy("fedavg").finalize(
    ...     mean, None, None, np)
    >>> new_global["w"]                            # fedavg: mean untouched
    array([2., 4.])
    >>> get_strategy("nope")                    # doctest: +ELLIPSIS
    Traceback (most recent call last):
        ...
    KeyError: "unknown aggregation strategy 'nope'; have [...]"
    """
    if isinstance(s, AggregationStrategy):
        return s
    try:
        return _REGISTRY[s]()
    except KeyError:
        raise KeyError(f"unknown aggregation strategy {s!r}; "
                       f"have {sorted(_REGISTRY)}") from None


def list_strategies() -> list[str]:
    """Registered strategy names, sorted.

    >>> from repro_torch.api.strategies import list_strategies
    >>> {"fedavg", "fedprox", "trimmed_mean"} <= set(list_strategies())
    True
    """
    return sorted(_REGISTRY)


register_strategy("fedavg", FedAvg)
register_strategy("fedprox", FedProx)
register_strategy("fedavg_poly", FedAvgStaleness)
register_strategy("fedprox_poly", FedProxStaleness)
register_strategy("trimmed_mean", TrimmedMean)
register_strategy("coordinate_median", CoordinateMedian)
register_strategy("fedadam", FedAdam)
register_strategy("norm_clip", NormClipFedAvg)
register_strategy("weighted_trimmed_mean", WeightedTrimmedMean)
register_strategy("weighted_median", WeightedMedian)
register_strategy("krum", Krum)
register_strategy("multi_krum", MultiKrum)
register_strategy("clipped_weighted_trimmed_mean", ClippedWeightedTrimmedMean)
