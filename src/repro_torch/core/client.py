"""SDFLMQ client logic (paper §III-C, Listing 1 API).

A client holds: a Role Arbiter (duties + topic subscriptions), a Model
Controller (per-session model repository), and the aggregation service.
The aggregation semantics are pluggable (repro_torch.api.strategies): sessions
carry a strategy name, and every aggregator applies the same strategy hooks
the compiled collective path uses (core/aggregation.py).

"sum"-reduction strategies (fedavg, fedprox, fedadam) move *weighted
partial sums* up the cluster tree through MQTTFC.  The aggregation service
is **streaming and in-place**: each duty holds ONE preallocated flat
float64 accumulator (plus a reusable scratch buffer) and applies
``np.multiply(view, w, out=scratch); np.add(acc, scratch, out=acc)`` —
no per-contribution float64 dicts are ever allocated, and a head forwards
its partial sum by re-framing the accumulator buffer (zero re-serialization
of the leaves).  The fused path is bit-identical to the legacy
``acc + asarray(v, float64) * w`` semantics (property-tested).

"stack"-reduction strategies (trimmed_mean, coordinate_median) are not
decomposable into partial sums; contributions are appended as flat rows
into one growing row buffer.  Heads forward the collected rows as a single
``TensorStack`` slice (one memcpy into the frame, leaves never
re-serialized) and the root builds per-tensor ``(n, ...)`` *strided views*
over the row buffer — no per-key ``np.stack`` duplicate — before applying
the robust combine.  Permutation invariance keeps the tree result
bit-identical to the flat reference no matter the tree shape.

An opt-in int8 + error-feedback uplink codec (``uplink_codec="int8_ef"``)
quantizes leaf updates with the same per-row absmax scheme as the compiled
``compressed`` schedule (repro_torch.dist.compression), carrying the residual
across rounds so repeated compressed rounds do not drift.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.api.strategies import (AggregationStrategy, get_strategy,
                                  register_strategy)
from repro_torch.core import topics as T
from repro_torch.core.mqttfc import MQTTFC, raw_handler
from repro_torch.core.roles import ClientAssignment, RoleArbiter
from repro_torch.core.stats import ClientStats, local_stats
from repro_torch.core.wire import TensorBundle, TensorStack

Params = dict[str, np.ndarray]

# EF residual damping for the delta-coded top-k uplink (see
# _quantize_uplink_topk): 0 would drop deferred mass, 1 would double-count
# it against the self-correcting delta.
_DELTA_EF_DECAY = 0.5


def weighted_add(acc: Optional[Params], p: Params, w: float) -> Params:
    """Legacy reference semantics (kept as the bit-identity oracle for the
    in-place accumulator; see tests/test_wire.py)."""
    if acc is None:
        return {k: np.asarray(v, np.float64) * w for k, v in p.items()}
    for k, v in p.items():
        acc[k] = acc[k] + np.asarray(v, np.float64) * w
    return acc


def _f64_schema(items: list[tuple[str, tuple]]) -> tuple:
    """Schema of (name, '<f8', shape, offset, nbytes) for a flat f64 acc."""
    schema = []
    off = 0
    for name, shape in items:
        nb = int(np.prod(shape, dtype=np.int64)) * 8 if shape else 8
        schema.append((name, np.dtype(np.float64).str, tuple(shape), off, nb))
        off += nb
    return tuple(schema)


class _Accumulator:
    """Streaming per-duty aggregation state.

    sum reduction: ``flat`` is ONE preallocated float64 buffer covering the
    whole model; contributions are fused in with
    ``multiply(src, w, out=scratch); add(flat, scratch, out=flat)``.

    stack reduction: ``rows`` is one growing byte buffer of flattened
    contributions (row-major, shared schema); strided views stack it with
    zero copies at finalize.
    """

    __slots__ = ("flat", "scratch", "acc_schema", "src_schema", "_views",
                 "_src_flat_dtype", "rows", "rows_used", "row_schema",
                 "row_nbytes", "row_weights", "weight", "received",
                 "flushed", "alloc_bytes", "noted_bytes")

    def __init__(self):
        # bytes last folded into the owning _SessionCtx's running total
        # (survives hard_reset so the delta goes negative on a re-layout)
        self.noted_bytes = 0
        self.hard_reset()

    def hard_reset(self) -> None:
        """Drop buffers too (model/strategy layout changed)."""
        self.flat: Optional[np.ndarray] = None
        self.scratch: Optional[np.ndarray] = None
        self.acc_schema = None           # f64 layout of `flat`
        self.src_schema = None           # wire schema the fast path matches
        self._views: Optional[Params] = None
        self._src_flat_dtype = None      # uniform source dtype (fast path)
        self.rows: Optional[bytearray] = None
        self.rows_used = 0
        self.row_schema = None
        self.row_nbytes = 0
        self.row_weights: list[float] = []
        self.weight = 0.0
        self.received = 0
        self.flushed = False
        self.alloc_bytes = 0

    def restart(self) -> None:
        """New aggregation cycle: reset counters but KEEP the buffers —
        reallocating multi-MB accumulators every round costs ~ms of page
        faults; the first add of the next cycle overwrites in place.  A
        layout change triggers ``hard_reset`` from the add paths."""
        self.rows_used = 0
        self.row_weights = []
        self.weight = 0.0
        self.received = 0
        self.flushed = False

    # ------------------------------------------------------------------
    # sum reduction
    # ------------------------------------------------------------------
    def _ensure_flat(self, items: list[tuple[str, tuple]],
                     src_schema=None) -> None:
        if self.flat is not None:
            return
        self.acc_schema = _f64_schema(items)
        self.src_schema = src_schema
        total = sum(b for *_x, b in self.acc_schema) // 8
        self.flat = np.empty(total, np.float64)
        self.alloc_bytes += self.flat.nbytes
        mv = memoryview(self.flat)
        self._views = {}
        for name, _d, shape, off, nb in self.acc_schema:
            self._views[name] = np.frombuffer(
                mv.cast("B"), np.float64, count=nb // 8,
                offset=off).reshape(shape)
        if src_schema is not None:
            dts = {d for _n, d, *_r in src_schema}
            self._src_flat_dtype = np.dtype(next(iter(dts))) \
                if len(dts) == 1 else None

    def _ensure_scratch(self) -> None:
        if self.scratch is None:
            self.scratch = np.empty_like(self.flat)
            self.alloc_bytes += self.scratch.nbytes

    def acc_views(self) -> Params:
        return self._views

    def add_sum(self, contrib: Union[TensorBundle, Params], w: float) -> None:
        """Fused in-place ``acc += contrib * w`` (bit-identical to the
        legacy weighted_add float64 semantics)."""
        w64 = np.float64(w)
        if isinstance(contrib, TensorBundle):
            if (self.received == 0 and self.src_schema is not None
                    and contrib.schema != self.src_schema):
                self.hard_reset()        # layout changed between cycles
            if self.flat is None:
                self._ensure_flat([(n, s) for n, _d, s, _o, _b
                                   in contrib.schema], contrib.schema)
            if (self._src_flat_dtype is not None
                    and contrib.schema == self.src_schema):
                # uniform-dtype source with identical layout: ONE fused op
                # pair over the entire model.  w == 1.0 (the tree's
                # partial-sum merge) needs no multiply at all — a single
                # cast-add pass (x * 1.0 is exact, so still bit-identical
                # to the legacy semantics).
                dt = self._src_flat_dtype
                src = np.frombuffer(memoryview(contrib.buffer).cast("B"), dt)
                if self.received == 0:
                    if w == 1.0:
                        np.copyto(self.flat, src)
                    else:
                        np.multiply(src, w64, out=self.flat)
                elif w == 1.0:
                    np.add(self.flat, src, out=self.flat)
                else:
                    self._ensure_scratch()
                    np.multiply(src, w64, out=self.scratch)
                    np.add(self.flat, self.scratch, out=self.flat)
                return
            contrib = contrib.views()
        items = [(k, np.asarray(v).shape) for k, v in contrib.items()]
        if (self.received == 0 and self.acc_schema is not None
                and items != [(n, s) for n, _d, s, _o, _b
                              in self.acc_schema]):
            self.hard_reset()            # layout changed between cycles
        if self.flat is None:
            self._ensure_flat(items)
        first = self.received == 0
        if not first and w != 1.0:
            self._ensure_scratch()
        for name, _d, shape, off, nb in self.acc_schema:
            v = np.asarray(contrib[name])
            dst = self._views[name]
            if first:
                if w == 1.0:
                    np.copyto(dst, v)
                else:
                    np.multiply(v, w64, out=dst)
            elif w == 1.0:
                np.add(dst, v, out=dst)
            else:
                scr = np.frombuffer(memoryview(self.scratch).cast("B"),
                                    np.float64, count=nb // 8,
                                    offset=off).reshape(shape)
                np.multiply(v, w64, out=scr)
                np.add(dst, scr, out=dst)

    def add_sum_quantized(self, q_params: Params, scales: Params,
                          w: float) -> None:
        """Fused int8 consume: dequantize each leaf (``q.f32 * scale``) and
        stream it straight into the f64 accumulator — bit-identical to
        ``_dequantize`` + ``add_sum`` but never materializes the
        model-sized dense f32 dict (the host-path analogue of the
        ``qagg`` Pallas kernel)."""
        w64 = np.float64(w)
        items = [(k, np.asarray(v).shape) for k, v in q_params.items()]
        if (self.received == 0 and self.acc_schema is not None
                and items != [(n, s) for n, _d, s, _o, _b
                              in self.acc_schema]):
            self.hard_reset()            # layout changed between cycles
        if self.flat is None:
            self._ensure_flat(items)
        first = self.received == 0
        if not first and w != 1.0:
            self._ensure_scratch()
        for name, _d, shape, off, nb in self.acc_schema:
            deq = np.asarray(q_params[name]).astype(np.float32)
            deq *= np.asarray(scales[name], np.float32)
            dst = self._views[name]
            if first:
                if w == 1.0:
                    np.copyto(dst, deq)
                else:
                    np.multiply(deq, w64, out=dst)
            elif w == 1.0:
                np.add(dst, deq, out=dst)
            else:
                scr = np.frombuffer(memoryview(self.scratch).cast("B"),
                                    np.float64, count=nb // 8,
                                    offset=off).reshape(shape)
                np.multiply(deq, w64, out=scr)
                np.add(dst, scr, out=dst)

    def add_sum_topk(self, indices: Params, q_params: Params, scales: Params,
                     shapes: dict, w: float,
                     base: Optional[Params] = None) -> None:
        """Fused sparse consume for the top-k uplink codec: scatter the
        dequantized survivors directly into the flat f64 accumulator.

        With ``base=None`` the payload carries absolute values (round 0,
        before any global exists): un-sent coordinates contribute exactly
        0.0, so this agrees with densify-then-``add_sum`` everywhere.
        With a ``base`` (the shared last global) the payload is
        delta-coded: each contribution is ``base + scatter(delta)``, so
        the base streams in densely and the sparse deltas ride on top."""
        w64 = np.float64(w)
        items = [(k, tuple(shapes[k])) for k in q_params]
        if (self.received == 0 and self.acc_schema is not None
                and items != [(n, s) for n, _d, s, _o, _b
                              in self.acc_schema]):
            self.hard_reset()
        if self.flat is None:
            self._ensure_flat(items)
        if self.received == 0:
            self.flat.fill(0.0)          # sparse writes need a zero base
        for name, _d, shape, off, nb in self.acc_schema:
            idx = np.asarray(indices[name])
            deq = np.asarray(q_params[name]).astype(np.float32)
            deq *= np.float32(np.asarray(scales[name]).reshape(-1)[0])
            dst = self._views[name].reshape(-1)
            b = None
            if base is not None and name in base:
                b = np.asarray(base[name], np.float32).reshape(-1)
                if b.shape != dst.shape:
                    b = None
            if b is not None:
                # delta-coded: the dense base rides every contribution
                if w == 1.0:
                    np.add(dst, b, out=dst)
                else:
                    dst += np.multiply(b, w64)
                np.add.at(dst, idx, deq if w == 1.0
                          else np.multiply(deq, w64))
                continue
            if w == 1.0:
                if self.received == 0:
                    dst[idx] = deq
                else:
                    np.add.at(dst, idx, deq)
            elif self.received == 0:
                dst[idx] = np.multiply(deq, w64)
            else:
                np.add.at(dst, idx, np.multiply(deq, w64))

    def partial_bundle(self) -> TensorBundle:
        """Re-frame the accumulator as a wire bundle — no re-serialization,
        the frame encoder copies the buffer once."""
        return TensorBundle(self.acc_schema, self.flat)

    # ------------------------------------------------------------------
    # stack reduction
    # ------------------------------------------------------------------
    def _ensure_rows(self, schema, expected_rows: int) -> None:
        if self.rows is not None:
            return
        self.row_schema = tuple(
            (n, d, tuple(s), o, b) for n, d, s, o, b in schema)
        self.row_nbytes = sum(b for *_x, b in self.row_schema)
        cap = max(1, expected_rows) * self.row_nbytes
        self.rows = bytearray(cap)
        self.alloc_bytes += cap

    def _grow_rows(self, need: int) -> None:
        if self.rows_used + need <= len(self.rows):
            return
        new_cap = self.rows_used + need
        grown = bytearray(new_cap)
        grown[:self.rows_used] = memoryview(self.rows)[:self.rows_used]
        self.alloc_bytes += new_cap - len(self.rows)
        self.rows = grown

    def add_stack_row(self, contrib: Union[TensorBundle, Params], w: float,
                      expected_rows: int) -> None:
        if not isinstance(contrib, TensorBundle):
            contrib = TensorBundle.from_params(
                {k: np.asarray(v) for k, v in contrib.items()})
        if (not self.row_weights and self.row_schema is not None
                and contrib.schema != self.row_schema):
            self.hard_reset()            # layout changed between cycles
        self._ensure_rows(contrib.schema, expected_rows)
        if contrib.schema != self.row_schema:
            # canonicalize to the first row's layout (key order / dtypes)
            contrib = TensorBundle.from_params(
                {n: np.asarray(contrib.view(n), np.dtype(d)).reshape(s)
                 for n, d, s, _o, _b in self.row_schema})
        self._grow_rows(self.row_nbytes)
        memoryview(self.rows)[self.rows_used:
                              self.rows_used + self.row_nbytes] = \
            memoryview(contrib.buffer).cast("B")
        self.rows_used += self.row_nbytes
        self.row_weights.append(float(w))

    def add_stack_batch(self, batch: TensorStack, weights: list) -> None:
        """A forwarded partial: n rows land with ONE memcpy."""
        if (not self.row_weights and self.row_schema is not None
                and batch.schema != self.row_schema):
            self.hard_reset()
        self._ensure_rows(batch.schema, batch.n)
        assert batch.schema == self.row_schema, "stack schema mismatch"
        nb = batch.nbytes
        self._grow_rows(nb)
        memoryview(self.rows)[self.rows_used:self.rows_used + nb] = \
            memoryview(batch.buffer).cast("B")
        self.rows_used += nb
        self.row_weights.extend(float(x) for x in weights)

    @property
    def n_rows(self) -> int:
        return len(self.row_weights)

    def stack_slice(self) -> TensorStack:
        """Collected rows as one zero-copy wire object."""
        return TensorStack(self.row_schema, self.n_rows,
                           memoryview(self.rows)[:self.rows_used])

    def stacked_views(self) -> Params:
        """Per-tensor (n, ...) strided views over the row buffer — the
        no-duplicate replacement for per-key np.stack."""
        return self.stack_slice().stacked_views()

    def has_data(self) -> bool:
        return self.flat is not None or self.rows_used > 0


@dataclass
class _SessionCtx:
    session_id: str
    model_name: str
    params: Optional[Params] = None
    weight: float = 1.0                      # FedAvg weight (sample count)
    strategy: str = "fedavg"                 # session-wide (from topology)
    global_params: Optional[Params] = None   # last global (strategy ref)
    server_state: Optional[dict] = None      # stateful strategies (fedadam)
    global_version: int = 0
    round_idx: int = 0
    accs: dict[str, _Accumulator] = field(default_factory=dict)
    tree: Optional[dict] = None
    terminated: bool = False
    peak_acc_bytes: int = 0                  # memory evaluation (paper §VI)
    acc_bytes_now: int = 0                   # running total behind the peak
    stale_dropped: int = 0                   # late contributions discarded
    uplink_err: Optional[Params] = None      # int8 error-feedback residual
    topk_base: Optional[Params] = None       # last global: top-k delta base
    # -- adversarial defense (core/defense.py; rides the topology) ------
    defense: Optional[dict] = None           # screening rules (from topology)
    reputation: dict = field(default_factory=dict)   # coordinator trust map
    defense_rejected: int = 0                # updates this node rejected
    gate_ewma: float = 0.0                   # norm-per-weight EWMA baseline
    gate_n: int = 0                          # observations toward warmup
    # -- asynchronous mode (repro_torch.api.async_fl) ------------------------
    async_cfg: Optional[dict] = None         # admission rules (from topology)
    async_bufs: dict = field(default_factory=dict)   # cluster -> AsyncBuffer
    view_params: Optional[Params] = None     # latest model view (training base)
    site_seq: int = 0                        # gossip site-model generation
    version_from_gossip: bool = False        # current version adopted, not
                                             # received: the real global (with
                                             # ref/server state) is still due
    async_admitted: int = 0
    async_rejected: int = 0                  # contributions past the bound
    gossip_sent: int = 0
    gossip_adopts: int = 0
    gossip_merges: int = 0
    site_updates: int = 0

    def acc_for(self, cluster_id: str) -> _Accumulator:
        return self.accs.setdefault(cluster_id, _Accumulator())

    def note_mem(self, acc: Optional[_Accumulator] = None) -> None:
        """Incremental peak tracking: O(1) per ingest, not O(#duties) — a
        cohort endpoint heads thousands of clusters, so even one pass over
        ``accs`` per contribution is quadratic at fleet scale.  Each
        accumulator remembers the bytes it last reported (``noted_bytes``)
        and only the delta folds into the running total."""
        if acc is not None:
            self.acc_bytes_now += acc.alloc_bytes - acc.noted_bytes
            acc.noted_bytes = acc.alloc_bytes
        else:
            self.acc_bytes_now = 0
            for a in self.accs.values():
                a.noted_bytes = a.alloc_bytes
                self.acc_bytes_now += a.alloc_bytes
        if self.acc_bytes_now > self.peak_acc_bytes:
            self.peak_acc_bytes = self.acc_bytes_now

    def reset_round(self, round_idx: int) -> None:
        self.round_idx = round_idx
        # keep accumulators (and their preallocated buffers) for duties
        # that were actually exercised; drop idle ones (stale after a role
        # rearrangement) so their memory is released
        stale = [cid for cid, a in self.accs.items()
                 if a.received == 0 and not a.flushed]
        for cid in stale:
            self.acc_bytes_now -= self.accs[cid].noted_bytes
            del self.accs[cid]
        for a in self.accs.values():
            a.restart()


class ModelController:
    """Per-session model repository (paper: tracks local + global updates)."""

    def __init__(self):
        self.sessions: dict[str, _SessionCtx] = {}

    def get(self, sid: str) -> _SessionCtx:
        return self.sessions[sid]

    def ensure(self, sid: str, model_name: str) -> _SessionCtx:
        if sid not in self.sessions:
            self.sessions[sid] = _SessionCtx(sid, model_name)
        return self.sessions[sid]


class SDFLMQClient:
    """Mirrors the paper's SDFLMQ_Client (Listing 1).  ``broker`` is any
    repro_torch.api.transport.Transport implementation.

    ``wire_format``: "tb" (zero-copy TensorBundle, default) or "legacy"
    (msgpack ExtType) — receivers understand both, so fleets can mix.
    ``uplink_codec``: None, or "int8_ef" for int8 + error-feedback
    quantized leaf uplinks (mirrors the compiled ``compressed`` schedule).
    """

    def __init__(self, client_id: str, broker,
                 preferred_role: str = "trainer",
                 stats: Optional[ClientStats] = None,
                 wire_format: str = "tb",
                 uplink_codec: Optional[str] = None,
                 downlink_codec: Optional[str] = None,
                 update_filter=None,
                 topk_density: float = 0.01,
                 topk_warmup_rounds: int = 0):
        assert uplink_codec in (None, "int8_ef", "topk_int8_ef"), uplink_codec
        assert downlink_codec in (None, "int8"), downlink_codec
        self.client_id = client_id
        self.preferred_role = preferred_role
        self.stats = stats or local_stats(client_id)
        self.uplink_codec = uplink_codec
        self.downlink_codec = downlink_codec
        if update_filter is not None:       # lazy: knob pulls in fl_step
            from repro_torch.core.fl_step import ParamFilter
            update_filter = ParamFilter.parse(update_filter)
        self.update_filter = update_filter
        self.topk_density = float(topk_density)
        self.topk_warmup_rounds = int(topk_warmup_rounds)
        # codec telemetry (repro_torch.obs reads these; cheap plain counters)
        self.codec_stats = {"uplink_bytes": 0, "uplink_msgs": 0,
                            "ef_residual_norm": 0.0,
                            "topk_density": 1.0}
        self.fc = MQTTFC(broker, client_id, will_topic=T.will(client_id),
                         will_payload=_will_payload(client_id),
                         wire_format=wire_format)
        self.arbiter = RoleArbiter(client_id)
        self.models = ModelController()
        self.on_global_update: Optional[Callable] = None
        self.on_round_start: Optional[Callable] = None
        # optional telemetry facade (repro_torch.obs.Telemetry); set by
        # Federation(metrics=...).  None = zero-overhead default.
        self.obs = None
        self.fc.bind(T.client_ctrl(client_id), self._on_ctrl)

    # ------------------------------------------------------------------
    # Paper Listing-1 API
    # ------------------------------------------------------------------
    def create_fl_session(self, session_id: str, model_name: str,
                          fl_rounds: int, session_capacity_min: int,
                          session_capacity_max: int,
                          session_time_s: float = 3600.0,
                          waiting_time_s: float = 120.0,
                          preferred_role: Optional[str] = None,
                          strategy: str = "fedavg",
                          async_cfg: Optional[dict] = None,
                          defense_cfg: Optional[dict] = None) -> None:
        strat = get_strategy(strategy)           # fail fast on unknown names
        if isinstance(strategy, str):
            strategy = strat.name
        else:
            # tuned instance: register under a session-scoped name so every
            # aggregator applies the same hyperparameters without touching
            # what the plain name resolves to for other sessions (a real
            # deployment registers the same factory on every node; the wire
            # carries the name)
            strategy = f"{strat.name}@{session_id}"
            register_strategy(strategy, lambda s=strat: s)
        ctx = self.models.ensure(session_id, model_name)
        ctx.strategy = strategy
        self._subscribe_session(session_id)
        self.fc.call(T.coord("create_session"), session_id, model_name,
                     self.client_id, fl_rounds, session_capacity_min,
                     session_capacity_max, session_time_s, waiting_time_s,
                     preferred_role or self.preferred_role,
                     self.stats.to_dict(), strategy=strategy,
                     async_cfg=async_cfg, defense_cfg=defense_cfg)

    def join_fl_session(self, session_id: str, model_name: str,
                        fl_rounds: int = 0,
                        preferred_role: Optional[str] = None) -> None:
        self.models.ensure(session_id, model_name)
        self._subscribe_session(session_id)
        self.fc.call(T.coord("join_session"), session_id, self.client_id,
                     model_name, fl_rounds,
                     preferred_role or self.preferred_role,
                     self.stats.to_dict())

    def set_model(self, session_id: str, params: Params,
                  n_samples: int = 1) -> None:
        ctx = self.models.get(session_id)
        ctx.params = {k: np.asarray(v) for k, v in params.items()}
        ctx.weight = float(n_samples)

    def get_model(self, session_id: str) -> Params:
        return self.models.get(session_id).params

    def send_local(self, session_id: str) -> None:
        """Publish the locally trained model for global updating.  The
        cluster head's own copy self-delivers via its subscription."""
        ctx = self.models.get(session_id)
        asg = self.arbiter.assignment
        if asg is None or asg.train_cluster is None:
            raise RuntimeError(f"{self.client_id}: no trainer assignment yet")
        topic = T.cluster_agg(session_id, asg.train_cluster)
        # async sessions stamp the *global version the training started
        # from* (the FedBuff staleness reference); sync sessions stamp the
        # round barrier index
        stamp = ctx.global_version if ctx.async_cfg is not None \
            else ctx.round_idx
        if self.obs is not None:
            self.obs.trace("contribute", session=session_id,
                           client=self.client_id, cluster=asg.train_cluster,
                           stamp=stamp)
        ship = ctx.params
        if self.update_filter is not None:
            # partial update: only the filtered (adapter) subset leaves the
            # device; the frozen base never hits the wire
            ship = self.update_filter.extract(ctx.params)
        # density warm-up (gradient-compression practice): the first
        # ``topk_warmup_rounds`` rounds ship the dense int8 codec so the
        # early globals aren't starved to k coordinates, then top-k kicks in
        warm = (self.uplink_codec == "topk_int8_ef"
                and ctx.round_idx < self.topk_warmup_rounds)
        if self.uplink_codec == "topk_int8_ef" and not warm:
            idx, q, scales, shapes = self._quantize_uplink_topk(ctx, ship)
            payload = {"params": q, "indices": idx, "scales": scales,
                       "shapes": shapes, "codec": "topk_int8_ef",
                       "quantized": True, "weight": ctx.weight,
                       "sender": self.client_id, "partial": False,
                       "round": stamp,
                       # delta-coded against this global version (None =
                       # absolute values, no global seen yet)
                       "base_version": (ctx.global_version
                                        if ctx.topk_base is not None
                                        else None)}
            self._note_uplink(idx, q, scales)
            if self.fc.wire_format == "tb":   # legacy msgpack takes dicts
                for key in ("params", "indices", "scales"):
                    payload[key] = TensorBundle.from_params(payload[key])
            self.fc.call(topic, payload, quantized=True)
            return
        if self.uplink_codec == "int8_ef" or warm:
            q, scales = self._quantize_uplink(ctx, ship)
            self._note_uplink(None, q, scales)
            if self.fc.wire_format == "tb":   # legacy msgpack takes dicts
                q = TensorBundle.from_params(q)
                scales = TensorBundle.from_params(scales)
            self.fc.call(topic,
                         {"params": q, "scales": scales, "quantized": True,
                          "weight": ctx.weight, "sender": self.client_id,
                          "partial": False, "round": stamp},
                         quantized=True)
            return
        self._note_uplink(None, ship, None)
        params = ship
        if self.fc.wire_format == "tb":
            params = TensorBundle.from_params(params)
        self.fc.call(topic, {"params": params, "weight": ctx.weight,
                             "sender": self.client_id, "partial": False,
                             "round": stamp})

    def _note_uplink(self, idx, payload: Params, scales) -> None:
        """Codec telemetry: payload bytes actually shipped this uplink."""
        nb = sum(np.asarray(v).nbytes for v in payload.values())
        if idx is not None:
            nb += sum(np.asarray(v).nbytes for v in idx.values())
        if scales is not None:
            nb += sum(np.asarray(v).nbytes for v in scales.values())
        cs = self.codec_stats
        cs["uplink_bytes"] += nb
        cs["uplink_msgs"] += 1

    def _quantize_uplink(self, ctx: _SessionCtx, ship: Params):
        """int8 + error feedback, same per-row absmax scheme the compiled
        ``compressed`` schedule uses (repro_torch.dist.compression, xp=numpy)."""
        from repro_torch.dist import compression as C
        if ctx.uplink_err is None or set(ctx.uplink_err) != set(ship):
            ctx.uplink_err = {k: np.zeros_like(np.asarray(v, np.float32))
                              for k, v in ship.items()}
        q_params, scales = {}, {}
        res_sq = 0.0
        for k, v in ship.items():
            q, scale, new_err = C.quantize_with_error_feedback(
                v, ctx.uplink_err[k], xp=np)
            q_params[k] = q
            scales[k] = np.asarray(scale, np.float32)
            ctx.uplink_err[k] = new_err
            res_sq += float(np.dot(new_err.ravel(), new_err.ravel()))
        self.codec_stats["ef_residual_norm"] = float(np.sqrt(res_sq))
        return q_params, scales

    def _quantize_uplink_topk(self, ctx: _SessionCtx, ship: Params):
        """Top-k + int8 + error feedback (repro_torch.dist.compression,
        xp=numpy): ship only the largest-magnitude ``topk_density``
        fraction of each leaf; the EF residual carries the un-sent mass
        forward so nothing is ever lost, only deferred.

        Once a global exists the payload is *delta-coded* against it
        (``ctx.topk_base``): sparsifying the update instead of the raw
        weights keeps the un-sent coordinates at the shared global rather
        than zero, so a k-sparse uplink no longer starves the model."""
        from repro_torch.dist import compression as C
        if ctx.uplink_err is None or set(ctx.uplink_err) != set(ship):
            ctx.uplink_err = {k: np.zeros_like(np.asarray(v, np.float32))
                              for k, v in ship.items()}
        base = ctx.topk_base
        idx, q_params, scales, shapes = {}, {}, {}, {}
        res_sq = 0.0
        sent = total = 0
        for k, v in ship.items():
            v = np.asarray(v, np.float32)
            delta_coded = (base is not None and k in base
                           and np.shape(base[k]) == v.shape)
            if delta_coded:
                v = v - np.asarray(base[k], np.float32)
            # In delta mode the residual is *damped*, not carried whole: a
            # delta against the actual global partially re-derives the
            # un-applied mass on its own (local SGD pushes the weights the
            # same way again), so a full carry double-counts it and can
            # ring on near-stationary clients, while dropping it entirely
            # slows real training.  Geometric decay keeps most of the EF
            # acceleration with a strictly bounded residual.
            err_in = (ctx.uplink_err[k] * _DELTA_EF_DECAY if delta_coded
                      else ctx.uplink_err[k])
            i, q, scale, new_err = C.quantize_topk_int8_ef(
                v, err_in, self.topk_density, xp=np)
            idx[k] = i
            q_params[k] = q
            scales[k] = scale
            shapes[k] = list(v.shape)
            ctx.uplink_err[k] = new_err
            res_sq += float(np.dot(new_err.ravel(), new_err.ravel()))
            sent += int(i.size)
            total += int(v.size)
        self.codec_stats["ef_residual_norm"] = float(np.sqrt(res_sq))
        self.codec_stats["topk_density"] = sent / total if total else 1.0
        return idx, q_params, scales, shapes

    def wait_global_update(self, session_id: str) -> Params:
        """Synchronous in the simulated broker: delivery already happened by
        the time send_local returned on the last contributor."""
        return self.models.get(session_id).params

    def leave(self, session_id: str) -> None:
        self.fc.call(T.coord("leave_session"), session_id, self.client_id)

    def fail(self) -> None:
        """Simulate abnormal death -> broker fires the LWT."""
        self.fc.close(graceful=False)

    def heartbeat(self, session_id: str) -> None:
        """Liveness beat to the coordinator (defense; metadata only)."""
        self.fc.call(T.coord("heartbeat"), session_id, self.client_id)

    def signal_ready(self, session_id: str,
                     stats: Optional[ClientStats] = None,
                     metrics: Optional[dict] = None) -> None:
        """Round-status update to the coordinator (paper §III-E4), stamped
        with the client's current round so a signal held back by the
        network can't count toward a later round."""
        st = (stats or self.stats).to_dict()
        ctx = self.models.sessions.get(session_id)
        self.fc.call(T.coord("client_ready"), session_id, self.client_id,
                     st, metrics or {},
                     round_idx=ctx.round_idx if ctx else None)

    # ------------------------------------------------------------------
    # Control-plane handlers
    # ------------------------------------------------------------------
    def _subscribe_session(self, session_id: str) -> None:
        self.fc.subscribe_raw(T.session_status(session_id),
                              raw_handler(self._on_status))
        self.fc.subscribe_raw(T.global_model(session_id),
                              raw_handler(self._on_global))
        # async-mode head gossip: cheap to hold in sync sessions (nothing
        # publishes there), and late role changes need no re-subscription
        self.fc.subscribe_raw(T.gossip_all(session_id),
                              raw_handler(self._on_gossip))

    def _on_ctrl(self, payload: dict) -> None:
        ev = payload.get("event")
        if ev == "role_assignment":
            asg = ClientAssignment.from_dict(payload["assignment"])
            to_unsub, to_sub = self.arbiter.update(asg)
            for t in to_unsub:
                self.fc.unbind(t)
            for t in to_sub:
                self.fc.subscribe_raw(t, raw_handler(self._on_cluster_input))

    def _on_status(self, topic: str, payload) -> None:
        body = _body(payload)
        sid = topic.split("/")[2]
        ctx = self.models.sessions.get(sid)
        if ctx is None:
            return
        ev = body.get("event")
        if ev == "topology":
            ctx.tree = body.get("tree")
            # session-wide strategy rides the retained topology broadcast
            ctx.strategy = body.get("strategy", ctx.strategy)
            # async admission rules (incl. live cohort size) ride along too
            ctx.async_cfg = body.get("async") or ctx.async_cfg
            # defense screening rules + the coordinator's live reputation
            # map: every aggregator (incl. late joiners) screens the same
            d = body.get("defense")
            if d is not None:
                ctx.defense = d
                ctx.reputation = dict(d.get("reputation") or {})
            # a (re)joining client syncs its round counter from the retained
            # topology, so its next contribution carries the live round.
            # Async sessions have no round barrier: rearrangements must NOT
            # reset the FedBuff buffers mid-fill.
            rnd = body.get("round")
            if ctx.async_cfg is None and rnd is not None \
                    and rnd > ctx.round_idx:
                ctx.reset_round(rnd)
        elif ev == "round_start":
            ctx.reset_round(body.get("round", ctx.round_idx))
            if self.on_round_start:
                self.on_round_start(sid, ctx.round_idx)
        elif ev == "flush":
            lvl = body.get("level")
            for cid in list(ctx.accs):
                duty = self.arbiter.duty_for(cid)
                if duty is not None and (lvl is None or duty.level == lvl):
                    self._flush(sid, cid, force=True)
        elif ev == "session_terminated":
            ctx.terminated = True

    def _strategy_for(self, ctx: _SessionCtx) -> AggregationStrategy:
        return get_strategy(ctx.strategy)

    @staticmethod
    def _premap_is_identity(strat: AggregationStrategy) -> bool:
        return type(strat).premap is AggregationStrategy.premap

    # ------------------------------------------------------------------
    # Defense screening (core/defense.py rules ride the topology)
    # ------------------------------------------------------------------
    def _defense_screen(self, ctx: _SessionCtx, sid: str, body,
                        w: float) -> Optional[float]:
        """Screen one inbound contribution under the session's defense
        rules.  Returns the (reputation-weighted) combine weight, or None
        when the update is rejected.  Two instruments, coarse to fine:
        the *norm gate* (an EWMA baseline of update-delta magnitudes;
        anything ``norm_gate_mult``× above it is rejected and reported to
        the coordinator) catches scaling/inflation attacks, while the
        robust combine downstream handles direction-only poisoning the
        gate cannot see."""
        d = ctx.defense
        sender = body.get("sender", "")
        partial = bool(body.get("partial"))
        rep = 1.0 if partial else float(ctx.reputation.get(sender, 1.0))
        if not partial and rep < float(d.get("reject_below", 0.2)):
            # quarantined sender: refuse outright, no re-report (the
            # coordinator already knows — that is WHY the score is low)
            self._reject_update(ctx, sid, sender, "reputation",
                                report=False)
            return None
        mult = float(d.get("norm_gate_mult", 4.0))
        if mult > 0:
            metric = self._update_metric(ctx, body)
            if metric is not None:
                warm = int(d.get("norm_warmup", 3))
                alpha = float(d.get("norm_alpha", 0.3))
                if ctx.gate_n >= warm and ctx.gate_ewma > 0.0 \
                        and metric > mult * ctx.gate_ewma:
                    self._reject_update(ctx, sid, sender, "norm_outlier",
                                        report=True)
                    return None
                ctx.gate_n += 1
                ctx.gate_ewma = metric if ctx.gate_n == 1 else \
                    (1.0 - alpha) * ctx.gate_ewma + alpha * metric
        return w * rep

    def _update_metric(self, ctx: _SessionCtx, body) -> Optional[float]:
        """Magnitude of a contribution as an L2 delta from the last global
        (raw norm before the first global exists): per-client for leaves,
        the weighted-mean delta for sum partials, the worst row for stack
        batches — one comparable scale for everything the gate sees."""
        g = ctx.global_params

        def delta_norm(params: Params, scale: float = 1.0) -> float:
            total = 0.0
            for k, v in params.items():
                x = np.asarray(v, np.float64) * scale
                if g is not None and k in g:
                    x = x - np.asarray(g[k], np.float64)
                x = x.ravel()
                total += float(np.dot(x, x))
            return float(np.sqrt(total))

        try:
            if "stack" in body:                   # TensorStack batch
                views = body["stack"].stacked_views()
                ws = body.get("weights") or []
                worst = 0.0
                for i in range(len(ws)):
                    worst = max(worst, delta_norm(
                        {k: v[i] for k, v in views.items()}))
                return worst
            if "entries" in body:                 # legacy stack partial
                return max((delta_norm(_as_params(e["params"]))
                            for e in body["entries"]), default=0.0)
            params = _as_params(_bundle_or_params(body, base=ctx.topk_base))
            if body.get("partial"):
                # flat-f64 partial sum: normalize by the carried weight so
                # the metric is the weighted-mean member delta
                wsum = max(float(body.get("weight", 1.0)), 1e-12)
                return delta_norm(params, scale=1.0 / wsum)
            return delta_norm(params)
        except Exception:
            return None           # malformed frame: let the accumulators
                                  # apply their own schema checks

    def _reject_update(self, ctx: _SessionCtx, sid: str, sender: str,
                       reason: str, report: bool) -> None:
        ctx.defense_rejected += 1
        if self.obs is not None:
            self.obs.trace("update_rejected", session=sid, client=sender,
                           by=self.client_id, reason=reason,
                           round=ctx.round_idx)
        if report and sender:
            self.fc.call(T.coord("defense_report"), sid, sender, reason,
                         self.client_id)

    def _on_cluster_input(self, topic: str, payload) -> None:
        """Aggregation service: accumulate inputs for one duty under the
        session's strategy — streaming into the preallocated flat
        accumulator (sum) or the row buffer (stack)."""
        body = _body(payload)
        parts = topic.split("/")       # sdflmq/session/<sid>/cluster/<cid>/agg
        sid, cluster_id = parts[2], parts[4]
        ctx = self.models.sessions.get(sid)
        duty = self.arbiter.duty_for(cluster_id)
        if ctx is None or duty is None:
            return
        if ctx.async_cfg is not None:
            return self._on_cluster_input_async(sid, cluster_id, body,
                                                ctx, duty)
        # asynchronous delivery: a contribution held by a partition (or a
        # straggler's QoS-1 retransmission) can arrive after its round was
        # deadline-cut — drop it instead of polluting the current round
        rnd = body.get("round")
        if rnd is not None and rnd < ctx.round_idx:
            ctx.stale_dropped += 1
            return
        strat = self._strategy_for(ctx)
        a = ctx.acc_for(cluster_id)
        if a.flushed:        # new aggregation cycle starts on first input
            a.restart()
        # ``covers``: how many of this cluster's expected members the
        # message accounts for — 1 for an individual contribution, k for a
        # cohort's pre-aggregated batch of k fronted members
        covers = int(body.get("covers", 1))
        w = float(body["weight"])
        if ctx.defense is not None:
            w = self._defense_screen(ctx, sid, body, w)
            if w is None:
                # the refusal still counts toward this duty's fan-in, so
                # the honest subset flushes without waiting for an update
                # that was rejected
                a.received += covers
                if a.received >= duty.expected:
                    self._flush(sid, cluster_id)
                return
        if strat.reduction == "stack":
            if body.get("partial"):
                if "stack" in body:       # TensorStack batch (tb wire)
                    a.add_stack_batch(body["stack"], body["weights"])
                else:                     # legacy entries list
                    for e in body["entries"]:
                        a.add_stack_row(_as_params(e["params"]),
                                        float(e["weight"]), duty.expected)
            else:
                contrib = _bundle_or_params(body, base=ctx.topk_base)
                if not self._premap_is_identity(strat):
                    # defense premaps (norm clipping) apply per leaf row,
                    # exactly once — partials forward already-clipped rows
                    contrib = strat.premap(_as_params(contrib),
                                           ctx.global_params, np)
                a.add_stack_row(contrib, w, duty.expected)
        else:
            if body.get("partial"):
                a.add_sum(_bundle_or_params(body), 1.0)
            elif (body.get("quantized")
                  and self._premap_is_identity(strat)):
                # fused consume: the int8 (or sparse top-k) payload streams
                # straight into the f64 accumulator — the host-path twin of
                # the qagg kernel; never materializes the dense f32 model
                self._add_quantized(a, body, w, base=ctx.topk_base)
            else:
                contrib = _bundle_or_params(body, base=ctx.topk_base)
                if not self._premap_is_identity(strat):
                    contrib = strat.premap(_as_params(contrib),
                                           ctx.global_params, np)
                a.add_sum(contrib, w)
        a.weight += w
        a.received += covers
        ctx.note_mem(a)
        if a.received >= duty.expected:
            self._flush(sid, cluster_id)

    @staticmethod
    def _add_quantized(a: _Accumulator, body, w: float,
                       base: Optional[Params] = None) -> None:
        """Dispatch a quantized uplink body to the matching fused
        accumulator path (bit-compatible with densify-then-``add_sum``)."""
        if body.get("codec") == "topk_int8_ef":
            a.add_sum_topk(_as_params(body["indices"]),
                           _as_params(body["params"]),
                           _as_params(body["scales"]),
                           body["shapes"], w,
                           base=(base if body.get("base_version") is not None
                                 else None))
        else:
            a.add_sum_quantized(_as_params(body["params"]),
                                _as_params(body["scales"]), w)

    def _on_cluster_input_async(self, sid: str, cluster_id: str, body,
                                ctx: _SessionCtx, duty) -> None:
        """FedBuff admission (repro_torch.api.async_fl): round-stamped
        contributions are rejected past the staleness bound, admitted at a
        discounted weight otherwise, and the duty flushes K-of-N style —
        the root when ``buffer_k`` leaf contributions landed, heads once a
        proportional share of their cluster reported.  Partials were
        admission-checked and discounted downstream, so they fold in
        unconditionally (their ``contribs`` count rides along)."""
        from repro_torch.api import async_fl as A
        acfg = ctx.async_cfg
        strat = self._strategy_for(ctx)
        a = ctx.acc_for(cluster_id)
        buf = ctx.async_bufs.get(cluster_id)
        if buf is None or buf.acc is not a:
            buf = ctx.async_bufs[cluster_id] = A.AsyncBuffer(a, acfg, strat)
        if a.flushed:                  # first input of a new buffer cycle
            a.restart()
            buf.start_cycle()
        stamp = int(body.get("round") or 0)
        bound = acfg.get("bound")
        if body.get("partial"):
            # partials were discounted at their admission point, but a
            # partial held back (partition, slow link) can outlive the
            # bound in transit — its min-stamp decides, its whole
            # contribution count is rejected and counted
            pstamp = int(body.get("stamp", stamp))
            if bound is not None and ctx.global_version - pstamp > bound:
                nc = int(body.get("contribs", 1))
                buf.rejected_stale += nc
                ctx.async_rejected += nc
                ctx.stale_dropped += nc
                return
            w = float(body["weight"])
            if strat.reduction == "stack":
                if "stack" in body:
                    a.add_stack_batch(body["stack"], body["weights"])
                else:
                    for e in body["entries"]:
                        a.add_stack_row(_as_params(e["params"]),
                                        float(e["weight"]), duty.expected)
            else:
                a.add_sum(_bundle_or_params(body), 1.0)
            buf.contribs += int(body.get("contribs", 1))
            buf.note_stamp(int(body.get("stamp", stamp)))
        else:
            staleness = max(0, ctx.global_version - stamp)
            if self.obs is not None:
                self.obs.observe_staleness(staleness)
            if bound is not None and staleness > bound:
                buf.rejected_stale += 1
                ctx.async_rejected += 1
                ctx.stale_dropped += 1
                return
            w = float(body["weight"]) * float(buf.discount(staleness))
            if ctx.defense is not None:
                w = self._defense_screen(ctx, sid, body, w)
                if w is None:
                    return      # K-of-N: other admissions trigger the flush
            contrib = _bundle_or_params(body, base=ctx.topk_base)
            if not self._premap_is_identity(strat):
                contrib = strat.premap(_as_params(contrib),
                                       ctx.global_params, np)
            if strat.reduction == "stack":
                a.add_stack_row(contrib, w, duty.expected)
            else:
                a.add_sum(contrib, w)
            buf.contribs += 1
            buf.note_stamp(stamp)
            ctx.async_admitted += 1
        a.weight += w
        a.received += 1
        ctx.note_mem(a)
        cohort = max(1, int(acfg.get("cohort", 1)))
        k = min(max(1, int(acfg.get("k", 1))), cohort)
        if duty.parent is None:
            if buf.contribs >= k:
                self._flush(sid, cluster_id, force=True)
        elif a.received >= A.head_share(duty.expected, k, cohort):
            self._flush(sid, cluster_id, force=True)

    def _flush(self, session_id: str, cluster_id: str, force: bool = False) -> None:
        ctx = self.models.get(session_id)
        duty = self.arbiter.duty_for(cluster_id)
        a = ctx.accs.get(cluster_id)
        if duty is None or a is None or a.flushed or not a.has_data():
            return
        if not force and a.received < duty.expected:
            return
        strat = self._strategy_for(ctx)
        legacy_wire = self.fc.wire_format == "legacy"
        buf = ctx.async_bufs.get(cluster_id) \
            if ctx.async_cfg is not None else None
        stamp_round = ctx.global_version if buf is not None else ctx.round_idx
        if duty.parent is not None:
            if strat.reduction == "stack":
                if legacy_wire:
                    sv = a.stacked_views()
                    payload = {"entries": [
                        {"params": {k: sv[k][i] for k in sv},
                         "weight": a.row_weights[i]}
                        for i in range(a.n_rows)],
                        "weight": a.weight,
                        "sender": self.client_id, "partial": True,
                        "round": stamp_round}
                else:
                    # forward collected rows as ONE zero-copy slice; the
                    # frame encoder copies the buffer once — leaves are
                    # never re-encoded
                    payload = {"stack": a.stack_slice(),
                               "weights": list(a.row_weights),
                               "weight": a.weight,
                               "sender": self.client_id, "partial": True,
                               "round": stamp_round}
            else:
                partial = (dict(a.acc_views()) if legacy_wire
                           else a.partial_bundle())
                payload = {"params": partial, "weight": a.weight,
                           "sender": self.client_id, "partial": True,
                           "round": stamp_round}
            if buf is not None:
                # stamped partial: contribution count for the root's K-of-N
                # trigger + the oldest admitted stamp for reconciliation
                payload["contribs"] = buf.contribs
                payload["stamp"] = buf.min_stamp if buf.min_stamp is not None \
                    else ctx.global_version
                self._mint_site_model(ctx, strat, a)
            if self.obs is not None:
                self.obs.trace("flush", session=session_id,
                               client=self.client_id, cluster=cluster_id,
                               parent=duty.parent, received=a.received)
            self._send_cluster(session_id, duty.parent, payload)
        else:
            glob, new_state = self._finalize_root(ctx, strat, a)
            if buf is not None:
                # async root: apply the new global locally *now* — the next
                # buffer cycle must stamp against the new version even
                # before the published echo loops back (a second K-of-N
                # flush inside the same delivery cascade would otherwise
                # mint a duplicate version)
                ctx.global_version += 1
                ctx.params = glob
                ctx.view_params = glob
                ctx.site_seq = 0
                ctx.version_from_gossip = False
                if strat.needs_ref or strat.stateful \
                        or ctx.defense is not None:
                    ctx.global_params = {k: np.array(v)
                                         for k, v in glob.items()}
                if new_state is not None:
                    ctx.server_state = new_state
                version = ctx.global_version
                if self.on_global_update:
                    self.on_global_update(session_id, ctx.params, version)
            else:
                version = ctx.global_version + 1
            tb = self.fc.wire_format == "tb"
            quantized_call = False
            if self.downlink_codec == "int8":
                # quantized retained broadcast: the downlink twin of the
                # int8 uplink — late subscribers replay the retained int8
                # frames and dequantize locally
                from repro_torch.dist import compression as C
                qd, sd = {}, {}
                for k, v in glob.items():
                    q, s = C.quantize_int8(np.asarray(v, np.float32), xp=np)
                    qd[k] = q
                    sd[k] = np.asarray(s, np.float32)
                msg = {"params": TensorBundle.from_params(qd) if tb else qd,
                       "scales": TensorBundle.from_params(sd) if tb else sd,
                       "quantized": True,
                       "version": version,
                       "round": version if buf is not None else ctx.round_idx}
                quantized_call = True
            else:
                msg = {"params": TensorBundle.from_params(glob)
                       if tb else glob,
                       "version": version,
                       "round": version if buf is not None else ctx.round_idx}
            if new_state is not None:
                # server-optimizer state rides the retained global publish,
                # so whichever client roots the next round resumes it
                msg["server_state"] = new_state
            if self.obs is not None:
                self.obs.trace("mint", session=session_id,
                               client=self.client_id, cluster=cluster_id,
                               version=version)
            self.fc.call(T.global_model(session_id), msg, retain=True,
                         quantized=quantized_call)
        if buf is not None:
            buf.flushes += 1
            buf.start_cycle()
        a.restart()
        a.flushed = True

    def _send_cluster(self, session_id: str, cluster_id: str,
                      payload: dict) -> None:
        """Deliver a payload to a cluster's aggregation topic.  Seam for
        ``CohortClient``: when the target cluster's head is fronted by the
        same endpoint, the broker round-trip is bypassed."""
        self.fc.call(T.cluster_agg(session_id, cluster_id), payload)

    def _finalize_root(self, ctx: _SessionCtx, strat: AggregationStrategy,
                       a: _Accumulator):
        """Root aggregator: collected inputs -> (global float32, state)."""
        if strat.reduction == "stack":
            stacked = a.stacked_views()     # strided, no duplicate copies
            weights = np.asarray(a.row_weights, np.float64)
            glob = strat.combine(stacked, weights, np)
            return {k: np.asarray(v, np.float32) for k, v in glob.items()}, None
        wsum = np.float64(a.weight)
        mean = {k: v / wsum for k, v in a.acc_views().items()}
        glob, new_state = strat.finalize(mean, ctx.global_params,
                                         ctx.server_state, np)
        return {k: np.asarray(v, np.float32) for k, v in glob.items()}, new_state

    # ------------------------------------------------------------------
    # Head gossip (async mode, repro_torch.api.async_fl)
    # ------------------------------------------------------------------
    def _mint_site_model(self, ctx: _SessionCtx, strat: AggregationStrategy,
                         a: _Accumulator) -> None:
        """Gossip mode: a head that just flushed a partial also blends the
        buffer mean into its own model view (a *site model*, stamped
        ``(version, site_seq)``).  During a partition this is what keeps
        the root-less side converging; a real global (strictly newer
        version) always supersedes it."""
        acfg = ctx.async_cfg
        if not acfg or float(acfg.get("gossip_period_s", 0.0)) <= 0:
            return
        if strat.reduction == "stack":
            if a.n_rows == 0:
                return
            glob = strat.combine(a.stacked_views(),
                                 np.asarray(a.row_weights, np.float64), np)
            mean = {k: np.asarray(v, np.float32) for k, v in glob.items()}
        else:
            if a.weight <= 0:
                return
            wsum = np.float64(a.weight)
            mean = {k: np.asarray(v / wsum, np.float32)
                    for k, v in a.acc_views().items()}
        alpha = float(acfg.get("gossip_alpha", 0.5))
        view = ctx.view_params
        if view is None or any(k not in view for k in mean):
            ctx.view_params = mean
        else:
            ctx.view_params = {
                k: ((1.0 - alpha) * np.asarray(view[k], np.float64)
                    + alpha * np.asarray(mean[k], np.float64)).astype(
                        np.float32)
                for k in mean}
        ctx.site_seq += 1
        ctx.site_updates += 1

    def gossip_publish(self, session_id: str) -> bool:
        """Publish this head's current model view (global or site model) on
        the session's gossip topic.  QoS 1, so a partition holds — not
        drops — cross-site gossip until heal."""
        ctx = self.models.sessions.get(session_id)
        if ctx is None or ctx.async_cfg is None or ctx.terminated \
                or ctx.view_params is None:
            return False
        params = {k: np.asarray(v, np.float32)
                  for k, v in ctx.view_params.items()}
        if self.fc.wire_format == "tb":
            params = TensorBundle.from_params(params)
        if self.obs is not None:
            self.obs.trace("gossip", session=session_id,
                           client=self.client_id,
                           version=ctx.global_version,
                           site_seq=ctx.site_seq)
        self.fc.call(T.gossip(session_id, self.client_id),
                     {"params": params, "version": ctx.global_version,
                      "site_seq": ctx.site_seq, "sender": self.client_id})
        ctx.gossip_sent += 1
        return True

    def _on_gossip(self, topic: str, payload) -> None:
        """Round-stamped gossip merge: adopt a strictly-newer version,
        average same-version site models (symmetric gossip averaging — two
        heads converge to consensus), ignore older stamps.  Applied by
        every participant, so cluster members train on their head's site
        model while partitioned away from the root."""
        body = _body(payload)
        sid = topic.split("/")[2]
        ctx = self.models.sessions.get(sid)
        if ctx is None or ctx.async_cfg is None or ctx.terminated:
            return
        if body.get("sender") == self.client_id:
            return
        v = int(body.get("version", 0))
        s = int(body.get("site_seq", 0))
        if v > ctx.global_version:
            ctx.view_params = _as_params(body["params"])
            ctx.global_version = v
            ctx.site_seq = s
            ctx.version_from_gossip = True
            ctx.gossip_adopts += 1
        elif v == ctx.global_version and (s > 0 or ctx.site_seq > 0):
            inc = _as_params(body["params"])
            view = ctx.view_params
            if view is None:
                ctx.view_params = {k: np.asarray(x, np.float32)
                                   for k, x in inc.items()}
                ctx.site_seq = s
                ctx.gossip_adopts += 1
                return
            if set(view) != set(inc):
                return
            ctx.view_params = {
                k: ((np.asarray(view[k], np.float64)
                     + np.asarray(inc[k], np.float64))
                    * 0.5).astype(np.float32)
                for k in view}
            ctx.site_seq = max(ctx.site_seq, s)
            ctx.gossip_merges += 1

    def _on_global(self, topic: str, payload) -> None:
        body = _body(payload)
        sid = topic.split("/")[2]
        ctx = self.models.sessions.get(sid)
        if ctx is None:
            return
        if ctx.async_cfg is not None:
            ver = body.get("version", 0)
            # drop stale echoes (incl. the async root's own mint) — but a
            # version first learned through *gossip* still owes us its real
            # global: that publish carries the strategy reference and any
            # server-optimizer state the gossip message did not
            if ver < ctx.global_version or (ver == ctx.global_version
                                            and not ctx.version_from_gossip):
                return
        incoming = _as_params(_bundle_or_params(body))
        if self.update_filter is not None and ctx.params:
            # partial-update downlink: the aggregated (adapter) subset
            # merges over the locally-kept frozen base
            merged = dict(ctx.params)
            merged.update(incoming)
            ctx.params = merged
        else:
            ctx.params = incoming
        strat = self._strategy_for(ctx)
        if strat.needs_ref or strat.stateful or ctx.defense is not None:
            # only reference-using strategies pay for a retained global copy
            # (the defense norm gate also measures deltas against it)
            ctx.global_params = {k: np.array(v) for k, v in ctx.params.items()}
        if self.uplink_codec == "topk_int8_ef":
            # top-k delta base: both the sender (delta coding) and any
            # aggregator duty (densify over base) key off this shared copy
            # of the latest global
            ctx.topk_base = {k: np.asarray(v, np.float32)
                             for k, v in ctx.params.items()}
        if "server_state" in body:
            ctx.server_state = body["server_state"]
        ctx.global_version = body.get("version", ctx.global_version + 1)
        # a real global supersedes any gossip site model as the training base
        ctx.view_params = ctx.params
        ctx.site_seq = 0
        ctx.version_from_gossip = False
        if self.on_global_update:
            self.on_global_update(sid, ctx.params, ctx.global_version)


def _body(payload):
    if isinstance(payload, dict) and "a" in payload:
        args = payload["a"]
        return args[0] if args else {}
    return payload


def _as_params(obj) -> Params:
    """Normalize a wire params object to a dict of arrays (views when the
    source is a TensorBundle — zero copy)."""
    if isinstance(obj, TensorBundle):
        return obj.to_params()
    return {k: np.asarray(v) for k, v in obj.items()}


def _bundle_or_params(body, base: Optional[Params] = None) \
        -> Union[TensorBundle, Params]:
    p = body["params"]
    if body.get("codec") == "topk_int8_ef":
        return _densify_topk(body, base)
    if body.get("quantized"):
        return _dequantize(p, body["scales"])
    return p


def _dequantize(q_obj, s_obj) -> Params:
    """int8 + per-row scales -> float32 params, via the SAME dequantizer
    the compiled ``compressed`` schedule uses."""
    from repro_torch.dist.compression import dequantize_int8
    q = _as_params(q_obj)
    s = _as_params(s_obj)
    return {k: dequantize_int8(v, s[k], xp=np) for k, v in q.items()}


def _densify_topk(body, base: Optional[Params] = None) -> Params:
    """Top-k int8 payload -> dense float32 params (the slow path: defense
    screening and stack strategies; the sum accumulators consume the
    sparse form directly).  Delta-coded payloads densify over ``base``
    (the receiver's copy of the global the sender coded against)."""
    from repro_torch.dist.compression import densify_topk
    q = _as_params(body["params"])
    idx = _as_params(body["indices"])
    s = _as_params(body["scales"])
    shapes = body["shapes"]
    out = {k: densify_topk(idx[k], v, s[k], tuple(shapes[k]), xp=np)
           for k, v in q.items()}
    if body.get("base_version") is not None and base is not None:
        for k, v in out.items():
            if k in base and np.shape(base[k]) == v.shape:
                out[k] = v + np.asarray(base[k], np.float32)
    return out


def _acc_bytes(ctx: _SessionCtx) -> int:
    """Live accumulator bytes for ``ctx`` (incremental counters; kept for
    introspection/tests)."""
    return sum(a.alloc_bytes for a in ctx.accs.values())


def _will_payload(client_id: str) -> bytes:
    # a minimal MQTTFC frame announcing the dead client (legacy header:
    # receivers accept both generations)
    from repro_torch.core import mqttfc as F
    import msgpack
    body = F.encode({"a": [client_id], "k": {}, "s": client_id})
    header = msgpack.packb((client_id, 0, 0, 1, 0, "zlib"))
    return len(header).to_bytes(4, "big") + header + body
