"""The port's verbatim copies of the rest of the numpy control plane
(``api/{async_fl,fleet,mini_broker,mqtt_transport,scenarios}``,
``core/cohort``, ``obs``, ``train/mlp``) against the JAX package's modules:
the same seeded scenario runs through ``repro.api`` and ``repro_torch.api``
and the results are compared exactly.  The copies themselves are held to
their references by ``test_torch_train.py::COPIED``."""
import dataclasses
import importlib
import zlib

import numpy as np
import pytest

import repro.api as ref_api
import repro_torch.api as port_api
from repro.api import scenarios as ref_scenarios
from repro.core.stats import StatsSimulator as RefStats
from repro_torch.api import scenarios as port_scenarios
from repro_torch.core.stats import StatsSimulator as PortStats

PKGS = {"ref": (ref_api, ref_scenarios, RefStats),
        "port": (port_api, port_scenarios, PortStats)}

# Series whose values come from the wall clock: round wall seconds, and
# byte counts of payloads that carry wall-clock timestamps (their decimal
# length varies from run to run in either package).
WALL_SERIES = {"sdflmq_round_wall_seconds", "sdflmq_broker_bytes_received",
               "sdflmq_broker_bytes_sent", "sdflmq_wire_bytes_sent",
               "sdflmq_wire_bytes_received", "sdflmq_wire_dict_bytes_saved"}


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(port_api.__all__))
def test_every_api_export_resolves_to_the_port(name):
    """The lazy exports of ``api/__init__.py`` (mqtt_transport, mini_broker,
    scenarios, async_fl, obs) resolve inside the port."""
    got = getattr(port_api, name)
    mod = got.__name__ if hasattr(got, "__file__") else got.__module__
    assert mod.startswith("repro_torch."), (name, mod)
    want = getattr(ref_api, name)
    assert getattr(got, "__qualname__", None) == \
        getattr(want, "__qualname__", None)


def _telemetry_run(pkg, rounds=2, n=4):
    api = PKGS[pkg][0]
    fed = api.Federation(metrics=True)
    clients = [fed.client(f"c{i}") for i in range(n)]
    session = fed.create_session("s", "m", rounds=rounds,
                                 participants=clients)
    params = {f"c{i}": {"w": np.full((4, 2), float(i) + 0.25, np.float32)}
              for i in range(n)}
    session.run(lambda cid, g, r: (params[cid], 1 + int(cid[1:])),
                initial_params={"w": np.zeros((4, 2), np.float32)})
    return fed, session


def test_federation_with_telemetry_matches_reference():
    """A ``Federation(metrics=True)`` session: the metrics snapshot (every
    series but the wall-clock ones), the trace kinds and the global."""
    (rf, rs), (pf, ps) = _telemetry_run("ref"), _telemetry_run("port")
    _equal_trees(ps.global_params(), rs.global_params())
    assert ps.global_version() == rs.global_version() == 2
    want, got = rf.metrics.snapshot(), pf.metrics.snapshot()
    assert sorted(got) == sorted(want) and len(got) >= 20
    assert WALL_SERIES <= set(got)
    for key in set(want) - WALL_SERIES:
        assert got[key] == want[key], key
    assert pf.tracer.kinds() == rf.tracer.kinds()
    assert type(pf.obs).__module__ == "repro_torch.obs.instrument"


def _drift_train(n, seed):
    rng = np.random.default_rng(seed)
    drift = {f"c{i}": rng.normal(size=(5,)).astype(np.float32)
             for i in range(n)}
    weights = {f"c{i}": int(rng.integers(1, 9)) for i in range(n)}

    def train(cid, g, r):
        base = np.zeros(5, np.float32) if g is None else np.asarray(g["w"])
        return {"w": (base * np.float32(0.6) + drift[cid])}, weights[cid]
    return train


def _async_run(pkg, n=7):
    api = PKGS[pkg][0]
    fed = api.Federation(aggregator_ratio=0.4)
    clients = [fed.client(f"c{i}") for i in range(n)]
    session = fed.create_session(
        "s", "m", rounds=6, participants=clients, strategy="fedavg",
        async_mode=dict(buffer_k=3, staleness_bound=1))
    seen = []
    session.on_global_update = lambda p, v: seen.append((v, np.array(p["w"])))
    rep = session.run_async(_drift_train(n, 5),
                            initial_params={"w": np.zeros(5, np.float32)},
                            max_time_s=60.0)
    return rep, seen


def test_async_session_matches_reference():
    """An async FedBuff session (buffer 3 of 7, staleness bound 1): every
    minted global and the report's counters."""
    (rr, rseen), (pr, pseen) = _async_run("ref"), _async_run("port")
    assert pr.final_state == rr.final_state == "terminated"
    assert [v for v, _ in pseen] == [v for v, _ in rseen]
    for (_, a), (_, b) in zip(pseen, rseen):
        np.testing.assert_array_equal(a, b)
    for field in ("updates", "admitted", "rejected_stale", "site_updates",
                  "virtual_time_s", "stalled", "timed_out", "timeline"):
        assert getattr(pr, field) == getattr(rr, field), field
    assert pr.updates > 0


INIT = {"w": np.arange(8, dtype=np.float32),
        "b": np.ones((2, 3), np.float32)}


def _member_train(cid, start, rnd):
    v = (int(cid.lstrip("c"), 10) % 97) + 1.0 + 0.1 * rnd
    out = {k: (np.asarray(a, np.float64) * 0.5 + v).astype(np.float32)
           for k, a in start.items()}
    return out, (int(cid.lstrip("c"), 10) % 7) + 1


@pytest.mark.parametrize("strategy", ["fedavg", "trimmed_mean"])
def test_fleet_of_cohorts_matches_reference(strategy):
    """Three cohorts of 24 members (``core/cohort.py``'s bank and the
    batched uplink): every round's global and the cohorts' counters."""
    def run(pkg):
        api = PKGS[pkg][0]
        fed = api.Federation()
        ids = [f"c{i:05d}" for i in range(24)]
        cohorts = [fed.cohort(f"co{k}", ids[i:i + 8])
                   for k, i in enumerate(range(0, 24, 8))]
        session = fed.create_fleet_session("s", "m", rounds=2,
                                           cohorts=cohorts,
                                           strategy=strategy)
        globs = session.run(_member_train, initial_params=INIT)
        return globs, [(co.bypassed_messages, co.uplink_partials)
                       for co in cohorts]
    (rg, rc), (pg, pc) = run("ref"), run("port")
    assert len(pg) == len(rg) == 2
    for a, b in zip(pg, rg):
        _equal_trees(a, b)
    assert pc == rc
    assert sum(u for _, u in pc) > 0


ATTACKERS = ["c0", "c3", "c7"]
TARGET = np.linspace(-1.0, 1.0, 8).astype(np.float32)


def _pull_train(cid, g, r):
    base = g["w"] if g is not None else np.zeros(8, np.float32)
    rng = np.random.default_rng(zlib.crc32(f"{cid}/{r}".encode()))
    step = 0.5 * (TARGET - base) + rng.normal(0, 0.05, 8).astype(np.float32)
    return {"w": (base + step).astype(np.float32)}, 1


@pytest.mark.parametrize("strategy,attack", [("fedavg", "scale_poison"),
                                             ("multi_krum", "scale_poison"),
                                             ("trimmed_mean", "label_flip")])
def test_scenario_attack_run_matches_reference(strategy, attack):
    """``scenarios.play`` with 30 % attackers over a delayed, jittered
    link model: the global after 5 rounds and the report."""
    def run(pkg):
        api, scen, _ = PKGS[pkg]
        fed = api.Federation(round_deadline_s=10.0,
                             latency=dict(delay_s=0.01, jitter_s=0.005,
                                          seed=42))
        cls = [fed.client(f"c{i}") for i in range(10)]
        s = fed.create_session("s", model_name="m", rounds=5,
                               participants=cls, strategy=strategy)
        make = getattr(scen, attack)
        events = [make(ATTACKERS, lam=20.0) if attack == "scale_poison"
                  else make(ATTACKERS, flip_scale=3.0)]
        rep = scen.play(s, _pull_train, events=events, rounds=5,
                        round_time_s=1.0,
                        initial_params={"w": np.zeros(8, np.float32)})
        return s.global_params(), rep
    (rg, rr), (pg, pr) = run("ref"), run("port")
    _equal_trees(pg, rg)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert pr.rounds_completed == 5 and not pr.stalled


def test_partition_heal_scenario_matches_reference():
    """Partition and heal on the virtual-time transport, with a stats
    simulator: the global and every report counter."""
    def run(pkg):
        api, scen, stats_cls = PKGS[pkg]
        fed = api.Federation(aggregator_ratio=0.4,
                             latency=dict(delay_s=0.01, jitter_s=0.005,
                                          seed=42))
        sim = stats_cls([f"c{i}" for i in range(8)], seed=9)
        clients = [fed.client(f"c{i}", stats=sim.sample(f"c{i}", 0))
                   for i in range(6)]
        s = fed.create_session("s", "m", rounds=4, participants=clients,
                               strategy="fedavg", capacity=(6, 8))
        s.start()
        events = [scen.partition([["c0", "c1", "c2"], ["c3", "c4", "c5"]],
                                 t0=1.5, t1=3.5)]
        params = {f"c{i}": {"w": np.full(4, float(i) + 0.25, np.float32)}
                  for i in range(6)}
        rep = scen.play(s, lambda c, g, r: (params[c], 1), events=events,
                        rounds=4, round_time_s=1.0)
        return s.global_params(), rep, s.global_version()
    (rg, rr, rv), (pg, pr, pv) = run("ref"), run("port")
    _equal_trees(pg, rg)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr) and pv == rv
    assert pr.partition_held > 0


def _mqtt_run(pkg, backend):
    mb = importlib.import_module(f"{pkg}.api.mini_broker")
    mt = importlib.import_module(f"{pkg}.api.mqtt_transport")
    api = importlib.import_module(f"{pkg}.api")
    broker = mb.MiniBroker(port=0).start()
    try:
        fed = api.Federation(transport=mt.PahoTransport(port=broker.port,
                                                        backend=backend))
        clients = [fed.client(f"c{i}") for i in range(5)]
        s = fed.create_session("s1", model_name="m", rounds=3,
                               participants=clients, strategy="fedavg")

        def step(cid, g, rnd):
            base = g["w"] if g is not None else np.zeros(4, np.float32)
            i = int(cid[1:])
            return {"w": base + np.float32(i + 1) * np.float32(0.5 + rnd)}, \
                i + 1
        s.run(step, initial_params={"w": np.zeros(4, np.float32)})
        out = s.global_params()["w"], s.global_version()
        fed.close()
        return out
    finally:
        broker.stop()


def test_mini_broker_federation_matches_reference():
    """A fedavg session over real MQTT 3.1.1 on loopback: the port's mini
    broker on an ephemeral port and its stdlib client, against the same
    run on the reference's."""
    (rw, rv), (pw, pv) = (_mqtt_run("repro", "builtin"),
                          _mqtt_run("repro_torch", "builtin"))
    assert pv == rv == 3
    assert pw.dtype == rw.dtype
    np.testing.assert_array_equal(pw, rw)


def test_mini_broker_federation_over_paho_matches_reference():
    """The same run through the optional paho-mqtt client."""
    pytest.importorskip(
        "paho.mqtt.client",
        reason="optional dependency paho-mqtt not installed (the "
               "repro[mqtt] extra): the paho leg is not run")
    (rw, rv), (pw, pv) = (_mqtt_run("repro", "paho"),
                          _mqtt_run("repro_torch", "paho"))
    assert pv == rv == 3
    np.testing.assert_array_equal(pw, rw)


def test_mlp_trainer_matches_reference():
    """``train/mlp.py``, the numpy MLP of the paper's Fig. 7 workload, on
    seeded data: the same parameters after two epochs and the same
    accuracy."""
    ref_mlp = importlib.import_module("repro.train.mlp")
    port_mlp = importlib.import_module("repro_torch.train.mlp")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 20)).astype(np.float32)
    y = rng.integers(0, 5, 96)
    out = []
    for mlp in (ref_mlp, port_mlp):
        p = mlp.train_epochs(mlp.init_mlp(3, dims=(20, 16, 5)), x, y,
                             epochs=2, lr=0.05, batch=16, seed=1)
        out.append((p, mlp.accuracy(p, x, y)))
    _equal_trees(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] > 0.2
