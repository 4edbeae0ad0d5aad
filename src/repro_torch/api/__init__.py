"""repro_torch.api — the single entry point for running SDFLMQ federations.

    from repro_torch.api import Federation
    fed = Federation()                       # broker + coordinator + PS
    clients = [fed.client(f"c{i}") for i in range(5)]
    session = fed.create_session("s1", model_name="mlp", rounds=3,
                                 participants=clients, strategy="fedavg")
    session.run(train_fn, initial_params=init)

Submodules:
    federation — Federation / FederatedSession facade
    strategies — pluggable AggregationStrategy registry (fedavg, fedprox,
                 trimmed_mean, coordinate_median, fedadam, *_poly staleness
                 variants); one surface for both the host MQTT path and the
                 compiled collective path
    transport  — Transport protocol + LatencyTransport edge-network model
    async_fl   — AsyncFederatedSession: bounded-staleness FedBuff buffers,
                 per-client pacing, head gossip under partitions
    mqtt_transport — PahoTransport: the Transport protocol over a real
                 MQTT broker (paho-mqtt or the bundled stdlib client)
    mini_broker — hermetic in-process MQTT 3.1.1 broker for CI/dev

Observability lives in the sibling package ``repro_torch.obs`` (re-exported
here): ``Federation(metrics=True)`` + ``serve_metrics(fed.metrics)``
gives a Prometheus ``/metrics`` endpoint and JSON round timelines.

Heavy imports are lazy (PEP 562) so core modules can import
``repro_torch.api.strategies`` without dragging in the full facade.
"""
from __future__ import annotations

_EXPORTS = {
    "Federation": ("repro_torch.api.federation", "Federation"),
    "FederatedSession": ("repro_torch.api.federation", "FederatedSession"),
    "AggregationStrategy": ("repro_torch.api.strategies", "AggregationStrategy"),
    "get_strategy": ("repro_torch.api.strategies", "get_strategy"),
    "register_strategy": ("repro_torch.api.strategies", "register_strategy"),
    "list_strategies": ("repro_torch.api.strategies", "list_strategies"),
    "Transport": ("repro_torch.api.transport", "Transport"),
    "LatencyTransport": ("repro_torch.api.transport", "LatencyTransport"),
    "LinkModel": ("repro_torch.api.transport", "LinkModel"),
    "SimClock": ("repro_torch.api.transport", "SimClock"),
    "PahoTransport": ("repro_torch.api.mqtt_transport", "PahoTransport"),
    "MiniBroker": ("repro_torch.api.mini_broker", "MiniBroker"),
    "AsyncConfig": ("repro_torch.api.async_fl", "AsyncConfig"),
    "AsyncFederatedSession": ("repro_torch.api.async_fl", "AsyncFederatedSession"),
    "AsyncReport": ("repro_torch.api.async_fl", "AsyncReport"),
    "scenarios": ("repro_torch.api.scenarios", None),   # submodule, not attribute
    "async_fl": ("repro_torch.api.async_fl", None),     # submodule
    "MetricsRegistry": ("repro_torch.obs", "MetricsRegistry"),
    "Telemetry": ("repro_torch.obs", "Telemetry"),
    "Tracer": ("repro_torch.obs", "Tracer"),
    "serve_metrics": ("repro_torch.obs", "serve_metrics"),
    "obs": ("repro_torch.obs", None),                   # telemetry subpackage
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(mod_name)
    return mod if attr is None else getattr(mod, attr)


def __dir__():
    return __all__
