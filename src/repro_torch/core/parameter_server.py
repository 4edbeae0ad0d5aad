"""Parameter Server logic (paper §III-B2): repository of global models for
all sessions handled by the coordinator + global update synchronizer.
Listens on the public global-model topics; can run co-located with the
coordinator or standalone.  Retained MQTT messages double as the
"synchronizer": any client (re)subscribing immediately receives the latest
global model — which is also the crash-recovery path for rejoining nodes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import topics as T
from repro_torch.core.broker import SimBroker
from repro_torch.core.mqttfc import MQTTFC, raw_handler
from repro_torch.core.wire import TensorBundle


class ParameterServer:
    def __init__(self, broker: SimBroker, client_id: str = "param_server"):
        self.fc = MQTTFC(broker, client_id)
        self.store: dict[str, dict] = {}       # sid -> {params, version, round}
        self.history: dict[str, list[int]] = {}
        self.fc.subscribe_raw(f"{T.ROOT}/session/+/global",
                              raw_handler(self._on_global))

    def _on_global(self, topic: str, payload) -> None:
        args = payload["a"] if isinstance(payload, dict) and "a" in payload else [payload]
        body = args[0]
        sid = topic.split("/")[2]
        if body.get("quantized"):
            # int8 downlink codec: mirror the dequantized global so readers
            # always see plain f32 params
            from repro_torch.core.client import _bundle_or_params
            p = _bundle_or_params(body)
        else:
            p = body["params"]
        params = (p.to_params() if isinstance(p, TensorBundle)
                  else {k: np.asarray(v) for k, v in p.items()})
        self.store[sid] = {
            "params": params,
            "version": body.get("version", 0),
            "round": body.get("round", 0),
        }
        self.history.setdefault(sid, []).append(body.get("version", 0))

    def get_global(self, sid: str) -> Optional[dict]:
        return self.store.get(sid)

    def versions(self, sid: str) -> list[int]:
        return self.history.get(sid, [])
