"""SDFLMQ topic grammar (paper §III-E: roles and functions bound to topics).

Layout:
    sdflmq/coord/<function>                 coordinator RFC endpoints
    sdflmq/client/<client_id>/ctrl          per-client private control channel
    sdflmq/session/<sid>/status             session status broadcasts
    sdflmq/session/<sid>/cluster/<cid>/agg  trainers publish weights to the
                                            cluster head subscribed here
    sdflmq/session/<sid>/global             parameter-server global model
                                            (retained so late joiners sync)
    sdflmq/session/<sid>/gossip/<cid>       async-mode head gossip: cluster
                                            heads exchange model views so
                                            partitioned sites keep converging
"""
from __future__ import annotations

ROOT = "sdflmq"


def coord(function: str) -> str:
    return f"{ROOT}/coord/{function}"


def client_ctrl(client_id: str) -> str:
    return f"{ROOT}/client/{client_id}/ctrl"


def session_status(sid: str) -> str:
    return f"{ROOT}/session/{sid}/status"


def cluster_agg(sid: str, cluster_id: str) -> str:
    return f"{ROOT}/session/{sid}/cluster/{cluster_id}/agg"


def global_model(sid: str) -> str:
    return f"{ROOT}/session/{sid}/global"


def gossip(sid: str, client_id: str) -> str:
    return f"{ROOT}/session/{sid}/gossip/{client_id}"


def gossip_all(sid: str) -> str:
    return f"{ROOT}/session/{sid}/gossip/+"


def will(client_id: str) -> str:
    return f"{ROOT}/will/{client_id}"
