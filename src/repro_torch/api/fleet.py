"""Multi-broker fleet fabric: bridged per-site brokers on one sharded clock.

The paper's §III-F bridging scales the control plane horizontally: each
site (region, campus, cell) runs its own broker, and bridges forward the
``sdflmq`` topic space between them.  ``build_fabric`` assembles the
simulated version of that deployment:

  * one **core** ``SimBroker`` hosting the coordinator and parameter
    server,
  * ``n_sites`` site brokers, each bridged to the core (hub-and-spoke — a
    tree fabric, which the per-hop re-origination loop prevention in
    ``SimBroker.bridge`` keeps duplicate-free),
  * one shared ``SimClock``; every site's ``LatencyTransport`` rides its
    own event-loop **shard**, so each site's delivery backlog lives in its
    own heap and the clock merge-scans the shard heads in global
    ``(time, seq)`` order,
  * one ``Federation`` over the core transport — ``fabric.cohort(site,
    ...)`` attaches a ``CohortClient`` to its site's transport.

Site-level failure knobs: ``partition_site``/``heal_site`` take a site's
bridges down (reliable traffic queues on the bridge and replays on heal,
QoS 0 is lost — a real broker outage), while the per-site transports carry
the usual per-link delay/jitter/drop/duplication models for straggler
sites and duplicate storms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.api.federation import Federation, FleetSession
from repro_torch.api.transport import LatencyTransport, SimClock
from repro_torch.core.broker import SimBroker

__all__ = ["FleetFabric", "build_fabric"]


@dataclass
class FleetFabric:
    """Handle to one assembled multi-site fabric."""
    clock: SimClock
    core: LatencyTransport
    sites: dict[str, LatencyTransport]
    federation: Federation

    def site(self, name: str) -> LatencyTransport:
        return self.sites[name]

    def cohort(self, site: str, cohort_id: str, member_ids,
               stats=None):
        """A ``CohortClient`` fronting ``member_ids``, attached to
        ``site``'s broker (and that site's event-loop shard)."""
        return self.federation.cohort(cohort_id, member_ids, stats=stats,
                                      transport=self.sites[site])

    def create_fleet_session(self, *args, **kwargs) -> FleetSession:
        return self.federation.create_fleet_session(*args, **kwargs)

    # ---- site-level failures --------------------------------------------
    def partition_site(self, site: str) -> None:
        """Sever ``site`` from the core: both bridge directions go down.
        Reliable traffic queues on the bridges until ``heal_site``."""
        site_b = self.sites[site].inner
        self.core.inner.set_bridge_down(site_b.name, down=True)
        site_b.set_bridge_down(self.core.inner.name, down=True)

    def heal_site(self, site: str) -> None:
        site_b = self.sites[site].inner
        self.core.inner.set_bridge_down(site_b.name, down=False)
        site_b.set_bridge_down(self.core.inner.name, down=False)
        if not self.clock.held:
            self.clock.run_until_idle()

    def shard_backlog(self) -> dict:
        """Live pending-delivery count per event-loop shard."""
        return self.clock.shards()


def build_fabric(n_sites: int = 2, site_delay_s: float = 0.0,
                 site_jitter_s: float = 0.0,
                 site_latency: Optional[dict] = None,
                 core_latency: Optional[dict] = None,
                 clock: Optional[SimClock] = None, seed: int = 0,
                 **federation_kwargs) -> FleetFabric:
    """Assemble a hub-and-spoke multi-broker fabric.

    ``site_delay_s``/``site_jitter_s`` model the inter-broker bridge links
    (core <-> site); ``site_latency``/``core_latency`` are ``LinkModel``
    kwargs for the per-site client transports.  Remaining kwargs go to
    ``Federation`` (role policy, deadlines, metrics, ...).
    """
    clock = clock if clock is not None else SimClock()
    core_b = SimBroker("core")
    core_t = LatencyTransport(core_b, clock=clock, seed=seed,
                              **(core_latency or {}))
    core_t.shard = "core"
    sites: dict[str, LatencyTransport] = {}
    for i in range(n_sites):
        name = f"site{i}"
        b = SimBroker(name)
        # hub-and-spoke: every site bridges to the core only (a tree —
        # cycle-free under per-hop re-origination)
        core_b.bridge(b, delay_s=site_delay_s, jitter_s=site_jitter_s,
                      clock=clock, seed=seed)
        t = LatencyTransport(b, clock=clock, seed=seed + 1 + i,
                             **(site_latency or {}))
        t.shard = name
        sites[name] = t
    fed = Federation(transport=core_t, **federation_kwargs)
    return FleetFabric(clock, core_t, sites, fed)
