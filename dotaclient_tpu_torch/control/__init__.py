"""Control plane (own copy of dotaclient_tpu/control/): the closed-loop
autoscaler and discovery service.

- control/scrape.py   stdlib scraper over the fleet's /metrics + /healthz
                      surfaces, with per-tier aggregation
                      (`<scalar>.mean/.max/.sum` + up counts);
- control/policy.py   declarative threshold policy (--control.policy):
                      hysteresis bands + per-tier cooldowns;
- control/drivers.py  actuation: StaticDriver (observe-only, the rollback
                      position), K8sDriver (kubectl scale against the
                      committed manifests) and InProcessDriver (live
                      in-process routers);
- control/server.py   the standing binary: scrape → decide → actuate on a
                      poll loop, every decision ledgered with its meter
                      values, plus GET /topology for discovery.

Stdlib only. Nothing imports this package unless the control binary runs:
the serve client's `control:` discovery speaks plain HTTP.
"""

from dotaclient_tpu_torch.control.drivers import (
    InProcessDriver,
    K8sDriver,
    StaticDriver,
    TierSpec,
)
from dotaclient_tpu_torch.control.policy import PolicyClause, PolicyEngine, parse_policy
from dotaclient_tpu_torch.control.scrape import (
    aggregate_tier,
    parse_prometheus_text,
    scrape_endpoint,
    scrape_health,
)
from dotaclient_tpu_torch.control.server import ControlPlane

__all__ = [
    "ControlPlane",
    "InProcessDriver",
    "K8sDriver",
    "PolicyClause",
    "PolicyEngine",
    "StaticDriver",
    "TierSpec",
    "aggregate_tier",
    "parse_policy",
    "parse_prometheus_text",
    "scrape_endpoint",
    "scrape_health",
]
