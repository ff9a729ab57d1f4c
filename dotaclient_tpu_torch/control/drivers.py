"""Actuation drivers: how a scale decision becomes replicas (own copy of
dotaclient_tpu/control/drivers.py).

One interface, three shapes:

- ``StaticDriver`` — observe-only. Topology is the literal flag lists;
  scale() records the decision and actuates NOTHING. This is the safe
  default (--control.driver static) and the rollback position: flip a
  misbehaving k8s controller back to static and the fleet freezes at
  its current shape while the ledger keeps explaining what the policy
  WOULD do.
- ``K8sDriver`` — speaks the committed StatefulSet contracts
  (k8s/*.yaml): `kubectl scale statefulset/<name> --replicas=N`, with
  topology derived from the per-pod DNS identity the manifests pin
  (`<set>-<i>.<service>` — pod index IS shard/affinity identity, so
  scale-down removes the HIGHEST indices, which is exactly the
  rendezvous-friendly removal order). The kubectl invocation goes
  through an injectable runner callable, so tests assert the exact
  argv without a cluster. Rollout ORDER discipline (store-first on the
  way up, broker-first drains on the way down) is the
  operator contract this driver inherits; it changes replica COUNTS
  only, one tier per decision, cooldowns spacing the moves.
- ``InProcessDriver`` — wraps live in-process routers (anything with
  ``replica_count()`` and ``scale_to(n)``, e.g. an elastic router over
  live replicas), so the whole closed loop — scrape, decide, actuate,
  re-scrape — runs inside one process with real HTTP surfaces.

Driver interface (duck-typed, no ABC ceremony):
    replicas(tier) -> int             current replica count
    scale(tier, n) -> dict            actuation record (ledgered)
    metrics_endpoints(tier) -> [str]  obs surfaces to scrape
    topology() -> {tier: [str]}       DATA endpoints for /topology
    tiers() -> [str]                  tiers this driver manages
"""

from __future__ import annotations

import logging
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

_log = logging.getLogger(__name__)


@dataclass
class TierSpec:
    """One tier's k8s identity (the committed-manifest contract)."""

    tier: str
    workload: str  # "statefulset/<name>" or "deployment/<name>"
    service: str = ""  # headless Service for per-pod DNS ("" = workload name)
    namespace: str = "dotaclient"
    data_port: int = 0  # the port clients dial (topology)
    obs_port: int = 9100  # the /metrics + /healthz port (scraping)
    replicas: int = 1  # boot-time count (refreshed by scale())


class StaticDriver:
    """Observe-only actuation: endpoints are the literal flag lists,
    scale() is a ledgered no-op. `metrics` maps tier → obs endpoints;
    `topology_map` (optional) maps tier → data endpoints for /topology —
    when omitted the metrics lists are served verbatim (observe-only
    discovery: the operator's literal lists, unchanged)."""

    def __init__(
        self,
        metrics: Dict[str, List[str]],
        topology_map: Optional[Dict[str, List[str]]] = None,
    ):
        self._metrics = {t: list(eps) for t, eps in metrics.items() if eps}
        self._topology = {
            t: list(eps) for t, eps in (topology_map or self._metrics).items() if eps
        }
        self.noop_scales = 0

    def tiers(self) -> List[str]:
        return sorted(self._metrics)

    def replicas(self, tier: str) -> int:
        return len(self._metrics.get(tier, []))

    def metrics_endpoints(self, tier: str) -> List[str]:
        return list(self._metrics.get(tier, []))

    def topology(self) -> Dict[str, List[str]]:
        return {t: list(eps) for t, eps in self._topology.items()}

    def scale(self, tier: str, n: int) -> dict:
        self.noop_scales += 1
        return {"driver": "static", "tier": tier, "replicas": int(n), "actuated": False}


class InProcessDriver:
    """Wraps live routers: {tier: router} where a router answers
    ``replica_count()`` and ``scale_to(n)`` (an elastic shim over live
    replicas). `metrics` / `topology_fn`
    are callables so endpoint lists track the router's LIVE shape —
    a scaled-up replica's obs surface appears on the next poll."""

    def __init__(
        self,
        routers: Dict[str, object],
        metrics: Optional[Dict[str, Callable[[], List[str]]]] = None,
        topology_fn: Optional[Callable[[], Dict[str, List[str]]]] = None,
    ):
        self._routers = dict(routers)
        self._metrics = dict(metrics or {})
        self._topology_fn = topology_fn
        self.scales = 0

    def tiers(self) -> List[str]:
        return sorted(self._routers)

    def replicas(self, tier: str) -> int:
        return int(self._routers[tier].replica_count())

    def metrics_endpoints(self, tier: str) -> List[str]:
        fn = self._metrics.get(tier)
        return list(fn()) if fn is not None else []

    def topology(self) -> Dict[str, List[str]]:
        return dict(self._topology_fn()) if self._topology_fn is not None else {}

    def scale(self, tier: str, n: int) -> dict:
        self._routers[tier].scale_to(int(n))
        self.scales += 1
        return {
            "driver": "in-process",
            "tier": tier,
            "replicas": int(n),
            "actuated": True,
        }


class K8sDriver:
    """kubectl-backed actuation against the committed manifests.

    `runner` takes an argv list and returns the process returncode
    (default: subprocess.run). Replica counts are tracked locally and
    committed only on a zero returncode — a failed kubectl leaves the
    driver's view (and the next poll's decisions) at the last known
    actuated shape instead of assuming success."""

    def __init__(
        self,
        specs: Dict[str, TierSpec],
        kubectl: str = "kubectl",
        runner: Optional[Callable[[List[str]], int]] = None,
    ):
        self._specs = dict(specs)
        self._kubectl = kubectl
        self._run = runner if runner is not None else self._default_runner
        self._replicas = {t: int(s.replicas) for t, s in self._specs.items()}
        self.kubectl_calls = 0
        self.kubectl_failures = 0

    @staticmethod
    def _default_runner(argv: List[str]) -> int:
        return subprocess.run(argv, capture_output=True).returncode

    def tiers(self) -> List[str]:
        return sorted(self._specs)

    def replicas(self, tier: str) -> int:
        return self._replicas[tier]

    def _pod_dns(self, spec: TierSpec, i: int) -> str:
        # StatefulSet per-pod DNS: <set>-<i>.<service>.<ns>.svc — pod
        # index IS the shard/affinity identity (the serve and broker StatefulSets).
        name = spec.workload.partition("/")[2] or spec.workload
        service = spec.service or name
        return f"{name}-{i}.{service}.{spec.namespace}.svc"

    def metrics_endpoints(self, tier: str) -> List[str]:
        spec = self._specs[tier]
        return [
            f"{self._pod_dns(spec, i)}:{spec.obs_port}"
            for i in range(self._replicas[tier])
        ]

    def topology(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for tier, spec in self._specs.items():
            if spec.data_port:
                out[tier] = [
                    f"{self._pod_dns(spec, i)}:{spec.data_port}"
                    for i in range(self._replicas[tier])
                ]
        return out

    def scale(self, tier: str, n: int) -> dict:
        spec = self._specs[tier]
        argv = [
            self._kubectl,
            "scale",
            spec.workload,
            f"--replicas={int(n)}",
            "-n",
            spec.namespace,
        ]
        self.kubectl_calls += 1
        rc = self._run(argv)
        if rc == 0:
            self._replicas[tier] = int(n)
        else:
            self.kubectl_failures += 1
            _log.warning("kubectl scale failed (rc=%d): %s", rc, " ".join(argv))
        return {
            "driver": "k8s",
            "tier": tier,
            "replicas": int(n),
            "argv": argv,
            "rc": rc,
            "actuated": rc == 0,
        }
