"""The control-plane binary (own copy of dotaclient_tpu/control/server.py):
scrape → decide → actuate → serve topology.

    python -m dotaclient_tpu_torch.control.server \\
        --control.driver static \\
        --control.policy "server:serve_load_occupancy.mean,high=0.75,low=0.25,min=2,max=8,cooldown=120" \\
        --control.port 13400 --control.servers h0:9100,h1:9100

One standing process (k8s/control.yaml): a poll loop scrapes every
managed tier's /metrics + /healthz surfaces (control/scrape.py),
evaluates the declarative policy (control/policy.py hysteresis +
cooldowns), and actuates through the configured driver
(control/drivers.py). Every evaluation — moves and holds alike — lands in
a bounded decision ledger with the meter values that justified it.

The same HTTP surface serves discovery: GET /topology returns

    {"ok": true, "epoch": N, "tiers": {"server": ["h:p", ...], ...},
     "metrics": {"server": ["h:obs_p", ...], ...}}

— `tiers` is the data endpoint map actors and serve clients poll at
(re)connect (`--serve.endpoint control:<host:port>`, serve/client.py,
which speaks plain HTTP and never imports this package), `metrics` the
scrape-surface map obs/fleetd.py discovers its targets from. `epoch`
bumps on every actuated scale.

Stdlib only: the process never loads torch or numpy (k8s/control.yaml
caps the pod at 256Mi).
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from dotaclient_tpu_torch.config import ControlConfig, parse_config
from dotaclient_tpu_torch.control.drivers import K8sDriver, StaticDriver, TierSpec
from dotaclient_tpu_torch.control.policy import PolicyEngine, parse_policy
from dotaclient_tpu_torch.control.scrape import aggregate_tier, scrape_endpoint, scrape_health
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

_log = logging.getLogger(__name__)

# The committed-manifest contracts the k8s driver actuates against
# (k8s/*.yaml: workload kind/name, headless service, data + obs ports,
# boot replicas). Scale targets clamp via policy min/max, so a spec's
# `replicas` is only the pre-first-actuation view.
_K8S_SPECS: Dict[str, TierSpec] = {
    "broker": TierSpec(
        tier="broker", workload="statefulset/broker", service="broker",
        data_port=13370, obs_port=9100, replicas=3,
    ),
    "server": TierSpec(
        tier="server", workload="statefulset/inference", service="inference",
        data_port=13380, obs_port=9100, replicas=2,
    ),
    "actor": TierSpec(
        tier="actor", workload="deployment/actors", service="actors",
        data_port=0, obs_port=9100, replicas=256,
    ),
    "store": TierSpec(
        tier="store", workload="deployment/carry-store", service="carry-store",
        data_port=13390, obs_port=9100, replicas=1,
    ),
    "learner": TierSpec(
        tier="learner", workload="statefulset/learner", service="learner",
        data_port=0, obs_port=9100, replicas=1,
    ),
}

_LEDGER_CAP = 4096  # bounded: a week of 2 s polls must not grow RSS


class ControlPlane:
    """The closed loop. `driver` is any control/drivers.py duck-type;
    `metrics_overrides` pins a tier's scrape list regardless of the
    driver's derived endpoints (flag lists in k8s mode, injected
    surfaces in tests); `now_fn` feeds the policy cooldown clocks."""

    def __init__(
        self,
        cfg: ControlConfig,
        driver,
        metrics_overrides: Optional[Dict[str, List[str]]] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg.control
        self.obs_cfg = cfg.obs
        self.driver = driver
        self.engine = PolicyEngine(parse_policy(self.cfg.policy), now_fn=now_fn)
        self._overrides = {t: list(e) for t, e in (metrics_overrides or {}).items()}
        self._scrape_timeout = max(0.5, min(2.0, float(self.cfg.poll_s)))
        # The controller's crash ring: every scale decision lands here,
        # so a fleetd incident bundle shows what the control plane did
        # around the alert (served via GET /debug/flight).
        self.recorder = FlightRecorder(
            "control", ring_size=self.obs_cfg.ring_size, dump_dir=self.obs_cfg.dump_dir
        )
        self._lock = threading.Lock()
        self.decisions: collections.deque = collections.deque(maxlen=_LEDGER_CAP)
        self.topology_epoch = 0
        self.polls_total = 0
        self.scrapes_total = 0
        self.scrape_errors_total = 0
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.holds_total = 0
        self.actuation_failures_total = 0
        self.last_meters: Dict[str, Dict[str, float]] = {}
        self._http: Optional[MetricsHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- loop

    def _tier_endpoints(self, tier: str) -> List[str]:
        if tier in self._overrides:
            return list(self._overrides[tier])
        return self.driver.metrics_endpoints(tier)

    def poll_once(self) -> dict:
        """One scrape-decide-actuate round. Returns {"meters", "evals"}
        (the per-round record); ledger + counters updated."""
        meters: Dict[str, Dict[str, float]] = {}
        current: Dict[str, int] = {}
        for tier in self.driver.tiers():
            eps = self._tier_endpoints(tier)
            samples = []
            healthy = 0
            for ep in eps:
                s = scrape_endpoint(ep, timeout_s=self._scrape_timeout)
                samples.append(s)
                self.scrapes_total += 1
                if s is None:
                    self.scrape_errors_total += 1
                    continue
                ok, _ = scrape_health(ep, timeout_s=self._scrape_timeout)
                healthy += 1 if ok else 0
            agg = aggregate_tier(samples)
            agg["healthy"] = float(healthy)
            agg["replicas"] = float(self.driver.replicas(tier))
            meters[tier] = agg
            current[tier] = self.driver.replicas(tier)
        evals = self.engine.evaluate(meters, current)
        now = time.time()
        # Actuate OUTSIDE the surface lock: a scale can take seconds
        # (kubectl round-trip; an in-process driver booting a real
        # replica), and /topology + /healthz must keep answering while
        # it runs — a discovery client mid-reconnect polls exactly then.
        entries = []
        ups = downs = holds = failures = bumps = 0
        for ev in evals:
            entry = dict(ev)
            entry["t"] = now
            entry["meters"] = dict(meters.get(ev["tier"], {}))
            if ev["action"] in ("up", "down"):
                actuation = self.driver.scale(ev["tier"], ev["target"])
                entry["actuation"] = actuation
                if actuation.get("actuated"):
                    bumps += 1
                    if ev["action"] == "up":
                        ups += 1
                    else:
                        downs += 1
                else:
                    failures += 1
                _log.info(
                    "scale %s %s %d -> %d (%s)",
                    ev["tier"], ev["action"], ev["current"], ev["target"],
                    ev["reason"],
                )
                self.recorder.record(
                    "scale",
                    tier=ev["tier"],
                    action=ev["action"],
                    target=ev["target"],
                    reason=ev["reason"],
                    actuated=bool(actuation.get("actuated")),
                )
            else:
                holds += 1
            entries.append(entry)
        with self._lock:
            self.last_meters = meters
            self.topology_epoch += bumps
            self.scale_ups_total += ups
            self.scale_downs_total += downs
            self.holds_total += holds
            self.actuation_failures_total += failures
            self.decisions.extend(entries)
            self.polls_total += 1
        return {"meters": meters, "evals": evals}

    def _run(self) -> None:
        while not self._stop.wait(float(self.cfg.poll_s)):
            try:
                self.poll_once()
            except Exception:
                # a broken poll must not kill the standing loop — the
                # next round re-scrapes from scratch
                _log.exception("control poll failed")

    # ---------------------------------------------------------- surfaces

    def topology(self) -> dict:
        with self._lock:
            return {
                "ok": True,
                "epoch": self.topology_epoch,
                "tiers": self.driver.topology(),
                # Scrape-surface map (obs ports, override lists first):
                # what obs/fleetd discovers its aggregation targets from.
                # Additive key — /topology consumers that only read
                # "tiers" (serve/client.py) are unaffected.
                "metrics": {
                    tier: self._tier_endpoints(tier)
                    for tier in self.driver.tiers()
                },
            }

    def health(self) -> dict:
        with self._lock:
            return {
                "ok": True,
                "polls": self.polls_total,
                "epoch": self.topology_epoch,
                "tiers": {t: self.driver.replicas(t) for t in self.driver.tiers()},
            }

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "control_polls_total": float(self.polls_total),
                "control_scrapes_total": float(self.scrapes_total),
                "control_scrape_errors_total": float(self.scrape_errors_total),
                "control_scale_ups_total": float(self.scale_ups_total),
                "control_scale_downs_total": float(self.scale_downs_total),
                "control_holds_total": float(self.holds_total),
                "control_actuation_failures_total": float(self.actuation_failures_total),
                "control_topology_epoch": float(self.topology_epoch),
                "control_managed_tiers": float(len(self.driver.tiers())),
                "control_decisions_ledgered": float(len(self.decisions)),
                "control_policy_clauses": float(len(self.engine.clauses)),
            }
            for tier in self.driver.tiers():
                out[f"control_replicas_{tier}"] = float(self.driver.replicas(tier))
        return out

    def ledger(self) -> List[dict]:
        with self._lock:
            return list(self.decisions)

    # --------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        return self._http.port if self._http is not None else int(self.cfg.port)

    def start(self) -> "ControlPlane":
        self._http = MetricsHTTPServer(
            int(self.cfg.port),
            sources=[self.stats],
            health_provider=self.health,
            json_routes={"/topology": self.topology},
            flight_provider=self.recorder.snapshot,
        ).start()
        self._thread = threading.Thread(target=self._run, daemon=True, name="control-loop")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._http is not None:
            self._http.stop()
            self._http = None


def build_driver(cfg: ControlConfig):
    """Driver + scrape overrides from flags. Managed tiers = those with
    a non-empty endpoint list (static) or named by a policy clause
    (k8s, endpoints derived from per-pod DNS unless a flag list pins
    them)."""
    flag_lists = {
        "broker": cfg.control.brokers,
        "server": cfg.control.servers,
        "actor": cfg.control.actors,
        "store": cfg.control.stores,
        "learner": cfg.control.learner,
    }
    lists: Dict[str, List[str]] = {}
    for tier, spec in flag_lists.items():
        if str(spec).strip():
            lists[tier] = [p.strip() for p in str(spec).split(",") if p.strip()]
    if cfg.control.driver == "static":
        return StaticDriver(lists), {}
    if cfg.control.driver == "k8s":
        tiers = {cl.tier for cl in parse_policy(cfg.control.policy)} | set(lists)
        specs = {}
        for tier in sorted(tiers):
            base = _K8S_SPECS[tier]
            specs[tier] = TierSpec(
                tier=base.tier, workload=base.workload, service=base.service,
                namespace=cfg.control.namespace, data_port=base.data_port,
                obs_port=base.obs_port, replicas=base.replicas,
            )
        return K8sDriver(specs, kubectl=cfg.control.kubectl), lists
    raise ValueError(
        f"--control.driver must be static|k8s, got {cfg.control.driver!r}"
    )


def main(argv=None):
    from dotaclient_tpu_torch.obs import ObsRuntime

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(ControlConfig(), argv)
    driver, overrides = build_driver(cfg)
    plane = ControlPlane(cfg, driver, metrics_overrides=overrides).start()
    # The controller's own obs surface is its control port (stats,
    # health, /topology all live there); a separately-set
    # --obs.metrics_port adds the standard standalone surface too.
    obs = ObsRuntime.create(cfg.obs, role="control")
    if obs is not None and cfg.obs.metrics_port not in (0, int(cfg.control.port)):
        obs.serve_metrics([plane.stats], device=None)  # no net, no torch: no profiler
    print(
        json.dumps(
            {
                "serving": True,
                "port": plane.port,
                "driver": cfg.control.driver,
                "tiers": driver.tiers(),
            }
        ),
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        plane.stop()
        if obs is not None:
            obs.close()


if __name__ == "__main__":
    main()
