"""The fleet telemetry binary (own copy of dotaclient_tpu/obs/fleetd.py):
scrape → audit → roll up → alert.

    python -m dotaclient_tpu_torch.obs.fleetd \\
        --fleet.control control-plane:13400 \\
        --fleet.alerts "fleet_unaccounted_frames,gt,0,for=3" \\
        --fleet.port 13420

One standing process (k8s/fleetd.yaml): a poll loop discovers scrape
targets from the control plane's GET /topology "metrics" map (merged with
the literal --fleet.<tier> comma-lists — the rollback position), scrapes
every surface with control/scrape.py's Prometheus-text parser, and each
window runs the conservation audit, computes the fleet SLO rollups, and
evaluates the alert clauses (obs/fleet.py). Its own HTTP surface serves:

- GET /fleet    — the full JSON rollup (targets, ledgers, alerts, SLO);
- GET /metrics  — the fleet_* registry family (a control-plane scrape
                  target, so policy clauses can read fleet meters);
- GET /healthz  — 503 while any ledger is stale or alarming;
- GET /debug/flight — fleetd's own fence/alert event ring.

Stdlib only: never loads torch, numpy or the wire stack (k8s/fleetd.yaml
caps the pod at 512Mi).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from dotaclient_tpu_torch.config import FleetConfig, parse_config
from dotaclient_tpu_torch.obs.fleet import FleetAggregator
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

_log = logging.getLogger(__name__)


def _literal_targets(cfg) -> dict:
    """--fleet.<tier> comma-lists → {tier: [host:port, ...]}. Tier names
    match the control plane's topology vocabulary so merged discovery
    never double-counts a tier under two spellings."""
    out = {}
    for tier, spec in (
        ("broker", cfg.brokers),
        ("server", cfg.servers),
        ("actor", cfg.actors),
        ("store", cfg.stores),
        ("learner", cfg.learners),
        ("league", cfg.leagues),
    ):
        eps = [p.strip() for p in str(spec).split(",") if p.strip()]
        if eps:
            out[tier] = eps
    return out


class FleetDaemon:
    """Aggregator + poll thread + HTTP surface, owned together so tests
    construct the binary's exact shape in-process."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg.fleet
        self.recorder = FlightRecorder(
            "fleetd", ring_size=cfg.obs.ring_size, dump_dir=cfg.obs.dump_dir
        )
        self.agg = FleetAggregator(
            targets=_literal_targets(self.cfg),
            control=self.cfg.control,
            poll_s=float(self.cfg.poll_s),
            window=int(self.cfg.window),
            stale_s=float(self.cfg.stale_s),
            alerts=self.cfg.alerts,  # parse errors fail boot LOUDLY
            bundle_dir=self.cfg.bundle_dir,
            recorder=self.recorder,
        )
        self._http = None
        self._thread = None
        self._stop = threading.Event()

    def _run(self) -> None:
        while not self._stop.wait(float(self.cfg.poll_s)):
            try:
                self.agg.poll_once()
            except Exception:
                # a broken poll must not kill the standing loop — the
                # next round re-scrapes from scratch
                _log.exception("fleet poll failed")

    @property
    def port(self) -> int:
        return self._http.port if self._http is not None else int(self.cfg.port)

    def start(self) -> "FleetDaemon":
        self._http = MetricsHTTPServer(
            int(self.cfg.port),
            sources=[self.agg.scalars],
            health_provider=self.agg.health,
            json_routes={"/fleet": self.agg.fleet},
            flight_provider=self.recorder.snapshot,
        ).start()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleetd-loop"
        )
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


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(FleetConfig(), argv)
    daemon = FleetDaemon(cfg)
    if cfg.obs.install_handlers:
        daemon.recorder.install_handlers()
    daemon.start()
    print(
        json.dumps(
            {
                "serving": True,
                "port": daemon.port,
                "control": cfg.fleet.control,
                "targets": sorted(
                    f"{t}/{e}"
                    for t, eps in _literal_targets(cfg.fleet).items()
                    for e in eps
                ),
                "alerts": len(daemon.agg.alert_engine.rules),
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
        daemon.stop()


if __name__ == "__main__":
    main()
