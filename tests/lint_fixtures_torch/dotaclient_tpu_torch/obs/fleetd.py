"""Fixture fleetd binary for the SVC rules. Serves /fleet (plus the
implicit /metrics + /healthz); dials the control fixture's /topology
once correctly and once against a drifted route (SVC001 bad side); its
rollup exports fleet_fixture_ok, the meter the fleetd-fixture manifest
alert keys on (SVC002 good side). Never imported — AST only."""

from urllib.request import urlopen

from dotaclient_tpu_torch.obs.http import MetricsHTTPServer  # fixture-only

ROLLUP = {"fleet_fixture_ok": 1.0}


class FleetLoop:
    def __init__(self, cfg):
        self._control_endpoint = "127.0.0.1:13400"
        self._snapshot = {"alerts": cfg.fleet.alerts}
        self.srv = MetricsHTTPServer(
            cfg.fleet.port,
            json_routes={"/fleet": lambda: self._snapshot},
        )

    def poll(self):
        # good edge: control.server really serves /topology
        urlopen(f"http://{self._control_endpoint}/topology")
        # SVC001: drifted route — control.server serves no /topologyy
        urlopen(f"http://{self._control_endpoint}/topologyy")
